"""The port's tick-phase profiler (``PagedEngine(tick_profile=True)``)
against the JAX package's, on the port's ``TickStubModel`` carrying the
JAX stub's weights (as numpy), on the CPU.

Mirrors ``tests/test_tick_profile.py``:

- phase sum == wall: under an injected clock the five phases (host,
  h2d, dispatch, device, drain) sum exactly to the tick wall (the host
  is the residual), per tick and in total;
- profile on / off: streams bit for bit (tokens and logprobs) in the
  default mode (fused tick, ring), sync readback, the host tick and K=4
  scan ticks;
- the steady tick with the profiler on stays one dispatch and no upload;
- the ring is bounded and its tick counters increase;
- ``obs.reset()`` flushes the ring into the run dir through the flusher
  the engine registered, once;
- tick trace events carry the completed tick's phase split.

Against the JAX engine: the same script through both packages' engines
with ``tick_profile=True`` gives the same per-tick ``dispatches``,
``uploads``, ``bytes``, ``patches`` and ``active`` fields and the same
greedy tokens (logprobs within 1e-4); each package's
``validate_tickphase_doc`` accepts both documents."""
import glob
import json
import os

import numpy as np
import pytest

from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.generation.stub import TickStubModel as JaxStub
from paddle_tpu.utils import observability as jax_obs
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.generation.stub import TickStubModel
from paddle_tpu_torch.utils import observability as obs

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
BASE = dict(max_slots=4, num_blocks=32, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16,))
RECORD_FIELDS = ("dispatches", "uploads", "bytes", "patches", "active")


def jax_stub_weights():
    """The JAX stub's (emb, out), as numpy."""
    _, params = JaxStub().functional()
    return np.asarray(params["emb"]), np.asarray(params["out"])


@pytest.fixture(scope="module")
def weights():
    return jax_stub_weights()


def _cyc(n, start=0):
    return (np.arange(n) % 5 + 1 + start)[None]


def _engine(weights, **kw):
    return PagedEngine(TickStubModel(*weights), **dict(BASE, **kw))


# greedy, sampled, stop-sequence and eos rows
SUBS = [
    ("g", _cyc(6), dict(max_new_tokens=12)),
    ("s", _cyc(8, 2), dict(max_new_tokens=10, temperature=0.8,
                           top_k=20, seed=5)),
    ("st", _cyc(9, 1), dict(max_new_tokens=14, stop_sequences=[[3, 4]])),
    ("e", _cyc(5, 3), dict(max_new_tokens=10, eos_token_id=2)),
]


def _drain(eng):
    for rid, ids, kw in SUBS:
        eng.submit(rid, ids, **kw)
    res = eng.run()
    return res, dict(eng.logprobs)


class FakeClock:
    """+1 ms a call: each bracketed phase costs exactly the clock reads
    its code path makes, so the phase math is pinned to exact floats."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def test_phase_sum_equals_wall_injected_clock(weights):
    eng = _engine(weights, tick_profile=True, profile_clock=FakeClock())
    _drain(eng)
    prof = eng._prof
    assert prof.ticks > 0
    assert sum(prof.totals.values()) == pytest.approx(
        prof.wall_total_ms, rel=1e-9)
    for p in ("h2d", "dispatch", "device", "drain"):
        assert prof.totals[p] > 0.0, p
    doc = eng.tick_profile_doc()
    assert obs.validate_tickphase_doc(doc) == []
    for rec in doc["entries"]:
        assert sum(rec[f"{p}_ms"] for p in obs.TICK_PHASES) \
            == pytest.approx(rec["wall_ms"], rel=1e-9)
    assert eng.tick_phase_totals == prof.totals
    assert eng.tick_wall_ms_total == prof.wall_total_ms


def test_real_clock_doc_and_snapshot(weights):
    eng = _engine(weights, tick_profile=True)
    _drain(eng)
    doc = eng.tick_profile_doc()
    assert doc["ticks"] > 0
    assert obs.validate_tickphase_doc(doc) == []
    snap = eng.debug_snapshot()["tick_profile"]
    assert snap["enabled"] and snap["ticks"] == doc["ticks"]
    off = _engine(weights)
    assert off.debug_snapshot()["tick_profile"] == {"enabled": False}
    assert off.tick_profile_doc() is None
    assert off.tick_phase_totals is None and off.tick_wall_ms_total == 0.0


@pytest.mark.parametrize("mode_kw", [
    {}, {"ring_mode": False}, {"fused_tick": False},
    {"ticks_per_dispatch": 4},
], ids=["fused-ring", "sync", "unfused", "multi-tick"])
def test_profile_on_off_bitwise(weights, mode_kw):
    res_off, lp_off = _drain(_engine(weights, **mode_kw))
    res_on, lp_on = _drain(_engine(weights, tick_profile=True, **mode_kw))
    assert res_on == res_off
    assert lp_on == lp_off


def test_steady_tick_contract_with_profiler_on(weights):
    eng = _engine(weights, block_size=64, max_blocks_per_seq=2,
                  tick_profile=True)
    for i in range(4):
        eng.submit(f"r{i}", _cyc(6), max_new_tokens=100)
    for _ in range(6):
        eng.step()
    d0, u0, b0 = eng.dispatch_count, eng.h2d_uploads, eng.h2d_upload_bytes
    t0 = eng._prof.ticks
    for _ in range(20):
        eng.step()
    assert eng.dispatch_count - d0 == 20
    assert eng.h2d_uploads - u0 == 0
    assert eng.h2d_upload_bytes - b0 == 0
    assert eng._prof.ticks - t0 == 20
    steady = list(eng._prof.ring)[-20:]
    assert all(r["dispatches"] == 1 and r["uploads"] == 0
               and r["bytes"] == 0 for r in steady)


def test_ring_bounded_and_monotonic(weights):
    eng = _engine(weights, tick_profile=True, profile_ring_len=4)
    _drain(eng)
    doc = eng.tick_profile_doc()
    assert eng._prof.ticks > 4
    assert len(doc["entries"]) == 4 and doc["capacity"] == 4
    assert obs.validate_tickphase_doc(doc) == []
    ticks = [r["tick"] for r in doc["entries"]]
    assert ticks == sorted(ticks) and len(set(ticks)) == 4
    assert doc["wall_total_ms"] >= sum(
        r["wall_ms"] for r in doc["entries"]) - 1e-6


def test_reset_flushes_tickphase_ring(weights, tmp_path):
    obs.reset()                     # drop flushers stale engines left
    obs.configure(str(tmp_path))
    try:
        eng = _engine(weights, tick_profile=True,
                      profile_clock=FakeClock())
        _drain(eng)
        assert glob.glob(str(tmp_path / "tickphase_*.json")) == []
    finally:
        obs.reset()                 # the flush under test
    files = glob.glob(str(tmp_path / "tickphase_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    assert obs.validate_tickphase_doc(doc) == []
    assert doc["ticks"] == eng._prof.ticks > 0
    os.remove(files[0])
    obs.reset()                     # the flusher was cleared
    assert glob.glob(str(tmp_path / "tickphase_*.json")) == []


def test_trace_events_carry_phase(weights):
    eng = _engine(weights, tick_profile=True)
    events = []
    eng.trace_sink = lambda rid, kind, **f: events.append((rid, kind, f))
    eng.submit("a", _cyc(6), max_new_tokens=8)
    eng.run()
    ticks = [f for rid, kind, f in events if rid == "a" and kind == "tick"]
    with_phase = [f["phase"] for f in ticks if "phase" in f]
    assert with_phase
    for ph in with_phase:
        assert set(ph) == {"wall_ms"} | {f"{p}_ms" for p in obs.TICK_PHASES}
    eng2 = _engine(weights)
    ev2 = []
    eng2.trace_sink = lambda rid, kind, **f: ev2.append((kind, f))
    eng2.submit("a", _cyc(6), max_new_tokens=8)
    eng2.run()
    assert all("phase" not in f for k, f in ev2 if k == "tick")


@pytest.mark.parametrize("mode_kw", [
    {}, {"ring_mode": False}, {"fused_tick": False},
], ids=["fused-ring", "sync", "unfused"])
def test_per_tick_records_equal_the_jax_engines(weights, mode_kw):
    """The same script (greedy rows only, so every transition lands on
    the same tick in both packages) with the profiler on: per-tick
    dispatches, uploads, bytes, patches and active slots equal, tokens
    identical, logprobs within ATOL_LP, and each package's validator
    accepts both documents."""
    greedy = [s for s in SUBS if "temperature" not in s[2]]
    je = JaxEngine(JaxStub(), tick_profile=True, **dict(BASE, **mode_kw))
    te = _engine(weights, tick_profile=True, **mode_kw)
    for eng in (je, te):
        for rid, ids, kw in greedy:
            eng.submit(rid, ids, **kw)
    ref, got = je.run(), te.run()
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0)
    jd, td = je.tick_profile_doc(), te.tick_profile_doc()
    assert td["ticks"] == jd["ticks"] > 0
    assert [{k: r[k] for k in RECORD_FIELDS} for r in td["entries"]] == \
        [{k: r[k] for k in RECORD_FIELDS} for r in jd["entries"]]
    for doc in (jd, td):
        assert obs.validate_tickphase_doc(doc) == []
        assert jax_obs.validate_tickphase_doc(doc) == []
