"""The port's device-resident ``PagedEngine`` tick (its default) against
the JAX package's default engine, on the same weights (llama_tiny, fp32,
CPU), and against its own host tick (``fused_tick=False``).

- Against the JAX default engine, on scripts mirrored from the
  non-speculative cases of ``tests/test_fused_tick.py`` and
  ``tests/test_ring_spec.py``: greedy tokens identical, logprobs within
  1e-4, and the engine counters equal (dispatches, uploads and their
  bytes, rebuilds, patches, ring drains; ``ring_blocking_drains``
  depends on timing and is left out).
- Inside the port, bitwise, sampled rows included: the fused tick
  against the host tick, ring on against off, K=4 scan ticks against
  K=1.
- Contracts: a steady tick is one dispatch and no upload; the scan
  amortizes dispatches; ring drains, the blocking readbacks of the sync
  mode and the drain lag; the JAX package's ``ValueError``s.

On the CPU a dispatch is one eager call of the tick program; on a card
it is one CUDA-graph replay (``tests/test_torch_fused_tick_gpu.py``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import sampling as jax_sampling
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import sampling
from paddle_tpu_torch.generation.paged import PagedEngine

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
BASE = dict(max_slots=4, num_blocks=32, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16, 32))
# the engine counters both packages keep, compared as equal
COUNTERS = ("dispatch_count", "h2d_uploads", "h2d_upload_bytes",
            "full_rebuilds", "delta_patches", "patches_fused",
            "patch_queue_overflows", "ring_drains", "ring_scoped_drains")
STATS = ("decode_steps", "prefills", "preemptions", "prefill_chunks",
         "prefix_hit_tokens", "prefix_adopted_blocks", "active_slot_steps")


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_pair():
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def ids(rs, n):
    return rs.randint(1, 200, (1, n))


def drive(eng, script):
    """Run a script of ("submit", rid, ids, kw), ("step", n) and
    ("cancel", rid) actions, then drain; returns the results."""
    for act in script:
        if act[0] == "submit":
            eng.submit(act[1], act[2], **act[3])
        elif act[0] == "step":
            for _ in range(act[1]):
                eng.step()
        elif act[0] == "cancel":
            assert eng.cancel(act[1])
    return eng.run()


def against_jax(pair, script, **kw):
    """``script`` on the JAX default engine and the port's: identical
    tokens, logprobs within ATOL_LP, equal counters. Returns the port
    engine."""
    jm, tm = pair
    je = JaxEngine(jm, **dict(BASE, **kw))
    te = PagedEngine(tm, **dict(BASE, **kw))
    ref = drive(je, script)
    got = drive(te, script)
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0, err_msg=str(rid))
    assert {c: getattr(te, c) for c in COUNTERS} == \
        {c: getattr(je, c) for c in COUNTERS}
    for k in STATS:
        assert te.stats[k] == je.stats[k], k
    assert te.cancelled == je.cancelled
    return te


def bitwise(tm, script, ref_kw, **kw):
    """``script`` on two port engines: tokens and logprobs bit for bit.
    Returns both engines."""
    a = PagedEngine(tm, **dict(BASE, **ref_kw))
    b = PagedEngine(tm, **dict(BASE, **kw))
    ra, rb = drive(a, script), drive(b, script)
    assert ra == rb
    assert a.logprobs == b.logprobs
    return a, b


def greedy_script(seed=11):
    """Mixed-length greedy batch with stop sequences, an eos request and
    a repetition penalty (``test_fused_tick``'s stops-and-eos case)."""
    rs = np.random.RandomState(seed)
    return [("submit", "a", ids(rs, 5), dict(max_new_tokens=20)),
            ("submit", "b", ids(rs, 17), dict(max_new_tokens=12)),
            ("submit", "c", ids(rs, 9),
             dict(max_new_tokens=24, stop_sequences=[[7], [3, 5]])),
            ("submit", "d", ids(rs, 3),
             dict(max_new_tokens=16, eos_token_id=2,
                  repetition_penalty=1.3))]


def mixed_script(seed=12):
    """Greedy and seeded sampled rows in one batch (port-only pins:
    sampled streams are the port's own, not JAX's threefry)."""
    rs = np.random.RandomState(seed)
    return [("submit", "g", ids(rs, 6), dict(max_new_tokens=14)),
            ("submit", "s1", ids(rs, 8),
             dict(max_new_tokens=14, temperature=0.9, top_k=20, seed=5)),
            ("step", 3),
            ("submit", "s2", ids(rs, 12),
             dict(max_new_tokens=10, temperature=0.7, top_p=0.9, seed=9,
                  repetition_penalty=1.2)),
            ("submit", "st", ids(rs, 7),
             dict(max_new_tokens=18, stop_sequences=[[3, 4]],
                  temperature=1.1, seed=4))]


def midstream_script(seed=13):
    rs = np.random.RandomState(seed)
    return [("submit", "r0", ids(rs, 6), dict(max_new_tokens=18)),
            ("step", 5),
            ("submit", "r1", ids(rs, 10), dict(max_new_tokens=12))]


def scan_script(seed=14):
    rs = np.random.RandomState(seed)
    return [("submit", "a", ids(rs, 4), dict(max_new_tokens=25)),
            ("submit", "b", ids(rs, 9),
             dict(max_new_tokens=21, stop_sequences=[[9]])),
            ("submit", "c", ids(rs, 14), dict(max_new_tokens=17))]


# ------------------------------------------------ against the JAX engine
@pytest.mark.parametrize("script,kw", [
    (greedy_script, {}),
    (greedy_script, dict(ring_mode=False)),
    (greedy_script, dict(ring_len=4)),
    (midstream_script, {}),
    (scan_script, dict(ticks_per_dispatch=4)),
], ids=["stops_eos", "ring_off", "ring_wrap", "midstream", "scan4"])
def test_default_engine_matches_jax(pair, script, kw):
    te = against_jax(pair, script(), **kw)
    assert te.full_rebuilds == 1 and te.delta_patches == 0


def test_scan_amortizes_like_jax(pair):
    """K=4 with a stop row (scan-eligible since the JAX package widened
    it): fewer dispatches than tokens, the same count as JAX."""
    rs = np.random.RandomState(15)
    te = against_jax(pair, [("submit", "x", ids(rs, 7),
                             dict(max_new_tokens=20,
                                  stop_sequences=[[9]]))],
                     ticks_per_dispatch=4)
    assert te.dispatch_count < len(te.results["x"]) + 2


def test_serve_stream_at_defaults_matches_jax(pair):
    jm, tm = pair
    rs = np.random.RandomState(7)
    reqs = {f"q{i}": ids(rs, 6 + i) for i in range(3)}
    kw = dict(max_slots=2, num_blocks=16, block_size=8,
              max_blocks_per_seq=4, prefill_buckets=(16,))
    ref = JaxPredictor(jm).serve_stream(reqs, max_new_tokens=8, **kw)
    tp = ptt.Predictor(tm, device="cpu")
    assert tp.serve_stream(reqs, max_new_tokens=8, **kw) == ref
    eng = next(iter(tp._paged_engines.values()))
    assert eng._fused and eng._ring and eng._delta and eng._fuse_patches


def test_override_key_rows_matches_jax():
    import jax.numpy as jnp
    rs = np.random.RandomState(2)
    keys = rs.randint(0, 2 ** 32, (6, 2), dtype=np.uint64)
    rows = np.array([4, 1, 6, 2, 0], np.int32)       # 6: out of range
    new = rs.randint(0, 2 ** 32, (5, 2), dtype=np.uint64)
    for flags in ([1, 0, 1, 1, 0], [0] * 5, [1] * 5):
        ref = np.asarray(jax_sampling.override_key_rows(
            jnp.asarray(keys.astype(np.uint32)), jnp.asarray(rows),
            jnp.asarray(new.astype(np.uint32)),
            jnp.asarray(np.array(flags, np.int32))))
        got = sampling.override_key_rows(
            torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(rows),
            torch.from_numpy(new.astype(np.int64)),
            torch.tensor(flags))
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


# ------------------------------------------------------ port, bitwise
@pytest.mark.parametrize("kw", [
    {}, dict(ring_mode=False), dict(ticks_per_dispatch=4),
    dict(ring_len=4, ticks_per_dispatch=2)],
    ids=["default", "ring_off", "scan4", "ring4_scan2"])
def test_fused_tick_bitwise_host_tick(pair, kw):
    """Sampled rows included: the fused tick advances keys, seen masks
    and lengths exactly as the host tick does."""
    bitwise(pair[1], mixed_script(), dict(fused_tick=False), **kw)


def test_ring_on_off_and_scan_bitwise(pair):
    tm = pair[1]
    bitwise(tm, mixed_script(21), dict(ring_mode=False))
    _, scan = bitwise(tm, scan_script(22), {}, ticks_per_dispatch=4)
    assert scan.stats["decode_steps"] > scan.dispatch_count


def test_midstream_submit_emission_order(pair):
    """The sync fused tick keeps the host tick's cross-request emission
    interleave; ring mode drains one step later, so only each request's
    own order is pinned there."""
    tm = pair[1]
    rs = np.random.RandomState(13)
    first, late = ids(rs, 6), ids(rs, 10)

    def run(**kw):
        eng = PagedEngine(tm, **dict(BASE, **kw))
        eng.submit("r0", first, max_new_tokens=18)
        out = []
        for n, pair_ in enumerate(eng.stream()):
            out.append(pair_)
            if n == 4:
                eng.submit("r1", late, max_new_tokens=12, temperature=0.8,
                           seed=3)
        return out, dict(eng.results), dict(eng.logprobs)

    sh, rh, lh = run(fused_tick=False)
    sf, rf, lf = run(ring_mode=False)
    assert sh == sf and rh == rf and lh == lf
    sr, rr, lr = run()
    assert rh == rr and lh == lr
    for rid in rh:
        assert [t for r, t in sr if r == rid] == \
            [t for r, t in sh if r == rid]


# ------------------------------------------------------------ contracts
def _steady(tm, **kw):
    """Four long requests in a 64-token block (no growth): six warm-up
    steps, then 20 steady ones. Returns the engine and the 20 steps'
    (dispatches, uploads, bytes, blocking readbacks)."""
    eng = PagedEngine(tm, **dict(BASE, block_size=64, max_blocks_per_seq=2,
                                 **kw))
    rs = np.random.RandomState(3)
    for i in range(4):
        eng.submit(f"r{i}", ids(rs, 6), max_new_tokens=100)
    for _ in range(6):
        eng.step()
    c0 = (eng.dispatch_count, eng.h2d_uploads, eng.h2d_upload_bytes,
          eng.d2h_syncs)
    for _ in range(20):
        eng.step()
    return eng, tuple(b - a for a, b in zip(c0, (
        eng.dispatch_count, eng.h2d_uploads, eng.h2d_upload_bytes,
        eng.d2h_syncs)))


def test_steady_tick_one_dispatch_zero_uploads(pair):
    tm = pair[1]
    ring, (d, u, b, s) = _steady(tm)
    assert (d, u, b, s) == (20, 0, 0, 0)
    assert ring.ring_drains >= 20
    sync, (d, u, b, s) = _steady(tm, ring_mode=False)
    assert (d, u, b, s) == (20, 0, 0, 20)     # one blocking read a tick
    host, (d, u, b, s) = _steady(tm, fused_tick=False)
    assert d == 20 and u >= 5 * 20 and b > 0   # every mirror, every tick


def test_scan_amortizes_dispatches(pair):
    """K=4: one dispatch advances all four rows four tokens, and ring
    mode drains once per dispatch."""
    eng = PagedEngine(pair[1], **dict(BASE, ticks_per_dispatch=4))
    rs = np.random.RandomState(4)
    for i in range(4):
        eng.submit(f"r{i}", ids(rs, 6), max_new_tokens=40)
    for _ in range(3):
        eng.step()
    d0, t0 = eng.dispatch_count, eng.stats["decode_steps"]
    r0 = eng.ring_drains
    tok0 = sum(len(s.tokens) for s in eng.slots if s is not None)
    for _ in range(5):
        eng.step()
    toks = sum(len(s.tokens) for s in eng.slots if s is not None) - tok0
    assert eng.dispatch_count - d0 == 5
    assert eng.stats["decode_steps"] - t0 == 20
    assert eng.ring_drains - r0 == 5
    assert toks == 5 * 4 * 4


def test_ring_drain_lag_and_sync_readbacks(pair):
    tm = pair[1]
    events = []
    eng = PagedEngine(tm, **BASE)
    eng.trace_sink = lambda rid, kind, **f: events.append((kind, f))
    rs = np.random.RandomState(5)
    eng.submit("t", ids(rs, 6), max_new_tokens=10)
    eng.run()
    ticks = [f for kind, f in events if kind == "tick"]
    assert ticks and all(f.get("ring_lag") == 1 for f in ticks)
    assert eng.d2h_syncs == 0 and eng.ring_blocking_drains == 0
    sync = PagedEngine(tm, **dict(BASE, ring_mode=False))
    sync.submit("t", ids(rs, 6), max_new_tokens=16)
    sync.run()
    assert sync.ring_drains == 0
    assert sync.d2h_syncs == sync.stats["decode_steps"]


def test_stop_completes_from_drained_token(pair):
    """The stop lands through the drain, one step after the device
    committed it; tokens the device kept committing die with the slot."""
    tm = pair[1]
    rs = np.random.RandomState(6)
    p = ids(rs, 7)
    free = PagedEngine(tm, **BASE)
    free.submit("f", p, max_new_tokens=20)
    full = free.run()["f"]
    stop = [full[4], full[5]]
    script = [("submit", "s", p, dict(max_new_tokens=20,
                                      stop_sequences=[stop]))]
    _, ring = bitwise(tm, script, dict(ring_mode=False))
    got = ring.results["s"]
    assert got == full[:len(got)] and len(got) <= 4


def test_mode_combinations_raise_jax_value_errors(pair):
    tm = pair[1]
    for kw in (dict(fused_tick=False, ring_mode=True),
               dict(fused_tick=False, delta_transitions=True),
               dict(delta_transitions=False, patch_fuse=True)):
        with pytest.raises(ValueError):
            JaxEngine(pair[0], **dict(BASE, **kw))
        with pytest.raises(ValueError, match="requires"):
            PagedEngine(tm, **dict(BASE, **kw))
    assert PagedEngine(tm, **dict(BASE, ring_len=3))._ring_len == 3
    eng = PagedEngine(tm, **dict(BASE, ticks_per_dispatch=12, ring_len=4))
    assert eng._ring_len == 24                     # 2 x K at least


def test_hard_reset_then_serves_again(pair):
    """hard_reset mid-stream drops everything (an outstanding dispatch
    included); the engine then serves bitwise as a fresh one."""
    tm = pair[1]
    script = mixed_script(31)
    eng = PagedEngine(tm, **BASE)
    for act in script[:2]:
        eng.submit(act[1], act[2], **act[3])
    for _ in range(4):
        eng.step()
    assert eng._pending is not None
    eng.hard_reset()
    assert eng._pending is None and not eng._dev_live
    got = drive(eng, script)
    fresh = PagedEngine(tm, **BASE)
    assert got == drive(fresh, script)
    assert eng.logprobs == fresh.logprobs
    assert eng.full_rebuilds == 2 and eng.health()["active_slots"] == 0
