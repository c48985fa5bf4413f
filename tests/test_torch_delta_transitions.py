"""The port's slot transitions on the device-resident tick, against the
JAX package's default engine (llama_tiny, fp32, CPU, the same weights)
and between the port's own three transition modes, mirroring the
non-speculative cases of ``tests/test_delta_transitions.py``:

- REBUILD (``delta_transitions=False``): the whole device state rebuilt
  on every transition;
- DELTA (``patch_fuse=False``): one descriptor a transition, each its
  own eager patch and dispatch;
- FUSED (the default): descriptors staged into the device queue by one
  upload and applied by the next tick's program.

Against JAX: greedy tokens identical, logprobs within 1e-4, counters
equal, through admit, finish, growth, chunked prefill and the prefix
cache, preemption and cancel. Inside the port the three modes are held
bit for bit, sampled rows included, ring on and off. Contracts: churn
costs one dispatch a tick and no rebuild, the queue overflows into
standalone patches, a warm chunked admit dispatches nothing, the
scoped drain of a cancel or an expiry leaves the siblings' tokens
pending, the ring-cursor guard rebuilds once, and an exported request
resumes bitwise."""
import numpy as np
import pytest

from test_torch_fused_tick import (BASE, against_jax, bitwise, drive,
                                   make_pair)

from paddle_tpu_torch.generation.paged import PagedEngine

MODES = {"rebuild": dict(delta_transitions=False),
         "delta": dict(patch_fuse=False), "fused": {}}


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    import torch
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def cyc(n, start=0):
    return (np.arange(n) % 5 + 1 + start)[None]


def churn_script(sampled=False):
    """Admit, finish, block growth (prompts and budgets cross the 8-token
    block grid), stop and eos, then a second wave into released slots."""
    samp = dict(temperature=0.8, top_k=20, seed=5) if sampled else {}
    samp2 = dict(temperature=0.6, seed=9) if sampled else {}
    return [("submit", "g", cyc(6), dict(max_new_tokens=20)),
            ("submit", "s", cyc(8, 2), dict(max_new_tokens=14, **samp)),
            ("submit", "st", cyc(9, 1),
             dict(max_new_tokens=24, stop_sequences=[[3, 4]])),
            ("submit", "e", cyc(5, 3), dict(max_new_tokens=16,
                                            eos_token_id=2)),
            ("step", 30),
            ("submit", "w1", cyc(4, 1), dict(max_new_tokens=9)),
            ("submit", "w2", cyc(7, 2), dict(max_new_tokens=11, **samp2))]


def prefix_script(sampled=False):
    sys_p = list(range(1, 17))
    return [("submit", "x", np.asarray(sys_p + [20, 21])[None],
             dict(max_new_tokens=10)),
            ("step", 40),
            ("submit", "y", np.asarray(sys_p + [30])[None],
             dict(max_new_tokens=8, **(dict(temperature=0.5, seed=7)
                                       if sampled else {})))]


PREFIX = dict(max_slots=2, chunk_prefill_tokens=8, enable_prefix_cache=True,
              prefill_buckets=(8,))
PREEMPT = dict(max_slots=2, num_blocks=6, block_size=8, max_blocks_per_seq=4,
               prefill_buckets=(16,))


def preempt_script(sampled=False):
    return [("submit", "p", cyc(8), dict(max_new_tokens=14)),
            ("submit", "q", cyc(11, 2), dict(
                max_new_tokens=14,
                **(dict(temperature=0.9, seed=5) if sampled else {})))]


def cancel_script():
    return [("submit", "keep", cyc(6), dict(max_new_tokens=20)),
            ("submit", "kill", cyc(9, 3), dict(max_new_tokens=20)),
            ("step", 4), ("cancel", "kill")]


# ------------------------------------------------ against the JAX engine
@pytest.mark.parametrize("script,kw", [
    (churn_script, {}),
    (churn_script, dict(ring_mode=False)),
    (churn_script, dict(delta_transitions=False)),
    (churn_script, dict(patch_fuse=False)),
    (churn_script, dict(patch_queue_len=1)),
    (prefix_script, PREFIX),
    (preempt_script, PREEMPT),
    (cancel_script, {}),
], ids=["fused", "ring_off", "rebuild", "delta", "queue1", "prefix",
        "preempt", "cancel"])
def test_transitions_match_jax(pair, script, kw):
    te = against_jax(pair, script(), **kw)
    if kw is PREFIX:
        assert te.stats["prefix_hit_tokens"] > 0
    if kw is PREEMPT:
        assert te.stats["preemptions"] > 0
    if script is cancel_script:
        assert te.ring_scoped_drains == 1


# ------------------------------------------------------ port, bitwise
@pytest.mark.parametrize("ring", [True, False])
def test_transition_modes_bitwise(pair, ring):
    """Sampled rows included: fused, delta and rebuild agree on every
    token and logprob through churn and a second wave."""
    tm = pair[1]
    script = churn_script(sampled=True)
    er, ed = bitwise(tm, script, dict(ring_mode=ring, **MODES["rebuild"]),
                     ring_mode=ring, **MODES["delta"])
    _, ef = bitwise(tm, script, dict(ring_mode=ring, **MODES["rebuild"]),
                    ring_mode=ring)
    assert er.full_rebuilds > 1
    assert ed.full_rebuilds == 1 and ed.delta_patches > 0
    assert ef.full_rebuilds == 1 and ef.delta_patches == 0
    assert ef.patches_fused > 0 and ef.patch_queue_overflows == 0


@pytest.mark.parametrize("name", ["prefix", "preempt"])
def test_prefix_and_preemption_modes_bitwise(pair, name):
    """Chunk advances and prefix adoption ride patches; a preempted
    sampled victim resumes from its device key."""
    tm = pair[1]
    script, kw = ((prefix_script(True), PREFIX) if name == "prefix"
                  else (preempt_script(True), PREEMPT))
    er, ef = bitwise(tm, script, dict(kw, **MODES["rebuild"]), **kw)
    bitwise(tm, script, dict(kw, fused_tick=False), **kw)
    assert ef.full_rebuilds == 1
    if name == "preempt":
        assert er.stats["preemptions"] == ef.stats["preemptions"] > 0


# ------------------------------------------------------------ contracts
def test_cancel_scoped_drain_keeps_sibling_pending(pair):
    tm = pair[1]
    eng = PagedEngine(tm, **BASE)
    eng.submit("keep", cyc(6), max_new_tokens=20)
    eng.submit("kill", cyc(9, 3), max_new_tokens=20)
    for _ in range(4):
        eng.step()
    assert eng._pending is not None
    keep = next(s for s in eng.slots if s and s.request_id == "keep")
    n_keep = len(keep.tokens)
    assert eng.cancel("kill")
    assert eng._pending is not None          # the sibling's entries wait
    assert len(keep.tokens) == n_keep and eng.ring_scoped_drains == 1
    res = eng.run()
    ref = PagedEngine(tm, **dict(BASE, fused_tick=False))
    ref.submit("keep", cyc(6), max_new_tokens=20)
    assert res["keep"] == ref.run()["keep"]
    assert eng.cancelled == {"kill": "cancelled"}
    assert len(eng.free_blocks) == eng.P - 1


def test_expire_scopes_to_deadline_slot(pair):
    """A running deadline expiry on the submit path (the bounded-queue
    reap) drains only the expiring row."""
    tm = pair[1]
    eng = PagedEngine(tm, **dict(BASE, max_queue=8))
    eng.submit("keep", cyc(6), max_new_tokens=16)
    eng.submit("doomed", cyc(7, 2), max_new_tokens=50)
    for _ in range(4):
        eng.step()
    assert eng._pending is not None
    doomed = next(s for s in eng.slots if s and s.request_id == "doomed")
    doomed.deadline = 0.0
    eng.submit("late", cyc(4), max_new_tokens=4)
    assert eng.cancelled.get("doomed") == "timeout"
    assert eng.ring_scoped_drains == 1 and eng._pending is not None
    res = eng.run()
    ref = PagedEngine(tm, **dict(BASE, fused_tick=False))
    ref.submit("keep", cyc(6), max_new_tokens=16)
    assert res["keep"] == ref.run()["keep"]


def _churn(tm, mode):
    eng = PagedEngine(tm, **dict(BASE, **MODES[mode]))
    eng.submit("w", cyc(4), max_new_tokens=2)
    eng.run()
    fr0, dp0, b0 = eng.full_rebuilds, eng.delta_patches, eng.h2d_upload_bytes
    for i in range(12):
        eng.submit(i, cyc(4 + i % 3), max_new_tokens=4)
    eng.run()
    return (eng, eng.full_rebuilds - fr0, eng.delta_patches - dp0,
            eng.h2d_upload_bytes - b0)


def test_churn_zero_rebuilds_and_bytes(pair):
    tm = pair[1]
    _, fr_d, dp_d, bytes_d = _churn(tm, "delta")
    _, fr_r, dp_r, bytes_r = _churn(tm, "rebuild")
    ef, fr_f, dp_f, _ = _churn(tm, "fused")
    assert fr_d == 0 and dp_d > 0
    assert fr_r >= 6 and dp_r == 0
    assert fr_f == 0 and dp_f == 0 and ef.patches_fused > 0
    assert 0 < bytes_d < bytes_r


def test_steady_churn_one_dispatch_per_tick(pair):
    eng = PagedEngine(pair[1], **BASE)
    for i in range(4):
        eng.submit(f"r{i}", cyc(6), max_new_tokens=5 + i)
    eng.step()
    assert eng.full_rebuilds == 1
    d0, t0 = eng.dispatch_count, eng.stats["decode_steps"]
    eng.run()
    ticks = eng.stats["decode_steps"] - t0
    assert ticks > 0 and eng.dispatch_count - d0 == ticks
    assert eng.delta_patches == 0 and eng.full_rebuilds == 1
    assert eng.patches_fused >= 3 and eng.patch_queue_overflows == 0


def test_synchronized_wave_single_dispatch(pair):
    """Eight rows finishing on one tick: the release wave and the next
    admit ride one staged upload; the follow-up request costs its
    prefill and its ticks."""
    eng = PagedEngine(pair[1], **dict(BASE, max_slots=8, num_blocks=64))
    for i in range(8):
        eng.submit(f"w{i}", cyc(6), max_new_tokens=4)
    eng.run()
    d0, t0 = eng.dispatch_count, eng.stats["decode_steps"]
    pf0 = eng.patches_fused
    eng.submit("s", cyc(5, 1), max_new_tokens=3)
    eng.run()
    assert eng.dispatch_count - d0 == eng.stats["decode_steps"] - t0 + 1
    assert eng.delta_patches == 0 and eng.full_rebuilds == 1
    assert eng.patches_fused - pf0 >= 8
    assert eng.patch_queue_overflows == 0


def test_queue_overflow_takes_standalone_patches(pair):
    tm = pair[1]
    script = [("submit", f"r{i}", cyc(6), dict(max_new_tokens=3))
              for i in range(4)] + [
        ("step", 12), ("submit", "t", cyc(5, 1),
                       dict(max_new_tokens=4, temperature=0.7, seed=2))]
    ef, eo = bitwise(tm, script, {}, patch_queue_len=1)
    assert ef.patch_queue_overflows == 0 and ef.delta_patches == 0
    assert eo.patch_queue_overflows >= 1 and eo.delta_patches > 0
    assert eo.full_rebuilds == 1


def test_warm_admit_is_dispatch_free(pair):
    tm = pair[1]
    kw = dict(chunk_prefill_tokens=8, prefill_buckets=(8,))
    eng = PagedEngine(tm, **dict(BASE, **kw))
    eng.submit("w", cyc(4), max_new_tokens=2)
    eng.run()
    d0, u0 = eng.dispatch_count, eng.h2d_uploads
    eng.submit("a", cyc(6), max_new_tokens=4)
    assert (eng.dispatch_count, eng.h2d_uploads) == (d0, u0)
    assert not eng.queue and any(s and s.request_id == "a"
                                 for s in eng.slots)
    ref = PagedEngine(tm, **dict(BASE, patch_fuse=False, **kw))
    ref.submit("w", cyc(4), max_new_tokens=2)
    ref.run()
    ref.submit("a", cyc(6), max_new_tokens=4)
    assert eng.run()["a"] == ref.run()["a"]


def test_ring_cursor_guard_rebuilds_once(pair):
    """Cursors past 2^30 (host and device moved together) force one
    counted rebuild at the next transition, which zeroes them; the
    streams stay bitwise."""
    tm = pair[1]
    script = churn_script(sampled=True)
    eng = PagedEngine(tm, **BASE)
    for act in script[:4]:
        eng.submit(act[1], act[2], **act[3])
    for _ in range(3):
        eng.step()
    eng._drain_pending()
    eng._drained += 2 ** 30
    eng._st["wcur"] += 2 ** 30
    got = drive(eng, script[4:])
    ref = PagedEngine(tm, **dict(BASE, fused_tick=False))
    assert got == drive(ref, script)
    assert eng.logprobs == ref.logprobs
    assert eng.ring_cursor_rollovers == 1 == \
        eng.stats["ring_cursor_rollovers"]
    assert eng.full_rebuilds == 2 and int(eng._drained.max()) < 2 ** 30


def test_export_resumable_parity_and_bitwise_resume(pair):
    tm = pair[1]

    def partial(**kw):
        eng = PagedEngine(tm, **dict(BASE, max_slots=2, **kw))
        eng.submit("r1", cyc(6), max_new_tokens=30)
        eng.submit("r2", cyc(7, 1), max_new_tokens=30, temperature=0.7,
                   seed=2)
        for _ in range(9):
            eng.step()
        return eng.export_resumable()

    exp = partial()
    assert exp == partial(delta_transitions=False)
    d = exp["r1"]
    fresh = PagedEngine(tm, **dict(BASE, max_slots=2))
    fresh.submit("r1", np.asarray(d["prompt"])[None],
                 max_new_tokens=d["remaining"], resume_tokens=d["committed"],
                 resume_lps=d["committed_lps"])
    ref = PagedEngine(tm, **dict(BASE, max_slots=2))
    ref.submit("r1", cyc(6), max_new_tokens=30)
    assert fresh.run()["r1"] == ref.run()["r1"]


def test_counters_flow_to_stats_and_health(pair):
    eng = PagedEngine(pair[1], **BASE)
    eng.submit("a", cyc(5), max_new_tokens=6)
    eng.run()
    st = eng.stats
    assert st["full_rebuilds"] == eng.full_rebuilds == 1
    assert st["delta_patches"] == eng.delta_patches
    assert st["h2d_upload_bytes"] == eng.h2d_upload_bytes > 0
    assert st["dispatches"] == eng.dispatch_count > 0
    assert st["patches_fused"] == eng.patches_fused
    assert st["patch_queue_overflows"] == 0
    assert st["ring_cursor_rollovers"] == 0
    assert sorted(eng._delta_rows) == [0]     # the last release, pending
    h = eng.health()
    assert h["full_rebuilds"] == eng.full_rebuilds
    assert h["dispatches_per_tick"] == pytest.approx(
        eng.dispatch_count / h["decode_steps"], abs=1e-3)
