"""The port's ``PagedEngine`` (host tick) against the JAX package's
``PagedEngine(fused_tick=False)``, on the same weights (fp32, CPU).

Each case drives both engines through the same script of submits and
steps, mirroring ``tests/test_paged.py``: greedy tokens must be identical
and logprobs within 1e-4, and the scheduler counters must agree. Sampled
streams cannot match the JAX package's threefry draws; the port's own
properties (batch independence, resume across preemption, the seeded
distribution) are pinned instead."""
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
from paddle_tpu_torch.utils.faults import BackpressureError

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
BASE = dict(max_slots=4, num_blocks=32, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16, 32), fused_tick=False)
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


def _pair(**overrides):
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny(**overrides))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**overrides), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _drive(eng, script):
    for act in script:
        if act[0] == "submit":
            eng.submit(act[1], act[2], **act[3])
        elif act[0] == "step":
            for _ in range(act[1]):
                eng.step()
    return eng.run()


def _both(pair, script, **kw):
    """Run ``script`` on the JAX and the port engine; assert identical
    tokens, logprobs within ATOL_LP and equal counters. Returns the port
    engine."""
    jm, tm = pair
    je = JaxEngine(jm, **dict(BASE, **kw))
    te = PagedEngine(tm, **dict(BASE, **kw))
    ref = _drive(je, script)
    got = _drive(te, script)
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0, err_msg=str(rid))
    for k in STATS:
        assert te.stats[k] == je.stats[k], (k, te.stats, je.stats)
    return te


def _ids(rs, n):
    return rs.randint(1, 256, (1, n))


def _submits(prompts, **kw):
    return [("submit", rid, ids, dict(kw)) for rid, ids in prompts.items()]


def test_mixed_lengths_and_admission_mid_decode(pair):
    rs = np.random.RandomState(0)
    prompts = {f"r{i}": _ids(rs, rs.randint(4, 14)) for i in range(6)}
    script = _submits(prompts, max_new_tokens=12)
    script += [("step", 5), ("submit", "late", _ids(rs, 5),
                             dict(max_new_tokens=6))]
    te = _both(pair, script)
    assert set(te.results) == set(prompts) | {"late"}


def test_eos_frees_slot_early(pair):
    rs = np.random.RandomState(2)
    ids = _ids(rs, 8)
    eng = PagedEngine(pair[1], **BASE)
    eng.submit("free", ids, max_new_tokens=24)
    eos = eng.run()["free"][5]
    te = _both(pair, [("submit", "x", ids,
                       dict(max_new_tokens=24, eos_token_id=eos))])
    assert te.results["x"][-1] == eos and len(te.results["x"]) <= 6


def test_sliding_window_model():
    pair = _pair(sliding_window=8)
    rs = np.random.RandomState(3)
    _both(pair, [("submit", "w", _ids(rs, 12), dict(max_new_tokens=10)),
                 ("submit", "v", _ids(rs, 5), dict(max_new_tokens=10))])


def test_preemption(pair):
    rs = np.random.RandomState(6)
    prompts = {f"p{i}": _ids(rs, 7) for i in range(3)}
    te = _both(pair, _submits(prompts, max_new_tokens=24,
                              repetition_penalty=1.3),
               max_slots=3, num_blocks=7, max_blocks_per_seq=6)
    assert te.stats["preemptions"] > 0
    assert len(te.free_blocks) == 6          # all recycled (block 0 kept)


def test_chunked_prefill(pair):
    rs = np.random.RandomState(11)
    prompts = {f"c{i}": _ids(rs, n) for i, n in enumerate([3, 8, 17, 30])}
    te = _both(pair, _submits(prompts, max_new_tokens=10),
               chunk_prefill_tokens=8)
    assert te.stats["prefill_chunks"] >= 1 + 1 + 3 + 4


def test_prefix_cache_hit_and_no_false_sharing(pair):
    rs = np.random.RandomState(40)
    pref = rs.randint(1, 256, 32).tolist()
    a = np.asarray([pref + rs.randint(1, 256, 5).tolist()])
    b = np.asarray([pref + rs.randint(1, 256, 7).tolist()])
    other = b.copy()
    other[0, 0] = other[0, 0] % 255 + 1
    script = [("submit", "a", a, dict(max_new_tokens=8)), ("step", 40),
              ("submit", "b", b, dict(max_new_tokens=8,
                                      repetition_penalty=1.4)),
              ("step", 40),
              ("submit", "o", other, dict(max_new_tokens=8))]
    te = _both(pair, script, chunk_prefill_tokens=16,
               enable_prefix_cache=True)
    assert te.stats["prefix_hit_tokens"] == 32     # b only, not o
    assert not te.block_refs
    assert len(te.free_blocks) + len(te.cached_free) == te.P - 1


def test_prefix_cache_eviction_under_pressure(pair):
    rs = np.random.RandomState(42)
    prompts = {f"r{i}": np.asarray([rs.randint(1, 256, 33)])
               for i in range(5)}
    te = _both(pair, _submits(prompts, max_new_tokens=4),
               chunk_prefill_tokens=16, enable_prefix_cache=True,
               num_blocks=16, max_slots=2)
    assert len(te.free_blocks) + len(te.cached_free) == te.P - 1


def test_stop_sequences(pair):
    rs = np.random.RandomState(50)
    ids = _ids(rs, 8)
    eng = PagedEngine(pair[1], **BASE)
    eng.submit("free", ids, max_new_tokens=24)
    full = eng.run()["free"]
    stop = (full[2], full[3])
    te = _both(pair, [
        ("submit", "s", ids, dict(max_new_tokens=24, stop_sequences=[stop])),
        ("submit", "n", ids, dict(max_new_tokens=12,
                                  stop_sequences=[(999, 999)]))])
    assert te.results["n"] == full[:12]
    first_end = next(i + 1 for i in range(1, len(full))
                     if (full[i - 1], full[i]) == stop)
    assert te.results["s"] == full[:first_end - 2]
    assert len(te.logprobs["s"]) == len(te.results["s"])


def test_repetition_penalty_while_other_slot_prefills(pair):
    rs = np.random.RandomState(63)
    script = [("submit", "a", _ids(rs, 6),
               dict(max_new_tokens=20, repetition_penalty=1.4)),
              ("step", 2),
              ("submit", "b", _ids(rs, 40),
               dict(max_new_tokens=16, repetition_penalty=1.4))]
    _both(pair, script, chunk_prefill_tokens=8, max_slots=2)


def test_stream_matches_results_and_jax(pair):
    jm, tm = pair
    rs = np.random.RandomState(70)
    prompts = {f"r{i}": _ids(rs, rs.randint(4, 12)) for i in range(5)}
    stop_ids = _ids(rs, 8)
    je = JaxEngine(jm, **BASE)
    te = PagedEngine(tm, **BASE)
    got = {}
    for eng, sink in ((je, {}), (te, got)):
        for rid, ids in prompts.items():
            eng.submit(rid, ids, max_new_tokens=10)
        eng.submit("stop", stop_ids, max_new_tokens=24,
                   stop_sequences=[(1, 2, 3)])
        for rid, tok in eng.stream():
            sink.setdefault(rid, []).append(tok)
    for rid in list(prompts) + ["stop"]:
        assert got[rid] == te.results[rid] == je.results[rid], rid


def test_predictor_serve_stream(pair):
    jm, tm = pair
    rs = np.random.RandomState(7)
    reqs = {f"q{i}": _ids(rs, 6 + i) for i in range(3)}
    kw = dict(max_slots=2, num_blocks=16, block_size=8,
              max_blocks_per_seq=4, prefill_buckets=(16,))
    jp = JaxPredictor(jm)
    tp = ptt.Predictor(tm, device="cpu")
    ref = jp.serve_stream(reqs, max_new_tokens=8, fused_tick=False, **kw)
    got = tp.serve_stream(reqs, max_new_tokens=8, fused_tick=False, **kw)
    assert got == ref
    assert tp.last_serve_stats["prefills"] == 3
    again = tp.serve_stream(reqs, max_new_tokens=8, fused_tick=False, **kw)
    assert again == got and len(tp._paged_engines) == 1


# ---------------------------------------------------------- port-only pins
def _sampled(tm, script, **kw):
    eng = PagedEngine(tm, **dict(BASE, **kw))
    out = _drive(eng, script)
    return eng, out


def test_sampled_request_is_batch_independent_and_survives_preemption(pair):
    tm = pair[1]
    rs = np.random.RandomState(9)
    ids = _ids(rs, 6)
    samp = dict(max_new_tokens=30, temperature=0.8, top_p=0.9, seed=42)
    _, alone = _sampled(tm, [("submit", "v", ids, samp)])
    mixed_script = [("submit", "g", _ids(rs, 9), dict(max_new_tokens=30)),
                    ("submit", "v", ids, samp),
                    ("submit", "h", _ids(rs, 4),
                     dict(max_new_tokens=20, temperature=1.0, seed=3))]
    _, mixed = _sampled(tm, mixed_script)
    assert mixed["v"] == alone["v"]
    eng, pre = _sampled(tm, [("submit", "a", _ids(rs, 6),
                              dict(max_new_tokens=30)),
                             ("submit", "v", ids, samp)],
                        max_slots=2, num_blocks=7, max_blocks_per_seq=6)
    assert eng.stats["preemptions"] >= 1
    assert pre["v"] == alone["v"]
    _, other = _sampled(tm, [("submit", "v", ids, dict(samp, seed=43))])
    assert other["v"] != alone["v"]


def test_health_zeroes_after_drain_and_lifecycle(pair):
    tm = pair[1]
    rs = np.random.RandomState(13)
    eng = PagedEngine(tm, **dict(BASE, max_queue=3))
    for i in range(3):
        eng.submit(f"m{i}", _ids(rs, 5), max_new_tokens=6)
    with pytest.raises(BackpressureError):
        eng.submit("over", _ids(rs, 5), max_new_tokens=6)
    eng.step()
    assert sum(s is not None for s in eng.slots) == 3 and not eng.queue
    assert eng.cancel("m1") and not eng.cancel("nope")
    eng.submit("t", _ids(rs, 5), max_new_tokens=6, timeout_s=0.0)
    exported = eng.export_resumable()
    assert set(exported) == {"m0", "m2", "t"}
    assert exported["m0"]["committed"] == eng.slots[0].tokens
    eng.run()
    h = eng.health()
    assert (h["active_slots"], h["queued"], h["free_blocks"]) == (
        0, 0, eng.P - 1)
    assert eng.cancelled == {"m1": "cancelled", "t": "timeout"}
    assert set(eng.results) == {"m0", "m2"}
    eng.submit("x", _ids(rs, 5), max_new_tokens=6)
    eng.step()
    eng.hard_reset()
    assert eng.health()["active_slots"] == 0 and not eng.queue


def test_resume_tokens_continue_the_stream(pair):
    tm = pair[1]
    rs = np.random.RandomState(14)
    ids = _ids(rs, 7)
    _, full = _sampled(tm, [("submit", "r", ids, dict(max_new_tokens=12))])
    head = full["r"][:5]
    _, resumed = _sampled(tm, [("submit", "r",
                                np.concatenate([ids[0], head]),
                                dict(max_new_tokens=7, resume_tokens=head))])
    assert resumed["r"] == full["r"]


def test_h2d_uploads_match_the_jax_host_path_per_tick(pair):
    jm, tm = pair
    rs = np.random.RandomState(15)
    a, b = _ids(rs, 6), _ids(rs, 9)
    engines = (JaxEngine(jm, **BASE), PagedEngine(tm, **BASE))
    for eng in engines:
        eng.submit("g", a, max_new_tokens=8)
        eng.submit("s", b, max_new_tokens=8, temperature=0.7, seed=1)
    for _ in range(10):
        deltas = []
        for eng in engines:
            n = eng.h2d_uploads
            eng.step()
            deltas.append(eng.h2d_uploads - n)
        assert deltas[0] == deltas[1]


def test_later_slice_modes_raise(pair):
    tm = pair[1]
    # speculative ticks are ported: they need the device-resident tick
    assert PagedEngine(tm, **dict(BASE, fused_tick=True, spec_tokens=2))._spec_k == 2
    with pytest.raises(ValueError, match="fused_tick"):
        PagedEngine(tm, fused_tick=False, spec_tokens=2)
    for fused in (True, False):
        with pytest.raises(NotImplementedError, match="A2\\(e\\)"):
            PagedEngine(tm, fused_tick=fused, tick_profile=True)
    with pytest.raises(ValueError, match="chunk_prefill_tokens"):
        PagedEngine(tm, fused_tick=False, enable_prefix_cache=True)
    # the device-resident tick (the default) and its modes construct
    assert PagedEngine(tm, **dict(BASE, fused_tick=True))._ring
    PagedEngine(tm, **dict(BASE, fused_tick=True, ticks_per_dispatch=4,
                           delta_transitions=False))


# ------------------------------------------------------- per-row sampling
def test_filters_and_penalty_rows_match_jax():
    import jax.numpy as jnp
    rs = np.random.RandomState(3)
    logits = (rs.randn(5, 64) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9], np.float32)
    tk = np.array([0, 5, 0, 64, 1], np.int32)
    tp = np.array([1.0, 0.9, 0.5, 0.999, 0.3], np.float32)
    ref = np.asarray(jax_sampling.filter_logits_rows(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp)))
    got = sampling.filter_logits_rows(*(torch.from_numpy(x) for x in
                                        (logits, temp, tk, tp))).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    np.testing.assert_allclose(got[ref > -1e29], ref[ref > -1e29],
                               rtol=1e-6)
    seen = rs.rand(5, 64) > 0.5
    reps = np.array([1.0, 1.3, 0.8, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        sampling.repetition_penalty_rows(torch.from_numpy(logits),
                                         torch.from_numpy(seen),
                                         torch.from_numpy(reps)).numpy(),
        np.asarray(jax_sampling.repetition_penalty_rows(
            jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(reps))))


def test_gumbel_draws_follow_the_filtered_distribution():
    """4000 rows over one 8-way logit row, keys (seed i, counter 0):
    the token counts pass a chi-square test at p = 0.001 (7 degrees of
    freedom: 24.32) against softmax(logits / T); top-k masked tokens are
    never drawn; greedy rows take the argmax; every counter advances."""
    n, V = 4000, 8
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, 2.0, 0.3, -1.0, 1.5]])
    keys = torch.stack([torch.arange(n), torch.zeros(n, dtype=torch.long)],
                       dim=1)
    temp = torch.full((n,), 0.9)
    tok, lp, new = sampling.sample_token_rows(
        logits.expand(n, V), keys, temp, torch.zeros(n, dtype=torch.int32),
        torch.ones(n))
    probs = torch.softmax(logits[0] / 0.9, dim=-1).double().numpy()
    counts = np.bincount(tok.numpy(), minlength=V)
    chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
    assert chi2 < 24.32, (chi2, counts)
    assert torch.equal(new[:, 1], keys[:, 1] + 1)
    np.testing.assert_allclose(
        lp.numpy(), torch.log_softmax(logits[0], -1)[tok].numpy(),
        rtol=1e-6)
    tok_k, _, _ = sampling.sample_token_rows(
        logits.expand(n, V), keys, temp,
        torch.full((n,), 2, dtype=torch.int32), torch.ones(n))
    assert set(tok_k.tolist()) == {4, 7}
    greedy, _, _ = sampling.sample_token_rows(
        logits.expand(4, V), keys[:4], torch.zeros(4),
        torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert greedy.tolist() == [4, 4, 4, 4]


def test_noise_is_a_function_of_the_key_alone():
    keys = torch.tensor([[7, 0], [7, 1], [8, 0], [7, 0]])
    g = sampling.gumbel_noise_rows(keys, 50)
    assert torch.equal(g[0], g[3])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.equal(sampling.gumbel_noise_rows(keys[1:2], 50)[0], g[1])
    assert sampling.seed_key_row(2 ** 32 + 5).tolist() == [5, 0]
