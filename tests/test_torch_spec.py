"""The port's speculative ``PagedEngine`` ticks (``spec_tokens=k``) against
the JAX package's, on the CPU, in fp32, at a small size.

- The prompt-lookup helpers (``propose_ngram``, ``propose_ngram_rows``,
  ``mask_drafts``, ``accept_length``, ``token_buffer_row``) and the rows
  version of ``suffix_window_hits``: equal to the JAX functions on seeded
  inputs.
- ``residual_resample_rows`` against the JAX one in distribution (V = 8,
  20000 keys): P(accept) against p(draft) and the token frequencies
  against p, each within 0.015 (over 4 standard errors); the two
  packages' frequencies within 0.02 of each other. Greedy rows exactly.
- ``PagedEngine(spec_tokens=3)`` against the JAX spec engine on
  ``llama_tiny`` with the same weights and ``lm_head`` x 10 (decisive
  logits, as ``tests/test_paged_spec.py`` does): greedy tokens
  identical, logprobs within 1e-4, and the counters equal.
- Inside the port, bit for bit on a ``LookupStub`` (logits read from a
  table, so the verify's query count cannot move them; the JAX tests'
  stub): spec streams against spec-off streams, greedy and sampled, over
  the cases of ``tests/test_paged_spec.py`` and the spec cases of
  ``tests/test_ring_spec.py``; the dispatch contract; the
  ``ValueError``s, and the one a card raises for a model whose verify
  the ragged kernel cannot take.
- The ragged wrapper's split of a window of more query rows than one
  launch holds: equal to the plain version over the whole window.

On the CPU a dispatch is one eager call of the spec program; on a card it
is one CUDA-graph replay (``tests/test_torch_spec_gpu.py``)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import prompt_lookup as jax_lookup
from paddle_tpu.generation import sampling as jax_sampling
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import prompt_lookup, sampling
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    MAX_ROWS, query_windows, ragged_paged_attention,
    ragged_paged_attention_plain)
from paddle_tpu_torch.utils import observability as obs

from test_torch_spec_gpu import LookupStub

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
# empirical probabilities over N_KEYS draws: the binomial standard error
# is at most 0.0035, so 0.015 is over 4 of them (0.02 for the difference
# of two empirical estimates)
N_KEYS = 20000
TOL_P = 0.015
TOL_P_PAIR = 0.02
BASE = dict(max_slots=4, num_blocks=32, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16, 32))
# the counters both packages keep, compared as equal
COUNTERS = ("dispatch_count", "h2d_uploads", "h2d_upload_bytes",
            "full_rebuilds", "delta_patches", "patches_fused",
            "ring_drains", "ring_scoped_drains")
STATS = ("decode_steps", "prefills", "preemptions", "prefill_chunks",
         "prefix_hit_tokens", "active_slot_steps", "spec_proposed",
         "spec_accepted")


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- prompt lookup
def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k,g", [(1, 1), (3, 2), (4, 3), (5, 2)])
def test_propose_ngram_rows_matches_jax(k, g):
    rs = np.random.RandomState(10 * k + g)
    R, L = 8, 24
    seqs = rs.randint(0, 4, (R, L)).astype(np.int32)   # small alphabet
    ns = np.array([0, 1, g, g + 1, 9, L - k, L - 1, L], np.int32)
    ref = np.asarray(jax_lookup.propose_ngram_rows(
        jnp.asarray(seqs), jnp.asarray(ns), k, g))
    got = prompt_lookup.propose_ngram_rows(_t(seqs), _t(ns), k, g)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != -1).any() and (ref == -1).any()
    for r in (2, 4, 6):
        one = prompt_lookup.propose_ngram(_t(seqs[r]), _t(ns[r]), k, g, 0)
        np.testing.assert_array_equal(one.numpy(), np.asarray(
            jax_lookup.propose_ngram(jnp.asarray(seqs[r]),
                                     jnp.int32(ns[r]), k, g, 0)))
    hits = sampling.suffix_window_hits_rows(_t(seqs), _t(ns), g)
    want = np.stack([np.asarray(jax_sampling.suffix_window_hits(
        jnp.asarray(seqs[r]), jnp.int32(ns[r]), g)) for r in range(R)])
    np.testing.assert_array_equal(hits.numpy(), want)


def test_mask_accept_and_token_buffer_match_jax():
    rs = np.random.RandomState(3)
    drafts = rs.randint(-1, 6, (6, 4)).astype(np.int32)
    kprop = np.array([0, 1, 2, 3, 4, 2], np.int32)
    np.testing.assert_array_equal(
        prompt_lookup.mask_drafts(_t(drafts), _t(kprop)).numpy(),
        np.asarray(jax_lookup.mask_drafts(jnp.asarray(drafts),
                                          jnp.asarray(kprop))))
    d = rs.randint(0, 3, (16, 4)).astype(np.int32)
    tgt = rs.randint(0, 3, (16, 5)).astype(np.int32)
    tgt[:8, :4] = d[:8]                       # long accepted prefixes too
    np.testing.assert_array_equal(
        prompt_lookup.accept_length(_t(d), _t(tgt)).numpy(),
        np.asarray(jax_lookup.accept_length(jnp.asarray(d),
                                            jnp.asarray(tgt))))
    assert int(prompt_lookup.accept_length(_t(d[9]), _t(tgt[9]))) == int(
        jax_lookup.accept_length(jnp.asarray(d[9]), jnp.asarray(tgt[9])))
    for seq, n in (([5, 6, 7], 8), (list(range(1, 12)), 6), ([], 4)):
        np.testing.assert_array_equal(
            prompt_lookup.token_buffer_row(seq, n),
            jax_lookup.token_buffer_row(seq, n))


# ------------------------------------------------- residual resampling
LOGITS8 = np.array([2.0, 1.0, 0.0, -1.0, 0.5, 1.5, -2.0, 0.2], np.float32)


def _jax_draws(draft, temp, tk, tp):
    keys = jax.vmap(jax.random.key_data)(
        jax.random.split(jax.random.PRNGKey(0), N_KEYS))
    f = jnp.full
    toks, acc, _ = jax_sampling.residual_resample_rows(
        jnp.broadcast_to(jnp.asarray(LOGITS8), (N_KEYS, 8)),
        f((N_KEYS,), draft, jnp.int32), keys, f((N_KEYS,), temp),
        f((N_KEYS,), tk, jnp.int32), f((N_KEYS,), tp))
    return np.asarray(toks), np.asarray(acc)


def _port_draws(draft, temp, tk, tp):
    keys = torch.stack([torch.arange(N_KEYS) + 1000,
                        torch.full((N_KEYS,), 7)], dim=1)
    f = torch.full
    toks, acc, _ = sampling.residual_resample_rows(
        torch.from_numpy(LOGITS8).expand(N_KEYS, 8), f((N_KEYS,), draft),
        keys, f((N_KEYS,), temp), f((N_KEYS,), tk, dtype=torch.int32),
        f((N_KEYS,), tp))
    return toks.numpy(), acc.numpy()


@pytest.mark.parametrize("draft,temp,tk,tp", [
    (0, 1.0, 0, 1.0), (3, 1.0, 0, 1.0), (-1, 1.0, 0, 1.0),
    (5, 0.7, 3, 1.0), (6, 1.0, 3, 1.0), (1, 1.2, 0, 0.8),
    (3, 1.0, 0, 0.6)],
    ids=["likely", "unlikely", "none", "topk_kept", "topk_filtered",
         "topp_kept", "topp_filtered"])
def test_residual_resample_matches_jax_in_distribution(draft, temp, tk, tp):
    p = torch.softmax(sampling.filter_logits_rows(
        torch.from_numpy(LOGITS8)[None], torch.tensor([temp]),
        torch.tensor([tk]), torch.tensor([tp]))[0], dim=-1).numpy()
    freqs = {}
    for name, draws in (("port", _port_draws), ("jax", _jax_draws)):
        toks, acc = draws(draft, temp, tk, tp)
        freqs[name] = np.bincount(toks, minlength=8) / N_KEYS
        np.testing.assert_allclose(freqs[name], p, atol=TOL_P, err_msg=name)
        want = p[draft] if draft >= 0 else 0.0
        assert abs(acc.mean() - want) <= TOL_P, (name, acc.mean(), want)
        if draft >= 0 and p[draft] == 0:
            assert not acc.any() and not (toks == draft).any()
    np.testing.assert_allclose(freqs["port"], freqs["jax"], atol=TOL_P_PAIR)


def test_residual_resample_greedy_rows_exact():
    rs = np.random.RandomState(4)
    logits = rs.randn(6, 8).astype(np.float32)
    draft = np.array([int(np.argmax(logits[0])), 2, -1,
                      int(np.argmax(logits[3])), 0, 7], np.int32)
    zeros = np.zeros(6, np.float32)
    ref = jax_sampling.residual_resample_rows(
        jnp.asarray(logits), jnp.asarray(draft), jnp.zeros((6, 2),
                                                           jnp.uint32),
        jnp.asarray(zeros), jnp.zeros(6, jnp.int32), jnp.ones(6))
    got = sampling.residual_resample_rows(
        _t(logits), _t(draft), torch.zeros(6, 2, dtype=torch.int64),
        _t(zeros), torch.zeros(6, dtype=torch.int32), torch.ones(6))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               atol=1e-6)


def test_spec_keys_follow_the_plain_tick():
    """Position j draws with the counter advanced by j, the carry by the
    tokens emitted, so j draws of the verify are the plain tick's next j
    tokens."""
    keys = torch.tensor([[5, 2 ** 32 - 2], [9, 0]])
    carry, sub = sampling.split_key_rows(keys, torch.tensor([3, 0]))
    assert sub.tolist() == keys.tolist()
    assert carry.tolist() == [[5, 1], [9, 0]]
    logits = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    t, tk, tp = torch.ones(2), torch.zeros(2, dtype=torch.int32), \
        torch.ones(2)
    k = keys
    for j in range(3):
        plain, _, k = sampling.sample_token_rows(logits, k, t, tk, tp)
        spec, _, _ = sampling.residual_resample_rows(
            logits, torch.full((2,), -1), sampling.fold_in_rows(keys, j),
            t, tk, tp)
        assert torch.equal(plain, spec)


# ------------------------------------------- against the JAX spec engine
@pytest.fixture(scope="module")
def pair():
    """llama_tiny in both packages on the same weights, lm_head x 10:
    decisive logits keep token equality off the accumulation order."""
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    jm.lm_head.weight = jm.lm_head.weight * 10.0
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def drive(eng, script):
    """Run a script of ("submit", rid, ids, kw) and ("step", n) actions,
    then drain; returns the results."""
    for act in script:
        if act[0] == "submit":
            eng.submit(act[1], act[2], **act[3])
        else:
            for _ in range(act[1]):
                eng.step()
    return eng.run()


def _rep(rs, n, period=5):
    """A prompt repeating a seeded ``period``-token pattern."""
    pat = rs.randint(1, 200, period)
    return np.tile(pat, -(-n // period))[None, :n]


def greedy_script(seed=21):
    rs = np.random.RandomState(seed)
    return [("submit", "a", _rep(rs, 12), dict(max_new_tokens=18)),
            ("submit", "b", rs.randint(1, 200, (1, 9)),
             dict(max_new_tokens=16, stop_sequences=[[7], [3, 5]])),
            ("submit", "c", _rep(rs, 7, 3),
             dict(max_new_tokens=14, eos_token_id=2)),
            ("submit", "d", _rep(rs, 10, 4),
             dict(max_new_tokens=12, repetition_penalty=1.3))]


def midstream_script(seed=22):
    rs = np.random.RandomState(seed)
    return [("submit", "r0", _rep(rs, 10), dict(max_new_tokens=20)),
            ("step", 4),
            ("submit", "r1", _rep(rs, 13, 3), dict(max_new_tokens=12))]


@pytest.mark.parametrize("script,kw", [
    (greedy_script, {}),
    (greedy_script, dict(ring_mode=False)),
    (midstream_script, dict(ring_len=8)),
    (greedy_script, dict(chunk_prefill_tokens=8, enable_prefix_cache=True,
                         prefill_buckets=(8,))),
], ids=["default", "ring_off", "midstream_ring8", "chunk_prefix"])
def test_spec_engine_matches_jax(pair, script, kw):
    jm, tm = pair
    je = JaxEngine(jm, **dict(BASE, spec_tokens=3, **kw))
    te = PagedEngine(tm, **dict(BASE, spec_tokens=3, **kw))
    ref = drive(je, script())
    got = drive(te, script())
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0, err_msg=str(rid))
    assert {c: getattr(te, c) for c in COUNTERS} == \
        {c: getattr(je, c) for c in COUNTERS}
    for key in STATS:
        assert te.stats[key] == je.stats[key], key
    assert te.health()["spec_accept_rate"] == je.health()["spec_accept_rate"]
    assert te.stats["spec_accepted"] > 0
    assert te.stats["decode_steps"] < te.stats["active_slot_steps"]


def test_serve_stream_takes_spec_tokens(pair):
    jm, tm = pair
    rs = np.random.RandomState(7)
    reqs = {f"q{i}": _rep(rs, 8 + i) for i in range(3)}
    kw = dict(max_slots=2, num_blocks=16, block_size=8,
              max_blocks_per_seq=4, prefill_buckets=(16,), spec_tokens=3)
    tp = ptt.Predictor(tm, device="cpu")
    got = tp.serve_stream(reqs, max_new_tokens=10, **kw)
    eng = next(iter(tp._paged_engines.values()))
    assert eng._spec_k == 3 and eng.stats["spec_proposed"] > 0
    assert got == tp.serve_stream(reqs, max_new_tokens=10, max_slots=2,
                                  num_blocks=16, block_size=8,
                                  max_blocks_per_seq=4,
                                  prefill_buckets=(16,))


# ------------------------------------------------ the port, bit for bit
STUB = dict(max_slots=4, num_blocks=64, block_size=64, max_blocks_per_seq=4,
            prefill_buckets=(16,))


def stub_engine(period=7, **kw):
    return PagedEngine(LookupStub(period), **dict(STUB, **kw))


def _drain(eng, subs):
    for rid, ids, kw in subs:
        eng.submit(rid, ids, **kw)
    res = eng.run()
    return res, dict(eng.logprobs)


def _cyc(n, start=1, period=7):
    return np.asarray([[(start + i) % period for i in range(n)]])


SAMPLED = dict(temperature=0.9, top_k=12, seed=3)
RING_SUBS = [("a", _cyc(6), dict(max_new_tokens=30)),
             ("b", _cyc(9, start=3), dict(max_new_tokens=25)),
             ("s", _cyc(7), dict(max_new_tokens=24, stop_sequences=[[3, 4]])),
             ("e", _cyc(8), dict(max_new_tokens=30, eos_token_id=5))]
# (submissions, engine arguments of both engines, of the spec engine)
CASES = {
    "greedy": ([("a", _cyc(6), dict(max_new_tokens=30)),
                ("b", _cyc(9, start=3), dict(max_new_tokens=25)),
                ("c", np.asarray([[2, 9, 4]]), dict(max_new_tokens=20))],
               {}, {}),
    "eos_mid_window": ([("e", _cyc(8), dict(max_new_tokens=30,
                                            eos_token_id=5))], {}, {}),
    "stop_mid_window": ([("s", _cyc(7), dict(
        max_new_tokens=30, stop_sequences=[[3, 4]]))], {}, {}),
    "budget_mid_window": ([(f"m{n}", _cyc(6), dict(max_new_tokens=n))
                           for n in (1, 9, 13)], {}, {}),
    "mixed_sampled_penalised": (
        [("spec", _cyc(8), dict(max_new_tokens=24)),
         ("samp", _cyc(5, start=2), dict(max_new_tokens=18, **SAMPLED)),
         ("hot", _cyc(6, start=3), dict(max_new_tokens=20, temperature=1.5,
                                        top_p=0.9, seed=8)),
         ("pen", _cyc(6, start=4), dict(max_new_tokens=15,
                                        repetition_penalty=1.3))], {}, {}),
    "table_fills_mid_window": ([("x", _cyc(6), dict(max_new_tokens=10))],
                               dict(block_size=8, max_blocks_per_seq=2,
                                    num_blocks=16), {}),
    "chunked_prefix_cache": (
        [("a", np.asarray([list(range(1, 7)) * 2 + [2, 3, 4, 5]]),
          dict(max_new_tokens=18)),
         ("b", np.asarray([list(range(1, 7)) * 2 + [2, 3, 1, 2]]),
          dict(max_new_tokens=12, **SAMPLED)),
         ("c", _cyc(11, start=2), dict(max_new_tokens=9))],
        dict(block_size=8, max_blocks_per_seq=8, num_blocks=48,
             chunk_prefill_tokens=8, enable_prefix_cache=True,
             prefill_buckets=(8,)), {}),
    "preempt": ([(f"p{i}", _cyc(6 + i, start=i), dict(
        max_new_tokens=20, **(SAMPLED if i % 2 else {}))) for i in range(4)],
        dict(block_size=8, max_blocks_per_seq=4, num_blocks=9), {}),
    "ring_wrap": (RING_SUBS, {}, dict(ring_len=4)),
    "ring_off": (RING_SUBS, {}, dict(ring_mode=False)),
    "spec_over_scan": (RING_SUBS, {}, dict(ticks_per_dispatch=4)),
    "rebuild_transitions": (RING_SUBS, {}, dict(delta_transitions=False)),
    "ngram1_k2": (RING_SUBS, {}, dict(spec_tokens=2, spec_ngram=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_streams_bitwise_spec_off(case):
    """Spec streams equal the spec-off default engine's bit for bit,
    tokens and logprobs, sampled rows included, while the spec engine
    accepts drafts and needs fewer ticks."""
    subs, kw, spec_kw = CASES[case]
    off = stub_engine(**kw)
    r_off, lp_off = _drain(off, subs)
    on = stub_engine(**dict(kw, **dict(dict(spec_tokens=4), **spec_kw)))
    r_on, lp_on = _drain(on, subs)
    assert r_on == r_off
    assert lp_on == lp_off
    assert all(len(v) >= 1 for v in r_on.values())
    if case != "budget_mid_window":
        assert on.stats["spec_accepted"] > 0
        assert on.stats["decode_steps"] < off.stats["decode_steps"]
    if case == "preempt":
        assert on.stats["preemptions"] > 0
    if case == "table_fills_mid_window":
        assert len(r_on["x"]) == 10
    if case == "stop_mid_window":
        assert tuple(r_on["s"][-2:]) != (3, 4)


def test_midstream_submit_emission_order():
    """A submit mid-stream: each request's own emission order is that of
    the spec-off engine (spec commits several tokens a tick, so the
    interleave across requests may differ)."""
    def run(**kw):
        eng = stub_engine(**kw)
        eng.submit("r0", _cyc(6), max_new_tokens=26)
        out = []
        for n, item in enumerate(eng.stream()):
            out.append(item)
            if n == 3:
                eng.submit("r1", _cyc(9, start=2), max_new_tokens=14,
                           **SAMPLED)
        return out, dict(eng.results), dict(eng.logprobs)

    so, ro, lo = run()
    ss, rs_, ls = run(spec_tokens=4)
    assert ro == rs_ and lo == ls
    for rid in ro:
        assert [t for r, t in so if r == rid] == \
            [t for r, t in ss if r == rid]


def test_collapsed_accept_rate_stops_drafting():
    """A stream that never repeats an n-gram: the EMA falls below the
    floor within a few ticks and the row drafts only on probe ticks."""
    subs = [("r", np.asarray([[1, 2, 3]]), dict(max_new_tokens=36))]
    r_off, lp_off = _drain(stub_engine(period=60), subs)
    eng = stub_engine(period=60, spec_tokens=4)
    r_on, lp_on = _drain(eng, subs)
    assert r_off == r_on and lp_off == lp_on
    assert eng.stats["spec_accepted"] == 0
    assert 0 < eng.stats["spec_proposed"] <= 24


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "sync"])
def test_steady_spec_tick_one_dispatch_zero_uploads(ring):
    eng = stub_engine(spec_tokens=4, ring_mode=ring)
    for i in range(4):
        eng.submit(f"r{i}", _cyc(8), max_new_tokens=60)
    for _ in range(4):
        eng.step()
    d0, u0, s0 = eng.dispatch_count, eng.h2d_uploads, eng.d2h_syncs
    t0 = sum(len(s.tokens) for s in eng.slots if s is not None)
    n = 6
    for _ in range(n):
        eng.step()
    toks = sum(len(s.tokens) for s in eng.slots if s is not None) - t0
    assert eng.dispatch_count - d0 == n
    assert eng.h2d_uploads - u0 == 0
    assert eng.d2h_syncs - s0 == (0 if ring else n)
    assert toks >= 2 * n * 4


def test_spec_counters_health_and_registry():
    eng = stub_engine(spec_tokens=4)
    events = []
    eng.trace_sink = lambda rid, kind, **f: events.append((kind, f))
    eng.submit("r", _cyc(8), max_new_tokens=30)
    eng.run()
    snap = eng.stats
    assert 0 < snap["spec_accepted"] <= snap["spec_proposed"]
    assert eng.health()["spec_accept_rate"] == round(
        snap["spec_accepted"] / snap["spec_proposed"], 4)
    label = eng._obs_labels["engine"]
    text = obs.registry().prometheus_text()
    for name, key in (("paged_spec_proposed_total", "spec_proposed"),
                      ("paged_spec_accepted_total", "spec_accepted")):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(name) and f'engine="{label}"' in ln)
        assert float(line.rsplit(" ", 1)[1]) == snap[key]
    _, tot, cnt = eng._h_tpf.export()
    assert cnt == snap["decode_steps"]
    assert tot == snap["active_slot_steps"]
    ticks = [f for kind, f in events if kind == "tick"]
    assert sum(f["accepted"] for f in ticks) == snap["spec_accepted"]
    assert all(f["ring_lag"] == 1 for f in ticks)


def test_cancel_races_inflight_spec_dispatch():
    """A cancel with a spec dispatch in flight drains only that row (its
    drafted and accepted counts with it); the sibling's stream is the
    spec-off one."""
    subs = [("keep", _cyc(6), dict(max_new_tokens=24)),
            ("drop", _cyc(8, start=2), dict(max_new_tokens=40))]
    ref, ref_lp = _drain(stub_engine(), subs[:1])
    eng = stub_engine(spec_tokens=4)
    for rid, ids, kw in subs:
        eng.submit(rid, ids, **kw)
    for _ in range(3):
        eng.step()
    assert eng._pending is not None
    assert eng.cancel("drop")
    assert eng.ring_scoped_drains == 1
    res = eng.run()
    assert res == ref and eng.logprobs["keep"] == ref_lp["keep"]
    assert eng.cancelled == {"drop": "cancelled"}


def test_hard_reset_then_spec_serves_again():
    subs = CASES["mixed_sampled_penalised"][0]
    eng = stub_engine(spec_tokens=4)
    for rid, ids, kw in subs[:2]:
        eng.submit(rid, ids, **kw)
    for _ in range(3):
        eng.step()
    eng.hard_reset()
    got = _drain(eng, subs)
    assert got == _drain(stub_engine(spec_tokens=4), subs)
    assert eng.full_rebuilds == 2


def test_spec_value_errors_match_jax(pair):
    jm, tm = pair
    for kw, match in ((dict(spec_tokens=2, fused_tick=False), "fused_tick"),
                      (dict(spec_tokens=2, spec_ngram=0), "spec_ngram"),
                      (dict(spec_tokens=-1), "spec_tokens")):
        with pytest.raises(ValueError, match=match):
            JaxEngine(jm, **dict(BASE, **kw))
        with pytest.raises(ValueError, match=match):
            PagedEngine(tm, **dict(BASE, **kw))
    for k, want in ((4, 16), (12, 26)):
        assert PagedEngine(tm, **dict(BASE, spec_tokens=k))._ring_len == \
            JaxEngine(jm, **dict(BASE, spec_tokens=k))._ring_len == want
    eng = PagedEngine(tm, **dict(BASE, spec_tokens=3))
    assert eng._desc_len == 15 + 8 + 8 * 8 + 4


def test_spec_on_a_card_needs_the_ragged_kernel():
    """On a card, a model whose verify the ragged kernel refuses (head_dim
    16; 33 query heads a kv head) raises before anything is allocated,
    rather than running every layer's verify through the plain gather.
    Llama-3-8B's verify fits at any k: k = 8 is 36 query rows a kv head,
    two launches a layer."""
    for cfg in (ptt.llama_tiny(),
                ptt.llama_tiny(hidden_size=66 * 64, num_attention_heads=66,
                               num_key_value_heads=2)):
        card_model = SimpleNamespace(device=torch.device("cuda"),
                                     config=cfg)
        with pytest.raises(ValueError, match="ragged paged kernel"):
            PagedEngine(card_model, **dict(BASE, spec_tokens=4))
    from paddle_tpu_torch.generation.paged import _check_verify_shapes
    for k in (1, 4, 8, 16):
        _check_verify_shapes(ptt.llama3_8b(), k + 1)
    assert query_windows(9, 4) == [(0, 5), (5, 9)]


@pytest.mark.parametrize("T,group", [(5, 4), (9, 4), (17, 2), (33, 1),
                                     (12, 8), (32, 3)])
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window"])
def test_ragged_splits_a_long_window(T, group, window):
    """A window of T x group > MAX_ROWS query rows runs as consecutive
    windows that each fit one launch (window j's queries at seq_lens plus
    its first index): the same numbers as the plain version over the
    whole window, in fp32."""
    spans = query_windows(T, group)
    assert spans[0][0] == 0 and spans[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all((t1 - t0) * group <= MAX_ROWS for t0, t1 in spans)
    assert len(spans) == -(-T // (MAX_ROWS // group))
    rs = np.random.RandomState(T * 100 + group)
    R, kvh, d, B, M, P = 3, 2, 64, 8, 8, 30
    q = _t(rs.randn(R, T, kvh * group, d).astype(np.float32))
    kp = _t(rs.randn(P, B, kvh, d).astype(np.float32))
    vp = _t(rs.randn(P, B, kvh, d).astype(np.float32))
    tables = _t(np.stack([rs.permutation(P - 1)[:M] + 1
                          for _ in range(R)]).astype(np.int32))
    lens = _t(np.asarray([0, 11, M * B - T], dtype=np.int32))
    got = ragged_paged_attention(q, kp, vp, tables, lens, window=window)
    want = ragged_paged_attention_plain(q, kp, vp, tables, lens,
                                        window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
