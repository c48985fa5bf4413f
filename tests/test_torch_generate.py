"""The port's ``generate()``, sampling and ``Predictor`` against the JAX
package's, on the same weights (fp32, CPU).

Greedy streams must be identical token for token. Sampled streams cannot
be: JAX's threefry keys have no torch counterpart. They are held to the
reference through the shared filters (``top_k_filter`` / ``top_p_filter``
masks on the same logits) and to themselves through determinism under
one seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation import sampling as jax_sampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import sampling


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(b, s, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(repetition_penalty=1.3),
    dict(no_repeat_ngram_size=2),
    dict(min_new_tokens=4, eos_token_id=5),
], ids=["greedy", "rep-penalty", "no-repeat-ngram", "min-new-eos"])
def test_greedy_matches_jax(pair, kw):
    jm, tm = pair
    ids = _ids(3, 10, seed=1)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=8, **kw)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(max_new_tokens=8, **kw))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("min_new", [0, 4])
def test_eos_stops_and_pads_like_jax(pair, min_new):
    """An eos taken from the greedy stream itself, so rows finish early
    (or, under min_new_tokens, are kept from finishing) and pad after."""
    jm, tm = pair
    ids = _ids(2, 8, seed=4)
    free = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                   JaxGenConfig(max_new_tokens=10)))
    eos = int(free[0, 8 + 2])
    cfg = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=3,
               min_new_tokens=min_new)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(**cfg)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), ref)
    if not min_new:
        assert (got[0, 8 + 3:] == 3).all()


@pytest.mark.parametrize("kw", [dict(), dict(repetition_penalty=1.5,
                                             no_repeat_ngram_size=2)],
                         ids=["greedy", "processors"])
def test_left_padded_prompt_start_matches_jax(pair, kw):
    """Left-padded rows (``prompt_start``) take the masked dense route in
    both packages, kernels bypassed."""
    jm, tm = pair
    ids = _ids(2, 12, seed=2)
    start = np.array([0, 5], np.int32)
    ids[1, :5] = 0
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=6, **kw),
                                  prompt_start=jnp.asarray(start)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(max_new_tokens=6, **kw),
                       prompt_start=torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_filters_match_jax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(4, 64) * 3).astype(np.float32)
    t = torch.from_numpy(logits)
    for k in (1, 5, 64):
        np.testing.assert_array_equal(
            sampling.top_k_filter(t, k).numpy(),
            np.asarray(jax_sampling.top_k_filter(jnp.asarray(logits), k)))
    for p in (0.1, 0.9, 0.999):
        np.testing.assert_array_equal(
            sampling.top_p_filter(t, p).numpy() > -1e29,
            np.asarray(jax_sampling.top_p_filter(jnp.asarray(logits), p))
            > -1e29)
    seen = rs.rand(4, 64) > 0.5
    np.testing.assert_allclose(
        sampling.repetition_penalty(t, torch.from_numpy(seen), 1.7).numpy(),
        np.asarray(jax_sampling.repetition_penalty(jnp.asarray(logits),
                                                   jnp.asarray(seen), 1.7)),
        rtol=1e-6)


@pytest.mark.parametrize("cur,g", [(9, 2), (9, 0), (3, 4), (12, 3)])
def test_suffix_window_hits_match_jax(cur, g):
    seq = np.array([1, 2, 1, 2, 3, 1, 2, 1, 2, 0, 0, 0, 0, 0], np.int32)
    ref = np.asarray(jax_sampling.suffix_window_hits(jnp.asarray(seq),
                                                     jnp.int32(cur), g))
    got = sampling.suffix_window_hits(torch.from_numpy(seq), cur, g)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampling_is_seeded_and_stays_in_the_filter(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids(2, 8, seed=5))
    cfg = ptt.GenerationConfig(max_new_tokens=6, do_sample=True,
                               temperature=0.8, top_k=4, top_p=0.95)

    def run(seed):
        return ptt.generate(tm, ids, cfg,
                            generator=ptt.make_generator(seed, "cpu"))

    a, b = run(11), run(11)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(12)) or not torch.equal(a, run(13))
    # every sampled token sits in the top-4 of the logits that chose it
    with torch.no_grad():
        logits = tm(a[:, :-1])
    for pos in range(8, 14):
        top = torch.topk(logits[:, pos - 1], 4).indices
        assert (top == a[:, pos:pos + 1]).any(dim=1).all()


def test_predictor_generate_pads_to_bucket_and_crops(pair):
    _, tm = pair
    pred = ptt.Predictor(tm, device="cpu")
    ids = torch.from_numpy(_ids(3, 10, seed=6))
    cfg = ptt.GenerationConfig(max_new_tokens=5)
    got = pred.generate(ids, config=cfg)
    assert got.shape == (3, 15)
    padded = torch.cat([ids, ids[-1:]])                 # bucket 4
    np.testing.assert_array_equal(got.numpy(),
                                  ptt.generate(tm, padded, cfg)[:3].numpy())
    start = torch.tensor([0, 2, 0])
    got = pred.generate(ids, config=cfg, prompt_start=start)
    ref = ptt.generate(tm, padded, cfg,
                       prompt_start=torch.tensor([0, 2, 0, 0]))[:3]
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_predictor_run_crops_bucket_padding(pair):
    _, tm = pair
    pred = ptt.Predictor(tm, ptt.Config().set_batch_buckets([4, 8]),
                         device="cpu")
    ids = _ids(3, 6, seed=7)
    out = pred.run(ids)
    assert out.shape == (3, 6, 256)
    with torch.no_grad():
        ref = tm(torch.from_numpy(ids))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_generate_rejects_bad_configs(pair):
    _, tm = pair
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="repetition_penalty"):
        ptt.generate(tm, ids, repetition_penalty=0.0)
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        ptt.generate(tm, ids, no_repeat_ngram_size=-1)
    # beam search runs since the port's beam_search; as in the JAX
    # package, it refuses left-padded (prompt_start) batches
    with pytest.raises(NotImplementedError, match="beam"):
        ptt.generate(tm, ids, num_beams=2, prompt_start=torch.zeros(1))


# ------------------------------------------- the decode step at a device index
def _host_int_generate(tm, ids, cfg, start=None):
    """The decode loop with its cache index a host int at every step (the
    port's loop before the device-index step), greedy: the reference the
    device-index step is held to bit for bit."""
    from paddle_tpu_torch.generation import _logits_processors
    b, P = ids.shape
    total = P + cfg.max_new_tokens
    vocab = tm.config.vocab_size
    process = _logits_processors(cfg, vocab)
    use_rep = cfg.repetition_penalty != 1.0
    caches = tm.init_kv_caches(b, total)
    with torch.no_grad():
        logits, _ = tm(ids, kv_caches=caches, cache_index=0,
                       attn_start=start)
    tokens = torch.cat([ids.long(), torch.full(
        (b, cfg.max_new_tokens), cfg.pad_token_id, dtype=torch.long)], 1)
    seen = torch.zeros(b, vocab, dtype=torch.bool)
    valid = torch.ones(b, P, dtype=torch.bool) if start is None else \
        torch.arange(P)[None, :] >= start[:, None]
    for r in range(b):
        seen[r, ids[r].long()[valid[r]]] = True
    done = torch.zeros(b, dtype=torch.bool)
    rows = torch.arange(b)
    for cur in range(P, total):
        if cur > P:
            with torch.no_grad():
                logits, _ = tm(tokens[:, cur - 1:cur], kv_caches=caches,
                               cache_index=cur - 1, attn_start=start)
        row = process(logits[:, -1].float(), seen, cur - P, tokens=tokens,
                      cur=cur, row_starts=start)
        nxt = torch.where(done, torch.tensor(cfg.pad_token_id),
                          torch.argmax(row, dim=-1))
        if use_rep:
            seen[rows, nxt] |= ~done
        tokens[:, cur] = nxt
        if cfg.eos_token_id is not None:
            done = done | (nxt == cfg.eos_token_id)
    return tokens


_STEP_CASES = {
    "eos": dict(eos_token_id=None, pad_token_id=3),
    "prompt_start": dict(),
    "rep-penalty": dict(repetition_penalty=1.4),
    "min-new-tokens": dict(min_new_tokens=6, eos_token_id=None),
    "no-repeat-ngram": dict(no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_device_index_step_equals_host_int_step_and_jax(pair, case):
    """``generate``'s decode step reads its cache index on the device
    (the captured step's counterpart on the CPU). Greedy, fp32: its
    tokens equal the host-int loop's and JAX ``generate``'s exactly.
    The eos cases take their eos from the free-running stream, so rows
    finish (or are held back by min_new_tokens) mid-run."""
    jm, tm = pair
    ids = _ids(3, 9, seed=20)
    kw = dict(_STEP_CASES[case])
    start = None
    if case == "prompt_start":
        start = np.array([0, 4, 2], np.int32)
        ids[1, :4] = 0
        ids[2, :2] = 0
    if "eos_token_id" in kw:
        free = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                       JaxGenConfig(max_new_tokens=12)))
        kw["eos_token_id"] = int(free[0, 9 + 3])
    jcfg = JaxGenConfig(max_new_tokens=12, **kw)
    ref = np.asarray(jax_generate(
        jm, jnp.asarray(ids), jcfg,
        prompt_start=None if start is None else jnp.asarray(start)))
    cfg = ptt.GenerationConfig(max_new_tokens=12, **kw)
    tstart = None if start is None else torch.from_numpy(start).long()
    got = ptt.generate(tm, torch.from_numpy(ids), cfg, prompt_start=tstart)
    host = _host_int_generate(tm, torch.from_numpy(ids), cfg, tstart)
    np.testing.assert_array_equal(got.numpy(), host.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)


def test_executable_cache_reused_across_calls(pair):
    """One program (buffers and step) per (batch, total, processor set),
    reused by the next call with other prompts of the same shape; the
    cache hangs off the model, so dropping the model frees it (a plain
    cycle the gc collects), as the JAX package's cache does."""
    import gc
    import weakref
    jm, _ = pair
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    cfg = ptt.GenerationConfig(max_new_tokens=6, repetition_penalty=1.2)
    a = ptt.generate(tm, torch.from_numpy(_ids(2, 7, seed=21)), cfg)
    cache = tm._gen_exec_cache
    assert len(cache.programs) == 1
    ids = _ids(2, 7, seed=22)
    b = ptt.generate(tm, torch.from_numpy(ids), cfg)
    assert len(cache.programs) == 1            # no new entry
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids), JaxGenConfig(
        max_new_tokens=6, repetition_penalty=1.2)))
    np.testing.assert_array_equal(b.numpy(), ref)
    assert not torch.equal(a, b)
    # another total is another program; the same shape again reuses
    ptt.generate(tm, torch.from_numpy(ids), cfg, max_new_tokens=4)
    assert len(cache.programs) == 2
    wr = weakref.ref(tm)
    del tm, cache, a, b
    gc.collect()
    assert wr() is None


def test_exec_cache_drops_programs_when_weights_move(pair):
    """New weights (a parameter replaced, as quantizing in place does)
    drop the programs a graph froze the old addresses in."""
    _, tm = pair
    cfg = ptt.GenerationConfig(max_new_tokens=3)
    ids = torch.from_numpy(_ids(1, 5, seed=23))
    ptt.generate(tm, ids, cfg)
    prog = next(iter(tm._gen_exec_cache.programs.values()))
    w = tm.model.norm.weight
    tm.model.norm.weight = torch.nn.Parameter(w.detach().clone())
    try:
        ptt.generate(tm, ids, cfg)
        assert next(iter(tm._gen_exec_cache.programs.values())) is not prog
    finally:
        tm.model.norm.weight = w


def test_exec_cache_keeps_resident_buffers_under_budget(pair, monkeypatch):
    """Past the budget of resident buffer bytes the least recently used
    programs go; the newest always stays."""
    from paddle_tpu_torch.generation import graphs
    _, tm = pair
    cache = graphs.ExecCache(tm, budget_bytes=1)
    monkeypatch.setattr(tm, "_gen_exec_cache", cache, raising=False)
    ids = torch.from_numpy(_ids(1, 5, seed=24))
    for new in (2, 3, 4):
        ptt.generate(tm, ids, max_new_tokens=new)
    assert len(cache.programs) == 1
    assert next(iter(cache.programs))[2] == 5 + 4


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_at_a_device_index_equals_host_int(per_row, window):
    """The decode kernel's plain version (the CPU route) at a tensor
    cache index, one for all rows or one a row, equals the host-int call
    row by row, bit for bit (fp32)."""
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention_fwd
    rs = np.random.RandomState(25)
    b, T, h, kv, d = 3, 40, 8, 2, 64
    q = torch.from_numpy(rs.randn(b, h, d).astype(np.float32))
    ck = torch.from_numpy(rs.randn(b, T, kv, d).astype(np.float32))
    cv = torch.from_numpy(rs.randn(b, T, kv, d).astype(np.float32))
    idx = [0, 17, 39] if per_row else [23, 23, 23]
    ci = torch.tensor(idx if per_row else idx[:1], dtype=torch.int32)
    got = decode_attention_fwd(q, ck, cv, ci if per_row else ci[0],
                               window=window)
    for r in range(b):
        want = decode_attention_fwd(q[r:r + 1], ck[r:r + 1], cv[r:r + 1],
                                    idx[r], window=window)
        assert torch.equal(got[r:r + 1], want)


def test_model_step_at_per_row_indices_equals_each_row_alone(pair):
    """The model's static-cache step at a per-row device index (the
    speculative loops' cursors): each row's logits and cache writes equal
    that row's own host-int step (fp32, within 1e-5: a batch of 3 rows
    sums its matmuls in another order than one row)."""
    _, tm = pair
    rs = np.random.RandomState(26)
    b, T = 3, 16
    caches = tm.init_kv_caches(b, T)
    for ck, cv in caches:
        ck.copy_(torch.from_numpy(rs.randn(*ck.shape).astype(np.float32)))
        cv.copy_(torch.from_numpy(rs.randn(*cv.shape).astype(np.float32)))
    ref_caches = [(ck.clone(), cv.clone()) for ck, cv in caches]
    idx = [3, 9, 14]
    for s in (1, 2):
        ids = torch.from_numpy(rs.randint(0, 256, (b, s)))
        with torch.no_grad():
            got, _ = tm(ids, kv_caches=caches,
                        cache_index=torch.tensor(idx, dtype=torch.int32))
        for r in range(b):
            one = [(ck[r:r + 1], cv[r:r + 1]) for ck, cv in ref_caches]
            with torch.no_grad():
                want, _ = tm(ids[r:r + 1], kv_caches=one,
                             cache_index=idx[r])
            torch.testing.assert_close(got[r:r + 1], want, atol=1e-5,
                                       rtol=0)
        for (ck, cv), (rk, rv) in zip(caches, ref_caches):
            torch.testing.assert_close(ck, rk, atol=1e-5, rtol=0)
            torch.testing.assert_close(cv, rv, atol=1e-5, rtol=0)


def test_kernel_workspace_grows_to_the_largest_ask_and_captures_keep_it():
    """Asks whose needs alternate (more floats, then more counters, as a
    layer's quantized projections make them) share one workspace pair
    once it has grown to the largest of each: none is replaced at every
    call, so a CUDA-graph capture after a warm-up allocates none. Inside
    ``keeping_workspaces`` each pair handed out is recorded once."""
    from paddle_tpu_torch.ops import kernels
    dev = torch.device("cpu", 0)
    name = "test_workspace"
    try:
        first = kernels.workspace(name, dev, 100, 2)
        grown = kernels.workspace(name, dev, 10, 8)
        assert (grown[0].numel(), grown[1].numel()) == (100, 8)
        assert not grown[1].any()
        with kernels.keeping_workspaces() as kept:
            for floats, counters in [(100, 2), (10, 8), (64, 4)] * 3:
                pair = kernels.workspace(name, dev, floats, counters)
                assert pair[0] is grown[0] and pair[1] is grown[1]
        assert list(kept.values()) == [grown]
        assert first[0] is not grown[0]
        # outside the block nothing is recorded
        kernels.workspace(name, dev, 1, 1)
        assert len(kept) == 1
    finally:
        kernels._workspaces.pop((name, 0), None)
