"""The port's Llama against the JAX package's, on the same weights.

The JAX model is built from its seed, its ``state_dict()`` crosses as
numpy through ``load_jax_state_dict``, and both run fp32 on the CPU. The
JAX side runs with Pallas interpret mode off (its dense paths); the port
routes the same shapes through its kernels' plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.generation.paged import PagedKV as JaxPagedKV
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation.paged import PagedKV

# fp32 logits: same math, summed in another order by XLA and torch
ATOL_LOGITS = 1e-4

HEAD_DIM_64 = dict(hidden_size=256, intermediate_size=256,
                   num_attention_heads=4, num_key_value_heads=2,
                   vocab_size=512, max_position_embeddings=512)
LLAMA3_SCALING = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0,
                      original_max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(**overrides):
    jm = JaxLlama(jax_llama_tiny(**overrides))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**overrides), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(b, s, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("overrides,seq", [
    (dict(), 16),
    (HEAD_DIM_64, 128),                                  # flash route
    (dict(HEAD_DIM_64, rope_scaling=LLAMA3_SCALING), 128),
    (dict(rope_scaling=dict(rope_type="linear", factor=2.0)), 16),
    (dict(rope_scaling=dict(rope_type="yarn", factor=4.0,
                            original_max_position_embeddings=32)), 16),
    (dict(HEAD_DIM_64, sliding_window=48, max_window_layers=1), 128),
    (dict(tie_word_embeddings=True, attention_bias=True), 16),
], ids=["tiny", "d64-flash", "d64-llama3-rope", "linear-rope", "yarn-rope",
        "d64-window", "tied-bias"])
def test_logits_match_jax(overrides, seq):
    jm, tm = _pair(**overrides)
    ids = _ids(2, seq, jm.config.vocab_size)
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_LOGITS, rtol=0)


def test_segment_ids_logits_match_jax():
    """Packed sequences: the port's flash route with segment ids vs the
    JAX dense segment-masked route."""
    jm, tm = _pair(**HEAD_DIM_64)
    ids = _ids(2, 128, jm.config.vocab_size, seed=1)
    seg = np.ones((2, 128), np.int32)
    seg[:, 50:] = 2
    seg[1, 120:] = 0
    ref = np.asarray(jm(jnp.asarray(ids), segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("overrides,prompt", [(dict(), 8),
                                              (HEAD_DIM_64, 128)],
                         ids=["tiny-dense-prefill", "d64-flash-prefill"])
def test_kv_cache_prefill_and_decode_match_jax(overrides, prompt):
    """Prefill at cache start, then two single-token decode steps: logits
    and the cache contents match the JAX package, and the port's cache
    is the tensor it was given (updated in place)."""
    jm, tm = _pair(**overrides)
    ids = _ids(2, prompt + 2, jm.config.vocab_size, seed=2)
    total = prompt + 4
    jc = jm.init_kv_caches(2, total)
    tc = tm.init_kv_caches(2, total)
    first_k = tc[0][0]
    steps = [(ids[:, :prompt], 0), (ids[:, prompt:prompt + 1], prompt),
             (ids[:, prompt + 1:prompt + 2], prompt + 1)]
    for chunk, ci in steps:
        ref, jc = jm(jnp.asarray(chunk), kv_caches=jc, cache_index=ci)
        with torch.no_grad():
            got, tc = tm(torch.from_numpy(chunk), kv_caches=tc,
                         cache_index=ci)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL_LOGITS, rtol=0)
    assert tc[0][0] is first_k
    np.testing.assert_allclose(tc[1][1].numpy(), np.asarray(jc[1][1]),
                               atol=1e-5, rtol=0)


def test_load_jax_state_dict_is_strict():
    jm, tm = _pair()
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    missing = dict(params)
    missing.pop("model.norm.weight")
    with pytest.raises(KeyError, match="missing=.*model.norm.weight"):
        ptt.load_jax_state_dict(tm, missing)
    with pytest.raises(KeyError, match="unexpected=.*extra"):
        ptt.load_jax_state_dict(tm, dict(params, extra=np.zeros(1)))
    bad = dict(params)
    bad["lm_head.weight"] = bad["lm_head.weight"].T     # torch layout
    with pytest.raises(ValueError, match="lm_head.weight"):
        ptt.load_jax_state_dict(tm, bad)


def test_later_slices_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="multi-device"):
        ptt.LlamaForCausalLM(ptt.llama_tiny(sequence_parallel=True),
                             device="cpu")
    # recompute is ported (the training slice): same logits as without
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(recompute=True), device="cpu")
    ref = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    assert torch.equal(tm(ids), ref(ids))
    with pytest.raises(NotImplementedError, match="pipeline"):
        tm.pipeline_functional(2)


@pytest.mark.parametrize("overrides", [dict(), dict(sliding_window=6)],
                         ids=["tiny", "window"])
def test_paged_branch_logits_match_jax(overrides):
    """The paged attention branch (the engine's three calls): a
    whole-prompt prefill over a padded bucket, two prompt chunks
    (``paged_chunk``) and a two-row decode step; logits at the live
    positions match the JAX package's, and the port writes its pools in
    place."""
    jm, tm = _pair(**overrides)
    cfg = tm.config
    P, B, M = 12, 4, 6
    shape = (P, B, cfg.num_key_value_heads, cfg.head_dim)
    ids = _ids(2, 16, cfg.vocab_size, seed=3)
    tables = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0]], np.int32)

    def both(tokens, positions, rows, lens, **kw):
        jc = [JaxPagedKV(a, b, jnp.asarray(tables[rows]), jnp.asarray(lens))
              for a, b in jpools]
        ref, new = jm(jnp.asarray(tokens), positions=jnp.asarray(positions),
                      kv_caches=jc, **kw)
        jpools[:] = [(c.kp, c.vp) for c in new]
        tc = [PagedKV(a, b, torch.from_numpy(tables[rows]),
                      torch.from_numpy(lens)) for a, b in tpools]
        with torch.no_grad():
            got, caches = tm(torch.from_numpy(tokens),
                             positions=torch.from_numpy(positions),
                             kv_caches=tc, **kw)
        assert caches[0].kp is tpools[0][0]
        return np.asarray(ref), got.numpy()

    jpools = [(jnp.zeros(shape), jnp.zeros(shape))
              for _ in range(cfg.num_hidden_layers)]
    tpools = [(torch.zeros(shape), torch.zeros(shape))
              for _ in range(cfg.num_hidden_layers)]
    # row 0: whole prompt of 9 tokens in a 16-token bucket
    padded = ids[:1].copy()
    padded[0, 9:] = 0
    ref, got = both(padded, np.arange(16)[None].astype(np.int32), [0],
                    np.array([9], np.int32))
    np.testing.assert_allclose(got[:, :9], ref[:, :9], atol=ATOL_LOGITS,
                               rtol=0)
    # row 1: 13 prompt tokens in two chunks of 8
    for start in (0, 8):
        chunk = ids[1:, start:start + 8].copy()
        live = min(8, 13 - start)
        chunk[0, live:] = 0
        ref, got = both(chunk, (start + np.arange(8))[None].astype(np.int32),
                        [1], np.array([start + live], np.int32),
                        paged_chunk=True)
        np.testing.assert_allclose(got[:, :live], ref[:, :live],
                                   atol=ATOL_LOGITS, rtol=0)
    # one decode step for both rows (the ragged kernel's plain version)
    lens = np.array([9, 13], np.int32)
    ref, got = both(ids[:, 14:15], lens[:, None], [0, 1], lens)
    np.testing.assert_allclose(got, ref, atol=ATOL_LOGITS, rtol=0)
