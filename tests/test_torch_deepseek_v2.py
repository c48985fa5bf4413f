"""The port's DeepSeek-V2/V3 (MLA, the MoE router variants, yarn, the V3
MTP depth modules) against the JAX package's, on the same weights (fp32,
CPU; the JAX model built from its seed, its ``state_dict()`` crossing
as numpy through ``load_jax_state_dict``).

- Logits within ``TOL_LOGITS``: V2 with and without ``q_lora_rank``,
  group-limited routing, yarn; a V3 config (sigmoid scores, top-2-sum
  groups, ``norm_topk_prob``, the yarn mscale in the softmax scale) with
  its MTP logits and ``deepseek_mtp_loss``.
- The absorbed decode over the latent cache, step by step at a device
  ``cache_index`` (the graphed step's form), against the JAX decode on
  the same cache: logits within ``TOL_LOGITS``, caches within the same.
  ``kv_b_proj`` is transposed before its heads split; a wrong split
  would move every head's values, far beyond the tolerance.
- Greedy ``generate``, plain and left-padded (``prompt_start``): token
  ids identical to the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.models import deepseek_v2 as jax_ds
from paddle_tpu_torch.models import deepseek_v2 as ds

TOL_LOGITS = 1e-5

YARN = dict(type="yarn", factor=4.0, original_max_position_embeddings=32,
            beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
CONFIGS = {
    "v2": dict(),
    "v2-lite": dict(q_lora_rank=None),
    "group-limited": dict(num_experts=8, n_group=4, topk_group=2),
    "yarn": dict(rope_scaling=YARN, max_position_embeddings=256),
    "v3-mtp": dict(num_experts=8, n_group=4, topk_group=2,
                   scoring="sigmoid", group_score_mode="top2_sum",
                   norm_topk_prob=True, routed_scaling_factor=2.5,
                   yarn_mscale_all_in_scale=True,
                   rope_scaling=dict(YARN, mscale=1.0, mscale_all_dim=1.0),
                   num_nextn_predict_layers=2),
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_pair(case, seed=0, **extra):
    kw = dict(CONFIGS[case], **extra)
    pt.seed(seed)
    jm = jax_ds.DeepseekV2ForCausalLM(jax_ds.deepseek_v2_tiny(**kw))
    jm.eval()
    tm = ds.DeepseekV2ForCausalLM(ds.deepseek_v2_tiny(**kw), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, case):
    if case not in pairs:
        pairs[case] = make_pair(case)
    return pairs[case]


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("case", list(CONFIGS))
def test_logits_match_jax(pairs, case):
    jm, tm = _pair(pairs, case)
    ids = _ids(2, 20, seed=1)
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL_LOGITS, rtol=0)


def test_mtp_logits_and_loss_match_jax(pairs):
    jm, tm = _pair(pairs, "v3-mtp")
    ids = _ids(2, 16, seed=2)
    ref, rmtp = jm(jnp.asarray(ids), return_mtp=True)
    with torch.no_grad():
        got, gmtp = tm(torch.from_numpy(ids), return_mtp=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=TOL_LOGITS, rtol=0)
    assert [m.shape[1] for m in gmtp] == [15, 14]
    for g, r in zip(gmtp, rmtp):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=TOL_LOGITS, rtol=0)
    want = jax_ds.deepseek_mtp_loss(ref, rmtp, jnp.asarray(ids), weight=0.3)
    loss = ds.deepseek_mtp_loss(got, gmtp, torch.from_numpy(ids).long(),
                                weight=0.3)
    np.testing.assert_allclose(float(loss), float(want), atol=TOL_LOGITS,
                               rtol=0)
    with pytest.raises(ValueError, match="no kv cache"):
        tm(torch.from_numpy(ids), kv_caches=tm.init_kv_caches(2, 16),
           return_mtp=True)


@pytest.mark.parametrize("case", ["v2", "v2-lite", "yarn"])
def test_absorbed_decode_matches_jax(case):
    """A 12-token prefill into the latent cache, then 4 decode steps (the
    port's at a device index, one a row), against the JAX package's
    forward over its cache; and the cached logits against the no-cache
    (expanded) forward of the same tokens. Dropless routing (capacity
    factor E / k): each token's experts then do not depend on how many
    tokens a call holds, so the two forwards compute the same function."""
    jm, tm = make_pair(case, capacity_factor=2.0)
    ids = _ids(2, 16, seed=3)
    jc = jm.init_kv_caches(2, 16)
    tc = tm.init_kv_caches(2, 16)
    cfg = tm.config
    assert [tuple(t.shape) for t in tc[0]] == [
        (2, 16, cfg.kv_lora_rank), (2, 16, cfg.qk_rope_head_dim)]
    steps = [(ids[:, :12], 0)] + [(ids[:, t:t + 1], t)
                                  for t in range(12, 16)]
    with torch.no_grad():
        full = tm(torch.from_numpy(ids))
    for chunk, ci in steps:
        ref, jc = jm(jnp.asarray(chunk), kv_caches=jc, cache_index=ci)
        index = ci if ci == 0 else torch.full((2,), ci, dtype=torch.int32)
        with torch.no_grad():
            got, tc = tm(torch.from_numpy(chunk), kv_caches=tc,
                         cache_index=index)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TOL_LOGITS, rtol=0)
        np.testing.assert_allclose(
            got.numpy(), full[:, ci:ci + chunk.shape[1]].numpy(),
            atol=TOL_LOGITS, rtol=0)
    for (rc, rp), (gc, gp) in zip(jc, tc):
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc),
                                   atol=TOL_LOGITS, rtol=0)
        np.testing.assert_allclose(gp.numpy(), np.asarray(rp),
                                   atol=TOL_LOGITS, rtol=0)


@pytest.mark.parametrize("case", ["v2", "group-limited", "v3-mtp"])
def test_greedy_generate_matches_jax(pairs, case):
    jm, tm = _pair(pairs, case)
    ids = _ids(3, 9, seed=4)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=10)))
    got = ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_left_padded_generate_matches_jax(pairs):
    """MLA takes ``attn_start``: each row's pad prefix is masked out of
    the latent cache and its RoPE positions start at its first token."""
    jm, tm = _pair(pairs, "v2")
    ids = _ids(3, 10, seed=5)
    start = np.array([0, 3, 6], np.int32)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=8),
                                  prompt_start=jnp.asarray(start)))
    got = ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=8,
                       prompt_start=torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mla_cache_is_compressed():
    """A token costs kv_lora_rank + rope_d cache entries a layer, against
    2 x heads x head_dim for a (k, v) cache (V2-Lite: 576 against 4096)."""
    cfg = ds.DeepseekV2Config()
    m = ds.DeepseekV2ForCausalLM(
        ds.deepseek_v2_tiny(kv_lora_rank=512, qk_rope_head_dim=64,
                            qk_nope_head_dim=128, v_head_dim=128,
                            q_lora_rank=None, num_attention_heads=16,
                            hidden_size=256, num_hidden_layers=1),
        device="cpu")
    cache = m.init_kv_caches(1, 4)
    per_token = sum(t.shape[-1] for t in cache[0])
    assert per_token == cfg.kv_lora_rank + cfg.qk_rope_head_dim == 576
    assert 2 * 16 * cfg.v_head_dim == 4096
