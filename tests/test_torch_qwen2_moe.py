"""The port's Qwen2 (dense), Qwen2-MoE, DeepSeek-MoE and ERNIE-4.5-MoE
against the JAX package's, on the same weights (the JAX model built from
its seed, its ``state_dict()`` crossing as numpy through
``load_jax_state_dict``), fp32 on the CPU.

- Logits within ``TOL_LOGITS`` and the summed aux loss within
  ``TOL_AUX`` (absolute; the same math summed in another order).
- Greedy ``generate``, beam search and ``ngram_speculative_generate``:
  token ids identical to the JAX package's (with its stats).
- ``Predictor``: ``run`` pads the batch to its bucket with the last row,
  as the JAX ``Predictor.run`` does (the padding rows route too, so the
  logits equal the JAX ones only with the same padding), and
  ``generate`` runs an MoE model at the caller's batch, as the JAX
  ``Predictor.generate`` does; ``from_checkpoint`` on a file the JAX
  package wrote, and the JAX package on a file the port wrote;
  ``BatchingPredictor``'s answers are rows of its batches.
- What the JAX package cannot do raises: a left-padded ``generate``
  (``attn_start``) is a ``TypeError`` in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.checkpoint import save as jax_save
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import beam_search as jax_beam_search
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation import ngram_speculative_generate as jax_ngram
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.models import qwen2 as jax_qwen2
from paddle_tpu.models import qwen2_moe as jax_qwen2_moe
from paddle_tpu_torch import models
from paddle_tpu_torch.generation import ngram_speculative_generate

TOL_LOGITS = 1e-5
TOL_AUX = 1e-6

FAMILIES = {
    "qwen2-moe": (jax_qwen2_moe.Qwen2MoeForCausalLM,
                  jax_qwen2_moe.qwen2_moe_tiny, models.Qwen2MoeForCausalLM,
                  models.qwen2_moe_tiny, dict()),
    "qwen2-moe-gated": (jax_qwen2_moe.Qwen2MoeForCausalLM,
                        jax_qwen2_moe.qwen2_moe_tiny,
                        models.Qwen2MoeForCausalLM, models.qwen2_moe_tiny,
                        dict(shared_expert_gate=True, norm_topk_prob=True,
                             num_experts=8, num_experts_per_tok=3)),
    "deepseek-moe": (jax_qwen2_moe.Qwen2MoeForCausalLM,
                     jax_qwen2_moe.deepseek_moe_tiny,
                     models.Qwen2MoeForCausalLM, models.deepseek_moe_tiny,
                     dict()),
    "ernie45-moe": (jax_ernie.Ernie45MoeForCausalLM,
                    jax_ernie.ernie45_moe_tiny,
                    models.Ernie45MoeForCausalLM, models.ernie45_moe_tiny,
                    dict()),
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_pair(family, head_scale=1.0, seed=0, **extra):
    jcls, jcfg, tcls, tcfg, kw = FAMILIES[family]
    kw = dict(kw, **extra)
    pt.seed(seed)
    jm = jcls(jcfg(**kw))
    jm.eval()
    if head_scale != 1.0:
        # decisive logits, as the JAX speculative tests have them
        jm.lm_head.weight = jm.lm_head.weight * head_scale
    tm = tcls(tcfg(**kw), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {f: make_pair(f) for f in FAMILIES}


def _ids(b, s, seed, vocab=256):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_aux_match_jax(pairs, family):
    jm, tm = pairs[family]
    ids = _ids(2, 24, seed=1)
    ref, raux = jm(jnp.asarray(ids), return_aux=True)
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(ids), return_aux=True)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=TOL_LOGITS, rtol=0)
    np.testing.assert_allclose(float(aux), float(raux), atol=TOL_AUX, rtol=0)
    # the loss of the JAX recipe on the same logits
    labels = torch.from_numpy(ids).long()
    want = jax_qwen2_moe.moe_lm_loss(ref, raux, jnp.asarray(ids))
    np.testing.assert_allclose(
        float(models.moe_lm_loss(got, aux, labels)), float(want),
        atol=TOL_LOGITS, rtol=0)


def test_first_k_dense_layers_stay_dense(pairs):
    _, tm = pairs["deepseek-moe"]
    from paddle_tpu_torch.parallel.moe import MoEMLP
    assert tm.model.layers[0].is_dense
    assert not isinstance(tm.model.layers[0].mlp, MoEMLP)
    assert isinstance(tm.model.layers[1].mlp, MoEMLP)
    assert not tm.rows_independent


def test_qwen2_dense_matches_jax():
    pt.seed(0)
    jm = jax_qwen2.Qwen2ForCausalLM(jax_qwen2.qwen2_tiny())
    jm.eval()
    tm = models.Qwen2ForCausalLM(models.qwen2_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    assert tm.config.attention_bias and tm.rows_independent
    ids = _ids(2, 16, seed=2)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               atol=TOL_LOGITS, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_generate_matches_jax(pairs, family):
    jm, tm = pairs[family]
    ids = _ids(3, 9, seed=3)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=10)))
    got = ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_beam_search_matches_jax(pairs):
    jm, tm = pairs["ernie45-moe"]
    ids = _ids(2, 7, seed=4)
    cfg = dict(max_new_tokens=6, num_beams=3)
    ref = np.asarray(jax_beam_search(jm, jnp.asarray(ids),
                                     JaxGenConfig(**cfg)))
    got = ptt.generate(tm, torch.from_numpy(ids), **cfg)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("b", [1, 2])
def test_ngram_speculative_matches_jax(b):
    """The JAX package vmaps a one-row loop over the rows, so each row
    is routed as a batch of one; the port decodes an MoE model's rows one
    at a time, with the same streams and stats."""
    jm, tm = make_pair("qwen2-moe", head_scale=10.0)
    pattern = _ids(1, 6, seed=5)
    ids = np.concatenate([np.tile(pattern, (b, 3)), _ids(b, 2, seed=6)], 1)
    ref, rstats = jax_ngram(jm, jnp.asarray(ids), max_new_tokens=12,
                            num_draft_tokens=3, return_stats=True)
    got, stats = ngram_speculative_generate(
        tm, torch.from_numpy(ids), max_new_tokens=12, num_draft_tokens=3,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert stats == rstats


def test_predictor_pads_run_and_not_generate_like_jax(pairs):
    jm, tm = pairs["qwen2-moe"]
    ids = _ids(3, 10, seed=7)
    jp = JaxPredictor(jm)
    tp = ptt.Predictor(tm, device="cpu")
    # run: bucket 4, the last row repeated and cropped, in both
    ref = np.asarray(jp.run(jnp.asarray(ids)))
    got = tp.run(torch.from_numpy(ids))
    assert got.shape == (3, 10, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL_LOGITS, rtol=0)
    # a forward that returns (logits, aux): its outputs are cropped as a
    # tree, as the JAX run's tree.map crops them
    class WithAux(models.Qwen2MoeForCausalLM):
        def forward(self, input_ids):
            return super().forward(input_ids, return_aux=True)
    wa = WithAux(models.qwen2_moe_tiny(), device="cpu")
    wa.load_state_dict(tm.state_dict())
    logits, aux = ptt.Predictor(wa, device="cpu").run(torch.from_numpy(ids))
    assert torch.equal(logits, got) and aux.dim() == 0
    # generate: the caller's batch of 3, in both
    ref = np.asarray(jp.generate(jnp.asarray(ids), max_new_tokens=6))
    got = tp.generate(torch.from_numpy(ids), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert any(k[1] == 3 for k in tm._gen_exec_cache.programs)


def test_predictor_casts_expert_bias_with_the_weights():
    """``Config.set_dtype`` casts the persistent buffers (the selection
    bias) with the parameters, as the JAX ``Layer.to`` does; the RoPE
    frequencies stay fp32."""
    _, tm = make_pair("ernie45-moe")
    pred = ptt.Predictor(tm, ptt.Config().set_dtype("bfloat16"),
                         device="cpu")
    mlp = pred.model.model.layers[1].mlp
    assert mlp.expert_bias.dtype == mlp.w_up.dtype == torch.bfloat16
    assert pred.model.model.rope_inv_freq.dtype == torch.float32


def test_predictor_from_a_jax_checkpoint(pairs, tmp_path):
    jm, tm = pairs["deepseek-moe"]
    path = str(tmp_path / "moe.ckpt")
    jax_save(jm.state_dict(), path)
    pred = ptt.Predictor.from_checkpoint(
        lambda: models.Qwen2MoeForCausalLM(models.deepseek_moe_tiny(),
                                           device="cpu"), path,
        device="cpu")
    ids = _ids(2, 8, seed=8)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids))
    assert torch.equal(pred.run(torch.from_numpy(ids)), want)


def test_port_checkpoint_loads_in_jax(pairs, tmp_path):
    """``checkpoint.save`` of the port's MoE weights (the JAX layout
    through ``jax_state_dict``) loads into the JAX model: the same
    logits."""
    from paddle_tpu.checkpoint import load as jax_load
    from paddle_tpu_torch.convert import jax_state_dict
    _, tm = pairs["ernie45-moe"]
    path = str(tmp_path / "port.ckpt")
    ptt.save(jax_state_dict(tm), path)
    pt.seed(5)
    jm = jax_ernie.Ernie45MoeForCausalLM(jax_ernie.ernie45_moe_tiny())
    jm.set_state_dict(jax_load(path))
    ids = _ids(2, 8, seed=10)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               atol=TOL_LOGITS, rtol=0)


def test_batching_predictor_answers_rows_of_its_batches(pairs):
    """Concurrent single requests coalesce into bucketed ``run`` calls,
    padded as the JAX ``Predictor.run`` pads: each answer is its row of
    the same stacked batch through ``Predictor.run`` (routing depends on
    the batch, so a row alone would differ)."""
    _, tm = pairs["qwen2-moe"]
    bp = ptt.BatchingPredictor(tm, max_batch=4, max_delay_ms=20,
                               device="cpu")
    seen = []
    orig = bp.predictor.run

    def record(ids):
        seen.append(np.array(ids))
        return orig(ids)
    bp.predictor.run = record
    try:
        xs = [_ids(1, 9, seed=20 + i)[0] for i in range(6)]
        futs = [bp.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        bp.close()
    assert sum(len(b) for b in seen) == 6 and len(seen) < 6
    ref = {}
    for batch in seen:
        for row, ids in zip(orig(batch), batch):
            ref[tuple(ids)] = row
    for x, out in zip(xs, outs):
        assert torch.equal(out, ref[tuple(x)])


def test_left_padded_generate_raises_as_in_jax(pairs):
    jm, tm = pairs["qwen2-moe"]
    ids = _ids(2, 6, seed=9)
    start = np.array([0, 2], np.int32)
    with pytest.raises(TypeError, match="attn_start"):
        jax_generate(jm, jnp.asarray(ids), JaxGenConfig(max_new_tokens=2),
                     prompt_start=jnp.asarray(start))
    with pytest.raises(TypeError, match="attn_start"):
        ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=2,
                     prompt_start=torch.from_numpy(start))


def test_pipeline_functional_raises(pairs):
    _, tm = pairs["qwen2-moe"]
    with pytest.raises(NotImplementedError, match="multi-device"):
        tm.pipeline_functional(2)


def test_ernie45_defaults_are_21b_a3b():
    """The dataclass defaults: ERNIE-4.5-21B-A3B's widths (the shared FFN
    1536 wide, as the JAX dataclass has it)."""
    cfg = models.Ernie45MoeConfig()
    ref = jax_ernie.Ernie45MoeConfig()
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "moe_intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "num_experts",
              "num_experts_per_tok", "num_shared_experts",
              "shared_expert_intermediate_size", "first_k_dense_replace",
              "rope_theta", "rms_norm_eps", "capacity_factor"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.dtype == torch.bfloat16
