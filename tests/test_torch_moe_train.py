"""The MoE families' backward against ``jax.grad``, in one process on the
CPU (fp32; the JAX model built from its seed, its ``state_dict()``
crossing as numpy through ``load_jax_state_dict``): every parameter's
gradient of the training objective the JAX package's users train with
(``moe_lm_loss`` for Qwen2-MoE, DeepSeek-MoE and ERNIE-4.5-MoE,
``deepseek_mtp_loss`` for DeepSeek-V2 with an MTP module), within
``TOL``. The cases reach every part of the layer's backward: the index
dispatch (the buckets' gather), the gather combine, the gates (softmax
and V3's sigmoid with ``norm_topk_prob``, group-limited selection), the
shared experts and their sigmoid gate, an ``expert_bias`` that changes
the selection, and a capacity that drops tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import deepseek_v2 as jax_ds
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.models import qwen2_moe as jax_qwen
from paddle_tpu_torch import models
from paddle_tpu_torch.models import deepseek_v2 as ds
from paddle_tpu_torch.parallel.moe import MoEMLP, _route

# fp32 gradients of one function summed in another order (the combine
# gathers where the JAX layer multiplies one-hot tensors)
TOL = dict(rtol=1e-5, atol=1e-5)

FAMILIES = {
    "qwen2-moe": (jax_qwen.Qwen2MoeForCausalLM, jax_qwen.qwen2_moe_tiny,
                  models.Qwen2MoeForCausalLM, models.qwen2_moe_tiny,
                  dict(shared_expert_gate=True)),
    "deepseek-moe": (jax_qwen.Qwen2MoeForCausalLM,
                     jax_qwen.deepseek_moe_tiny, models.Qwen2MoeForCausalLM,
                     models.deepseek_moe_tiny, dict()),
    "ernie45-moe": (jax_ernie.Ernie45MoeForCausalLM,
                    jax_ernie.ernie45_moe_tiny, models.Ernie45MoeForCausalLM,
                    models.ernie45_moe_tiny, dict(norm_topk_prob=True)),
    "deepseek-v2-mtp": (jax_ds.DeepseekV2ForCausalLM,
                        jax_ds.deepseek_v2_tiny, ds.DeepseekV2ForCausalLM,
                        ds.deepseek_v2_tiny,
                        dict(num_experts=8, n_group=4, topk_group=2,
                             scoring="sigmoid", group_score_mode="top2_sum",
                             norm_topk_prob=True, routed_scaling_factor=2.5,
                             num_nextn_predict_layers=1)),
}
# the routing variants each family runs under: the defaults (which drop
# some choices already), and a selection moved by ``expert_bias`` at a
# capacity that drops many
VARIANTS = {"plain": dict(), "bias_drops": dict(capacity_factor=0.5)}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bias(E):
    """A loss-free-balancing bias large enough to move the selection."""
    return np.linspace(-0.3, 0.3, E).astype(np.float32)[::-1].copy()


def _pair(family, variant):
    jcls, jcfg, tcls, tcfg, kw = FAMILIES[family]
    kw = dict(kw, **VARIANTS[variant])
    pt.seed(0)
    jm = jcls(jcfg(**kw))
    if variant == "bias_drops":
        for layer in jm.model.layers:
            if type(layer.mlp).__name__ == "MoEMLP":
                E = layer.mlp.num_experts
                layer.mlp._buffers["expert_bias"] = jnp.asarray(_bias(E))
    tm = tcls(tcfg(**kw), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _objective(family):
    """(jax loss of (fn, params, ids), port loss of (model, ids))."""
    if family == "deepseek-v2-mtp":
        def jloss(fn, p, ids):
            logits, mtp = fn(p, ids, return_mtp=True)
            return jax_ds.deepseek_mtp_loss(logits, mtp, ids, weight=0.1)

        def tloss(m, ids):
            logits, mtp = m(ids, return_mtp=True)
            return ds.deepseek_mtp_loss(logits, mtp, ids, weight=0.1)
        return jloss, tloss

    def jloss(fn, p, ids):
        logits, aux = fn(p, ids, return_aux=True)
        return jax_qwen.moe_lm_loss(logits, aux, ids)

    def tloss(m, ids):
        logits, aux = m(ids, return_aux=True)
        return models.moe_lm_loss(logits, aux, ids)
    return jloss, tloss


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, ptt.nn.Linear)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_gradient_matches_jax_grad(family, variant):
    jm, tm = _pair(family, variant)
    ids = np.random.RandomState(1).randint(1, 256, (2, 16)).astype(np.int32)
    jloss, tloss = _objective(family)
    fn, params = jm.functional()
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jloss(fn, p, jnp.asarray(ids))))(dict(params))
    named = dict(tm.named_parameters())
    loss = tloss(tm, torch.from_numpy(ids).long())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6,
                               atol=0)
    lin = _linear_names(tm)
    assert set(named) <= set(want)
    for (k, _), g in zip(named.items(), grads):
        g = g.numpy()
        np.testing.assert_allclose(g.T if k in lin else g,
                                   np.asarray(want[k]), **TOL, err_msg=k)
    # every MoE parameter got a gradient: experts, router, shared
    moe = [k for k in named if ".mlp." in k and "layers.0." not in k]
    assert moe and all(np.abs(grads[list(named).index(k)].numpy()).max()
                       > 0 for k in moe if "expert_bias" not in k)


def _routing_of(tm, ids):
    """Every MoE layer's (kept [T, k], experts [T, k]) on this input."""
    got = []

    def hook(mod, args):
        x = args[0].reshape(-1, mod.hidden_size)
        logits = x.float() @ mod.gate.float()
        ids_, _, keep, _, _ = _route(
            logits, mod.top_k, mod.capacity(x.shape[0]),
            bias=mod.expert_bias, norm_topk_prob=mod.norm_topk_prob,
            n_group=mod.n_group, topk_group=mod.topk_group,
            scoring=mod.scoring, group_score_mode=mod.group_score_mode)
        got.append((keep, ids_))
    hs = [m.register_forward_pre_hook(hook) for m in tm.modules()
          if isinstance(m, MoEMLP)]
    with torch.no_grad():
        tm(torch.from_numpy(ids).long())
    for h in hs:
        h.remove()
    return got


@pytest.mark.parametrize("family", ["qwen2-moe", "deepseek-v2-mtp"])
def test_variants_reach_what_they_name(family):
    """The cases above do what their names say: the defaults drop some
    choices, the bias moves some token's experts, and the small capacity
    drops more choices than the default's."""
    ids = np.random.RandomState(1).randint(1, 256, (2, 16)).astype(np.int32)
    plain = _routing_of(_pair(family, "plain")[1], ids)
    moved = _routing_of(_pair(family, "bias_drops")[1], ids)
    assert any(not torch.equal(a[1], b[1]) for a, b in zip(plain, moved))
    dropped = [sum(int((~k).sum()) for k, _ in r) for r in (plain, moved)]
    assert dropped[0] > 0 and dropped[1] > dropped[0]
