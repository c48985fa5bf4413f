"""The port's QAT and PTQ (``paddle_tpu_torch.quant.qat``, ``.ptq``)
against the JAX package's, on the CPU in fp32.

Every case of ``TestQAT`` and ``TestPTQ`` in the JAX package's
``tests/test_quant.py`` has its counterpart, held against the JAX
function on the same numpy inputs: ``fake_quant``'s values and its
straight-through gradient against ``jax.grad``, ``FakeQuantLinear``'s
gradients (the port's weight is [out, in], so its per-channel scale
reduces dim 1 where the JAX one reduces dim 0), the zero guard; the
observers' scales after calibration, the converted layers and their
outputs, the refusal to convert uncalibrated, the observer's max and
EMA, ``skip``; then a Llama wide enough for the 128-row scale blocks
(hidden 256), calibrated and converted in both packages, whose observer
scales and logits must agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu import quant as jquant
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.quant import (PTQ, AbsMaxObserver, FakeQuantLinear,
                                    QuantizedLinear, W8A8Linear, fake_quant)

# fp32 values: the same products and sums, in another order
ATOL_FP32 = 1e-6
# gradients of a small MSE through one layer
RTOL_GRAD = 1e-5
# observer scales: a max over the same fp32 activations of a model whose
# forward sums in another order
RTOL_SCALE = 1e-5
# converted outputs: the same int8 codes (the same scales) times the same
# fake-quantized activations; an activation within rounding of a half
# step can round to the other code, hence a bound of a few codes' worth
ATOL_W8A8_MLP = 1e-4
ATOL_W8A8_LOGITS = 2e-3
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _cpu():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().float().cpu().numpy()


# ----------------------------------------------------------------- QAT
@pytest.mark.parametrize("bits", (8, 4))
def test_fake_quant_values_and_ste_gradient_as_jax(bits):
    """Per tensor and per row: the values equal JAX's, and the gradient
    of sum(fake_quant(x)^2) is ``jax.grad``'s (the straight-through
    estimator: 2 q(x))."""
    rs = np.random.RandomState(bits)
    x = rs.randn(8, 32).astype(np.float32)
    for axis in (None, 1):
        xt = torch.from_numpy(x).requires_grad_()
        y = fake_quant(xt, bits, axis=axis)
        (g,) = torch.autograd.grad((y ** 2).sum(), xt)
        jy = jquant.fake_quant(jnp.asarray(x), bits, axis=axis)
        jg = jax.grad(lambda v: jnp.sum(
            jquant.fake_quant(v, bits, axis=axis) ** 2))(jnp.asarray(x))
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL_FP32)
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=ATOL_FP32)
        np.testing.assert_allclose(_np(g), 2 * _np(y), atol=ATOL_FP32)
    # the JAX test's input: a finite, nonzero gradient
    v = torch.linspace(-1, 1, 32).requires_grad_()
    (g,) = torch.autograd.grad((fake_quant(v, bits) ** 2).sum(), v)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_fake_quant_linear_gradients_as_jax():
    """``FakeQuantLinear`` over a 16 -> 4 Linear: the output and the
    gradients of an MSE with respect to the weight and bias equal JAX's
    (the weight's transposed), and the weight's is nonzero."""
    pt.seed(0)
    jl = jnn.Linear(16, 4)
    jfq = jquant.FakeQuantLinear(jl, bits=8)
    tl = Linear(16, 4, generator=ptt.make_generator(0, "cpu"), device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight).T.copy()))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias).copy()))
    fq = FakeQuantLinear(tl, bits=8)
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    y = np.ones((8, 4), np.float32)
    fn, params = jfq.functional()
    jg = jax.grad(lambda p: jnp.mean((fn(p, jnp.asarray(x)) - y) ** 2))(
        params)
    out = fq(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    gw, gb = torch.autograd.grad(loss, [tl.weight, tl.bias])
    np.testing.assert_allclose(_np(out), np.asarray(fn(params,
                                                       jnp.asarray(x))),
                               atol=ATOL_FP32)
    np.testing.assert_allclose(_np(gw).T, np.asarray(jg["inner.weight"]),
                               rtol=RTOL_GRAD, atol=1e-7)
    np.testing.assert_allclose(_np(gb), np.asarray(jg["inner.bias"]),
                               rtol=RTOL_GRAD, atol=1e-7)
    assert float(gw.abs().sum()) > 0
    # with fake-quantized activations too
    jfq2 = jquant.FakeQuantLinear(jl, bits=8, quant_activations=True)
    fq2 = FakeQuantLinear(tl, bits=8, quant_activations=True)
    fn2, p2 = jfq2.functional()
    np.testing.assert_allclose(_np(fq2(torch.from_numpy(x))),
                               np.asarray(fn2(p2, jnp.asarray(x))),
                               atol=ATOL_FP32)


def test_fake_quant_zero_guard():
    out = fake_quant(torch.zeros(3))
    assert torch.equal(out, torch.zeros(3))
    out = fake_quant(torch.zeros(2, 3), axis=1)
    assert torch.equal(out, torch.zeros(2, 3))


def test_fake_quant_linear_trains_llama(tmp_path):
    """Every projection of the tiny Llama wrapped in ``FakeQuantLinear``
    trains through the Trainer (3 AdamW steps, the loss falls)."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    for layer in tm.model.layers:
        for mod in (layer.self_attn, layer.mlp):
            for name, sub in list(mod.named_children()):
                if isinstance(sub, Linear):
                    setattr(mod, name, FakeQuantLinear(sub))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 16)))
    tr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2),
                     ptt.TrainingArguments(output_dir=str(tmp_path),
                                           max_steps=3, logging_steps=1,
                                           graceful_shutdown=False),
                     train_dataloader=[ids])
    tr.train()
    losses = [v for _, v in tr.logger.history["loss"]]
    assert losses[-1] < losses[0]


# ----------------------------------------------------------------- PTQ
def _mlps(seed=0):
    """The JAX test's MLP (16 -> 32 -> GELU -> 8) in both packages, the
    same weights."""
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.GELU(), jnn.Linear(32, 8))
    g = ptt.make_generator(0, "cpu")
    tm = torch.nn.Sequential(Linear(16, 32, generator=g, device="cpu"),
                             torch.nn.GELU(approximate="none"),
                             Linear(32, 8, generator=g, device="cpu"))
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def test_ptq_calibrate_convert_as_jax():
    """Both PTQs calibrate on the same 4 batches: the observers' stats and
    scales equal JAX's; after ``convert`` both Linears are W8A8Linear
    (hooks gone) and the outputs equal JAX's within ATOL_W8A8_MLP, a few
    percent from the float model, as the JAX test asks."""
    jm, tm = _mlps()
    rs = np.random.RandomState(0)
    calib = [rs.randn(8, 16).astype(np.float32) for _ in range(4)]
    jref = np.asarray(jm(jnp.asarray(calib[0])))
    with torch.no_grad():
        ref = _np(tm(torch.from_numpy(calib[0])))
    np.testing.assert_allclose(ref, jref, atol=1e-5)
    jptq, ptq = jquant.PTQ(jm), PTQ(tm)
    assert list(ptq.observers) == list(jptq.observers)
    with torch.no_grad():
        for b in calib:
            jm(jnp.asarray(b))
            tm(torch.from_numpy(b))
    for k, o in ptq.observers.items():
        assert o.stat == pytest.approx(jptq.observers[k].stat, rel=RTOL_SCALE)
        assert o.scale() == pytest.approx(jptq.observers[k].scale(),
                                          rel=RTOL_SCALE)
    jptq.convert()
    ptq.convert()
    kinds = [type(m).__name__ for m in tm.modules()]
    assert kinds.count("W8A8Linear") == 2 and "Linear" not in kinds
    assert all(not m._forward_pre_hooks for m in tm.modules())
    for q in (m for m in tm.modules() if isinstance(m, W8A8Linear)):
        assert q.block_size == q.in_features   # 16 and 32: one block
    with torch.no_grad():
        got = _np(tm(torch.from_numpy(calib[0])))
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(calib[0]))),
                               atol=ATOL_W8A8_MLP)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.08, rel


def test_ptq_convert_without_calibration_raises():
    _, tm = _mlps()
    with pytest.raises(RuntimeError, match="calibration"):
        PTQ(tm).convert()
    with pytest.raises(ValueError, match="no Linear"):
        PTQ(torch.nn.Sequential(torch.nn.GELU()))


def test_ptq_observer_semantics_as_jax():
    for ema in (0.0, 0.9):
        o, jo = AbsMaxObserver(ema=ema), jquant.AbsMaxObserver(ema=ema)
        for v in ([10.0, -3.0], [0.0], [2.0]):
            o.update(torch.tensor(v))
            jo.update(jnp.asarray(v))
            assert o.stat == pytest.approx(jo.stat, rel=1e-7)
        assert o.scale() == pytest.approx(jo.scale(), rel=1e-7)
    o = AbsMaxObserver()
    o.update(torch.tensor([1.0, -3.0]))
    o.update(torch.tensor([2.0]))
    assert o.stat == 3.0 and o.scale() == pytest.approx(3.0 / 127)
    e = AbsMaxObserver(ema=0.9)
    e.update(torch.tensor([10.0]))
    e.update(torch.tensor([0.0]))
    assert e.stat == pytest.approx(9.0)
    assert AbsMaxObserver().scale() == pytest.approx(1e-8 / 127)


def test_ptq_skip_patterns_as_jax():
    jm, tm = _mlps()
    for skip in (["2"], ["0"], ["nothing"]):
        assert list(PTQ(tm, skip=skip).observers) == \
            list(jquant.PTQ(jm, skip=skip).observers)
    assert len(PTQ(tm, skip=["2"]).observers) == 1


def test_ptq_llama_scales_and_logits_as_jax():
    """A Llama of hidden 256 (every projection fills 128-row blocks),
    calibrated on 2 batches with ``lm_head`` skipped and converted in
    both packages: the 14 observers' scales and the converted model's
    logits agree; the codes are the weight-only quantizer's, bit for
    bit."""
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny(**WIDE))
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**WIDE), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    rs = np.random.RandomState(1)
    calib = [rs.randint(0, 256, (1, 32)) for _ in range(2)]
    jptq = jquant.PTQ(jm, skip=["lm_head"])
    ptq = PTQ(tm, skip=["lm_head"])
    assert len(ptq.observers) == 14 and list(ptq.observers) == \
        list(jptq.observers)
    with torch.no_grad():
        for b in calib:
            jm(jnp.asarray(b))
            tm(torch.from_numpy(b))
    for k, o in ptq.observers.items():
        assert o.scale() == pytest.approx(jptq.observers[k].scale(),
                                          rel=RTOL_SCALE), k
    jptq.convert()
    ptq.convert()
    q = tm.model.layers[0].self_attn.q_proj
    jq = jm.model.layers[0].self_attn.q_proj
    assert isinstance(q, W8A8Linear) and isinstance(q, QuantizedLinear)
    np.testing.assert_array_equal(q.qweight.numpy(), np.asarray(jq.qweight))
    assert q.act_scale == pytest.approx(jq.act_scale, rel=RTOL_SCALE)
    ids = rs.randint(0, 256, (2, 16))
    with torch.no_grad():
        got = _np(tm(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(ids))),
                               atol=ATOL_W8A8_LOGITS)
