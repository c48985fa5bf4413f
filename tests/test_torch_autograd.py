"""The port's functional transforms (``grad``, ``value_and_grad``, ``vjp``,
``jvp``, ``vmap`` on ``torch.func``), ``autograd`` (Paddle's grad,
jacobian, hessian, vjp, jvp, ``PyLayer``, ``no_grad``) and the flash
Functions under them, held to the JAX package on the CPU in fp32.

The flash kernels' JAX side runs in Pallas interpret mode, as
``tests/test_torch_flash_bwd.py`` runs it; the port's runs the Functions'
plain twins. The slice as a whole: ``ptt.value_and_grad`` over the port's
Llama through ``FlashAttentionFunction`` against ``jax.value_and_grad``
over the JAX model on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.autograd as JA
import paddle_tpu_torch as ptt
import paddle_tpu_torch.autograd as PA
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.llama import causal_lm_loss as jax_loss
from paddle_tpu.ops.pallas.flash_attention import flash_attention_bshd
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttentionFunction, flash_attention_bwd_plain,
    flash_attention_fwd_plain, flash_attention_with_lse)

# fp32 on the CPU: the same products summed in another order
RTOL, ATOL = 1e-5, 1e-6
# gradients through the flash kernel (Pallas interpret against the plain
# twin), as tests/test_torch_flash_bwd.py holds them
ATOL_FLASH = 1e-4
# the whole model's loss and gradients against JAX's (tests/
# test_torch_trainer.py's flash-path bounds)
RTOL_LOSS, ATOL_GRAD = 1e-6, 1e-4
FLASH_CFG = dict(hidden_size=256, num_attention_heads=4,
                 num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol, rtol)
        return
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


rs = np.random.RandomState(0)
X = rs.randn(5).astype(np.float32)
W = rs.randn(3, 5).astype(np.float32)
XB = rs.randn(4, 5).astype(np.float32)


def f_j(w, x):
    return jnp.sum(jnp.tanh(w @ x) ** 2)


def f_t(w, x):
    return torch.sum(torch.tanh(w @ x) ** 2)


def vec_j(x):
    return jnp.sin(x) * jnp.sum(x ** 2)


def vec_t(x):
    return torch.sin(x) * torch.sum(x ** 2)


J, Tt = jnp.asarray, torch.from_numpy


# ------------------------------------------------- the top-level transforms
def test_grad_with_argnums():
    _close(ptt.grad(f_t)(Tt(W), Tt(X)), jax.grad(f_j)(J(W), J(X)))
    _close(ptt.grad(f_t, argnums=(0, 1))(Tt(W), Tt(X)),
           jax.grad(f_j, argnums=(0, 1))(J(W), J(X)))
    _close(ptt.grad(f_t, argnums=[1])(Tt(W), Tt(X)),
           jax.grad(f_j, argnums=(1,))(J(W), J(X)))


def test_value_and_grad_returns_value_first_and_aux_with_it():
    v, g = ptt.value_and_grad(f_t)(Tt(W), Tt(X))
    jv, jg = jax.value_and_grad(f_j)(J(W), J(X))
    _close(v, jv)
    _close(g, jg)
    assert not v.requires_grad and not g.requires_grad

    def aux_t(w, x):
        return f_t(w, x), {"n": w.sum()}

    def aux_j(w, x):
        return f_j(w, x), {"n": w.sum()}
    (v, aux), g = ptt.value_and_grad(aux_t, argnums=1, has_aux=True)(
        Tt(W), Tt(X))
    (jv, jaux), jg = jax.value_and_grad(aux_j, argnums=1, has_aux=True)(
        J(W), J(X))
    _close(v, jv)
    _close(aux["n"], jaux["n"])
    _close(g, jg)


def test_vjp_and_jvp_return_jax_structures():
    out, pull = ptt.vjp(vec_t, Tt(X))
    jout, jpull = jax.vjp(vec_j, J(X))
    ct = rs.randn(5).astype(np.float32)
    _close(out, jout)
    got, want = pull(Tt(ct)), jpull(J(ct))
    assert isinstance(got, tuple) and len(got) == len(want) == 1
    _close(got, want)
    t = rs.randn(5).astype(np.float32)
    got = ptt.jvp(vec_t, (Tt(X),), (Tt(t),))
    want = jax.jvp(vec_j, (J(X),), (J(t),))
    _close(got, want)


def test_vmap_with_axes():
    got = ptt.vmap(f_t, in_axes=(None, 0))(Tt(W), Tt(XB))
    want = jax.vmap(f_j, in_axes=(None, 0))(J(W), J(XB))
    _close(got, want)
    got = ptt.vmap(lambda a: a * 2, in_axes=1, out_axes=1)(Tt(XB))
    _close(got, jax.vmap(lambda a: a * 2, in_axes=1, out_axes=1)(J(XB)))


def test_stop_gradient():
    got = ptt.grad(lambda x: (ptt.stop_gradient(x) * x).sum())(Tt(X))
    want = jax.grad(lambda x: (pt.stop_gradient(x) * x).sum())(J(X))
    _close(got, want)


# ------------------------------------------------------------------ no_grad
def test_no_grad_inside_grad_cuts_nothing_as_the_jax_marker():
    """f(x) = sum((2x under no_grad) * x) at ones(3): JAX's no_grad is a
    no-op, so d f / d x = 4x."""
    def f(x, ng):
        with ng():
            y = 2 * x
        return jnp.sum(y * x) if isinstance(x, jax.Array) else (y * x).sum()
    want = jax.grad(lambda x: f(x, pt.no_grad))(jnp.ones(3))
    np.testing.assert_array_equal(np.asarray(want), [4., 4., 4.])
    got = ptt.grad(lambda x: f(x, ptt.no_grad))(torch.ones(3))
    assert got.tolist() == [4., 4., 4.]
    got = PA.grad(lambda x: f(x, PA.no_grad), torch.ones(3))
    assert got.tolist() == [4., 4., 4.]
    # torch's own no_grad would have cut it
    got = torch.func.grad(lambda x: f(x, torch.no_grad))(torch.ones(3))
    assert got.tolist() == [2., 2., 2.]


def test_no_grad_in_eager_code_records_nothing():
    assert ptt.no_grad is PA.no_grad
    x = torch.ones(2, requires_grad=True)
    with ptt.no_grad():
        assert not (x * 2).requires_grad

    @ptt.no_grad
    def f(a):
        return a * 2

    @ptt.no_grad()
    def g(a):
        return a * 2
    assert not f(x).requires_grad and not g(x).requires_grad
    assert (x * 2).requires_grad


# ----------------------------------------------------------------- autograd
def test_autograd_grad_takes_the_function():
    with pytest.raises(TypeError):
        JA.grad(J(X), J(X))
    with pytest.raises(TypeError):
        PA.grad(Tt(X), Tt(X))
    _close(PA.grad(vec_t, Tt(X)), JA.grad(vec_j, J(X)))
    _close(PA.grad(f_t, [Tt(W), Tt(X)]), JA.grad(f_j, [J(W), J(X)]))
    ct = rs.randn(5).astype(np.float32)
    _close(PA.grad(vec_t, Tt(X), grad_outputs=[Tt(ct)]),
           JA.grad(vec_j, J(X), grad_outputs=[J(ct)]))


@pytest.mark.parametrize("fn", ("jacobian", "hessian"))
def test_jacobian_and_hessian(fn):
    jf, pf = getattr(JA, fn), getattr(PA, fn)
    scal_j = (lambda x: jnp.sum(vec_j(x))) if fn == "hessian" else vec_j
    scal_t = (lambda x: torch.sum(vec_t(x))) if fn == "hessian" else vec_t
    _close(pf(scal_t, Tt(X)), jf(scal_j, J(X)), atol=1e-5)
    _close(pf(scal_t, Tt(XB), batch_axis=0), jf(scal_j, J(XB), batch_axis=0),
           atol=1e-5)
    _close(pf(f_t, [Tt(W), Tt(X)]), jf(f_j, [J(W), J(X)]), atol=1e-5)
    with pytest.raises(NotImplementedError):
        pf(f_t, [Tt(W), Tt(X)], batch_axis=0)


def test_incubate_vjp_and_jvp():
    out, g = PA.vjp(vec_t, Tt(X))
    jout, jg = JA.vjp(vec_j, J(X))
    _close(out, jout)
    _close(g, jg)
    ct = rs.randn(5).astype(np.float32)
    _close(PA.vjp(f_t, [Tt(W), Tt(X)])[1], JA.vjp(f_j, [J(W), J(X)])[1])
    _close(PA.vjp(vec_t, Tt(X), Tt(ct))[1], JA.vjp(vec_j, J(X), J(ct))[1])
    _close(PA.jvp(vec_t, Tt(X)), JA.jvp(vec_j, J(X)))
    _close(PA.jvp(f_t, [Tt(W), Tt(X)], [Tt(W), Tt(X)]),
           JA.jvp(f_j, [J(W), J(X)], [J(W), J(X)]))


# ------------------------------------------------------------------ PyLayer
def _ste(base, xp):
    """A clipped straight-through estimator: round forward, the gradient
    passed where |x| <= 1."""
    class ClippedSTE(base):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return xp.round(x)

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor()
            return g * (xp.abs(x) <= 1).astype(g.dtype) if xp is jnp else \
                g * (x.abs() <= 1).to(g.dtype)
    return ClippedSTE


def test_pylayer_eager_and_under_grad_match_jax():
    a = np.array([0.3, 2.0, -0.7, -1.5, 1.0], np.float32)
    JSte, PSte = _ste(JA.PyLayer, jnp), _ste(PA.PyLayer, torch)
    want = jax.grad(lambda x: jnp.sum(JSte.apply(x) * x))(J(a))
    got = ptt.grad(lambda x: (PSte.apply(x) * x).sum())(Tt(a))
    t = Tt(a).requires_grad_()
    (PSte.apply(t) * t).sum().backward()
    _close(got, want)
    assert torch.equal(t.grad, got)
    _close(PSte.apply(Tt(a)), JSte.apply(J(a)))
    assert type(PSte.apply(t).grad_fn).__name__ == \
        "ClippedSTEFunctionBackward"
    # composes with vmap, as custom_vjp does
    got = ptt.vmap(ptt.grad(lambda x: PSte.apply(x).sum()))(Tt(XB))
    want = jax.vmap(jax.grad(lambda x: jnp.sum(JSte.apply(x))))(J(XB))
    _close(got, want)


def test_pylayer_subclass_overriding_backward_gets_its_own_rule():
    class Double(PA.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    class Ten(Double):
        @staticmethod
        def backward(ctx, g):
            return g * 10
    x = torch.ones(3)
    assert ptt.grad(lambda a: Double.apply(a).sum())(x).tolist() == [2.] * 3
    assert ptt.grad(lambda a: Ten.apply(a).sum())(x).tolist() == [10.] * 3
    assert Ten._op is not Double._op


def test_pylayer_pads_missing_gradients_and_takes_tuple_outputs():
    class Scale(PA.PyLayer):
        @staticmethod
        def forward(ctx, x, y, k):
            ctx.save_for_backward(y, None)
            return x * y * k, x + y

        @staticmethod
        def backward(ctx, g):
            y, none = ctx.saved_tensor()
            assert none is None
            return g[0] * y + g[1]

    class JScale(JA.PyLayer):
        @staticmethod
        def forward(ctx, x, y, k):
            ctx.save_for_backward(y)
            return x * y * k, x + y

        @staticmethod
        def backward(ctx, g):
            y, = ctx.saved_tensor()
            return (g[0] * y + g[1],)

    def loss_t(x, y):
        a, b = Scale.apply(x, y, 3.0)
        return (a * a).sum() + b.sum()

    def loss_j(x, y):
        a, b = JScale.apply(x, y, 3.0)
        return jnp.sum(a * a) + jnp.sum(b)
    got = ptt.grad(loss_t, argnums=(0, 1))(Tt(X), Tt(X[::-1].copy()))
    want = jax.grad(loss_j, argnums=(0, 1))(J(X), J(X[::-1].copy()))
    _close(got, want)
    assert float(got[1].abs().sum()) == 0.0


# ------------------------------------------------------ the flash Functions
def _qkv(seed, b=2, s=128, h=4, kv=2, d=64, lead=()):
    r = np.random.RandomState(seed)
    q = (r.randn(*lead, b, s, h, d) * 0.5).astype(np.float32)
    k = (r.randn(*lead, b, s, kv, d) * 0.5).astype(np.float32)
    v = r.randn(*lead, b, s, kv, d).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v):
    return flash_attention_bshd(q, k, v, causal=True, block_q=128,
                                block_k=128)


def _port_flash(q, k, v):
    return port_attn.flash_attention(q, k, v, causal=True)


def test_eager_backward_is_the_plain_twins_bit_for_bit():
    """The rewritten Function's eager forward and ``.backward()`` give
    exactly the plain forward and backward called directly."""
    q, k, v = _qkv(1)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    xs = [Tt(a).requires_grad_() for a in (q, k, v)]
    out, lse = FlashAttentionFunction.apply(*xs, True)
    assert not lse.requires_grad
    out.backward(Tt(g))
    pout, plse = flash_attention_fwd_plain(Tt(q), Tt(k), Tt(v), causal=True)
    assert torch.equal(out.detach(), pout) and torch.equal(lse, plse)
    want = flash_attention_bwd_plain(Tt(q), Tt(k), Tt(v), pout, plse, Tt(g),
                                     causal=True)
    for x, w in zip(xs, want):
        assert torch.equal(x.grad, w)


def test_vmap_of_flash_matches_jax_vmap_and_each_slice(pallas_interpret):
    q, k, v = _qkv(3, b=1, lead=(2,))
    want = jax.vmap(_jax_flash)(J(q), J(k), J(v))
    got = ptt.vmap(_port_flash)(Tt(q), Tt(k), Tt(v))
    _close(got, want, atol=ATOL_FLASH)
    for i in range(2):
        assert torch.equal(got[i], _port_flash(Tt(q[i]), Tt(k[i]),
                                               Tt(v[i])))
    # an unmapped k, v (in_axes None) expands to every slice
    got = ptt.vmap(_port_flash, in_axes=(0, None, None))(Tt(q), Tt(k[0]),
                                                         Tt(v[0]))
    want = jax.vmap(_jax_flash, in_axes=(0, None, None))(J(q), J(k[0]),
                                                         J(v[0]))
    _close(got, want, atol=ATOL_FLASH)


def test_grad_of_vmapped_flash_matches_jax_and_the_eager_slices(
        pallas_interpret):
    q, k, v = _qkv(4, b=1, lead=(2,))
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def loss_t(q, k, v):
        return (ptt.vmap(_port_flash)(q, k, v) * Tt(g)).sum()

    def loss_j(q, k, v):
        return jnp.sum(jax.vmap(_jax_flash)(q, k, v) * J(g))
    got = ptt.grad(loss_t, argnums=(0, 1, 2))(Tt(q), Tt(k), Tt(v))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(J(q), J(k), J(v))
    _close(got, want, atol=ATOL_FLASH)
    for i in range(2):
        xs = [Tt(a[i]).requires_grad_() for a in (q, k, v)]
        _port_flash(*xs).backward(Tt(g[i]))
        for gx, x in zip(got, xs):
            assert torch.equal(gx[i], x.grad)
    # vmap of grad: the backward's own vmap rule
    per = ptt.vmap(ptt.grad(lambda q, k, v, g: (_port_flash(q, k, v)
                                                * g).sum()))(
        Tt(q), Tt(k), Tt(v), Tt(g))
    assert torch.equal(per, got[0])


def test_forward_mode_through_flash_raises_as_in_jax(pallas_interpret):
    q, k, v = _qkv(6, b=1)
    with pytest.raises(TypeError, match="custom_vjp"):
        jax.jvp(lambda q: _jax_flash(q, J(k), J(v)), (J(q),),
                (jnp.ones_like(J(q)),))
    with pytest.raises(NotImplementedError, match="jvp"):
        ptt.jvp(lambda q: _port_flash(q, Tt(k), Tt(v)), (Tt(q),),
                (torch.ones_like(Tt(q)),))
    with pytest.raises(NotImplementedError, match="jvp"):
        PA.hessian(lambda q: _port_flash(q, Tt(k), Tt(v)).sum(), Tt(q))


def test_flash_with_lse_under_grad_is_its_eager_backward():
    q, k, v = _qkv(7, b=1)

    def loss(q, k, v):
        out, lse = flash_attention_with_lse(q, k, v, causal=True)
        return out.sum() + (lse * 0.5).sum()
    got = ptt.grad(loss, argnums=(0, 1, 2))(Tt(q), Tt(k), Tt(v))
    xs = [Tt(a).requires_grad_() for a in (q, k, v)]
    loss(*xs).backward()
    for gx, x in zip(got, xs):
        assert torch.equal(gx, x.grad)
    per = ptt.vmap(ptt.grad(loss))(Tt(q)[None].expand(2, *q.shape),
                                   Tt(k)[None].expand(2, *k.shape),
                                   Tt(v)[None].expand(2, *v.shape))
    assert torch.equal(per[1], got[0])


def test_value_and_grad_over_llama_through_flash_matches_jax(
        pallas_interpret, monkeypatch):
    """The slice as a whole: the JAX training idiom (``model.functional()``
    then ``value_and_grad``) on the port's Llama at a sequence of 128,
    through ``FlashAttentionFunction``, against the JAX model on the same
    weights."""
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny(**FLASH_CFG))
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**FLASH_CFG), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(22).randint(0, 256, (2, 128)).astype(
        np.int32)
    jpure, jparams = jm.functional()
    jl, jg = jax.value_and_grad(
        lambda p: jax_loss(jpure(p, J(ids)), J(ids)))(dict(jparams))
    pure, params = tm.functional()
    tids = Tt(ids).long()
    calls = []
    forward = FlashAttentionFunction.forward

    def counted(*a):
        calls.append(1)
        return forward(*a)
    monkeypatch.setattr(FlashAttentionFunction, "forward",
                        staticmethod(counted))
    loss, grads = ptt.value_and_grad(
        lambda p: ptt.causal_lm_loss(pure(p, tids), tids))(
        {n: t.detach() for n, t in params.items()})
    assert len(calls) == tm.config.num_hidden_layers
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL_LOSS)
    ref = ptt.LlamaForCausalLM(ptt.llama_tiny(**FLASH_CFG), device="cpu")
    ptt.load_jax_state_dict(ref, {k: np.asarray(v) for k, v in jg.items()})
    for name, want in ref.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(),
                                   want.detach().numpy(), atol=ATOL_GRAD,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("family", ("qwen2_moe", "deepseek_v2", "gpt"))
def test_value_and_grad_over_the_other_causal_lms_at_a_world_of_one(family):
    """At a world of one no collective's ``autograd.Function`` (the
    ``parallel/layers.py``, ``ring.py`` and ``collective.py`` ones, not
    yet in ``torch.func`` form) is reached: the functional step runs and
    equals the eager one."""
    import paddle_tpu_torch.models as M
    from paddle_tpu_torch.models import deepseek_v2, gpt, qwen2_moe
    cls, cfg = {"qwen2_moe": (M.Qwen2MoeForCausalLM,
                              qwen2_moe.qwen2_moe_tiny()),
                "deepseek_v2": (M.DeepseekV2ForCausalLM,
                                deepseek_v2.deepseek_v2_tiny()),
                "gpt": (M.GPTForCausalLM, gpt.gpt_tiny())}[family]
    m = cls(cfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(23).randint(
        0, cfg.vocab_size, (2, 16)))

    def logits(out):
        return out[0] if isinstance(out, tuple) else out
    pure, params = m.functional()
    loss, grads = ptt.value_and_grad(
        lambda p: ptt.causal_lm_loss(logits(pure(p, ids)), ids))(
        {n: t.detach() for n, t in params.items()})
    eager = ptt.causal_lm_loss(logits(m(ids)), ids)
    eager.backward()
    np.testing.assert_allclose(float(loss), float(eager.detach()), rtol=1e-6)
    for name, p in m.named_parameters():
        if p.grad is None:
            assert float(grads[name].abs().max()) == 0.0, name
            continue
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
