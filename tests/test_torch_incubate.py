"""The port's ``incubate.nn.functional`` against the JAX package's on the
same inputs, made from a numpy seed (fp32): the twelve cases of
``tests/test_incubate.py``, each held to the JAX function within 1e-5
(2e-5 for attention), weights in the reference's own layouts ([in, out]
for ``fused_linear`` and ``fused_feedforward``, [K, N] for
``fused_linear_activation``'s y).

- routing: a causal, unmasked ``fused_dot_product_attention`` at a
  128-multiple length goes through ``FlashAttentionFunction`` (the flash
  kernels on a CUDA tensor), and with a mask or dropout it does not;
- gradients of q, k and v through the flash route equal ``jax.grad`` of
  the JAX function, whose flash path runs the Pallas kernels in interpret
  mode, as the JAX package's own tests run it on the CPU (2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.llama import rotary_cos_sin as j_rotary_cos_sin
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops.kernels.flash_attention import \
    FlashAttentionFunction

ATOL = 1e-5


def _x(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _both(fn_name, args, kw=None, atol=ATOL):
    """Run the JAX and the port function on the same numpy inputs and
    compare every output."""
    kw = kw or {}
    conv_j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v  # noqa
    conv_t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) \
        else v  # noqa: E731
    want = getattr(JIF, fn_name)(*map(conv_j, args),
                                 **{k: conv_j(v) for k, v in kw.items()})
    got = getattr(TIF, fn_name)(*map(conv_t, args),
                                **{k: conv_t(v) for k, v in kw.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=ATOL, err_msg=fn_name)
    return got


def test_every_jax_function_is_ported():
    assert TIF.__all__ == JIF.__all__
    assert all(callable(getattr(TIF, n)) for n in JIF.__all__)


def test_rms_and_layer_norm():
    rs = np.random.RandomState(0)
    x, w, b = _x(rs, 2, 8, 16), _x(rs, 16), _x(rs, 16)
    _both("fused_rms_norm", [x, w])
    _both("fused_rms_norm", [x, w, b])
    _both("fused_layer_norm", [x, w, b])


def test_linear_variants():
    rs = np.random.RandomState(1)
    x, w, b = _x(rs, 4, 8), _x(rs, 8, 12), _x(rs, 12)
    _both("fused_linear", [x, w, b])
    _both("fused_linear", [x, np.ascontiguousarray(w.T), b],
          dict(transpose_weight=True))
    for act in ("", "relu", "gelu", "silu"):
        _both("fused_linear_activation", [x, w, b], dict(activation=act))
    _both("fused_linear_activation",
          [np.ascontiguousarray(x.T), np.ascontiguousarray(w.T), b],
          dict(trans_x=True, trans_y=True, activation="swish"))


def test_swiglu():
    rs = np.random.RandomState(2)
    x, y = _x(rs, 3, 8), _x(rs, 3, 8)
    _both("swiglu", [x, y])
    _both("swiglu", [np.concatenate([x, y], axis=-1)])


def test_rope_matches_model_rope():
    rs = np.random.RandomState(3)
    q, k = _x(rs, 2, 6, 4, 8), _x(rs, 2, 6, 2, 8)
    got = _both("fused_rotary_position_embedding", [q, k])
    assert got[2] is None
    _both("fused_rotary_position_embedding", [q, k, _x(rs, 2, 6, 2, 8)])
    _both("fused_rotary_position_embedding", [q])


def test_fused_attention_matches_jax():
    rs = np.random.RandomState(4)
    q, k, v = _x(rs, 2, 16, 4, 8), _x(rs, 2, 16, 4, 8), _x(rs, 2, 16, 4, 8)
    _both("fused_dot_product_attention", [q, k, v], dict(is_causal=True),
          atol=2e-5)
    _both("fused_dot_product_attention", [q, k, v], dict(scale=0.3),
          atol=2e-5)


def test_fused_feedforward():
    rs = np.random.RandomState(5)
    x = _x(rs, 2, 4, 8)
    w1, w2, b1, b2 = _x(rs, 8, 16), _x(rs, 16, 8), _x(rs, 16), _x(rs, 8)
    g, b = _x(rs, 8), _x(rs, 8)
    _both("fused_feedforward", [x, w1, w2],
          dict(activation="gelu", ln1_scale=g, ln1_bias=b,
               pre_layer_norm=True, training=False))
    _both("fused_feedforward", [x, w1, w2, b1, b2],
          dict(ln2_scale=g, ln2_bias=b, dropout1_rate=0.0,
               dropout2_rate=0.0, training=True))


def test_interleaved_rope_differs_and_pairs():
    rs = np.random.RandomState(6)
    q = _x(rs, 1, 4, 2, 8)
    neox = _both("fused_rotary_position_embedding", [q])[0]
    inter = _both("fused_rotary_position_embedding", [q],
                  dict(use_neox_rotary_style=False))[0]
    assert not torch.allclose(neox, inter)
    np.testing.assert_allclose(inter[:, 0].numpy(), q[:, 0], rtol=1e-6)


@pytest.mark.parametrize("half", (False, True))
def test_rope_tables_gather_position_ids(half):
    rs = np.random.RandomState(7)
    q = _x(rs, 1, 4, 2, 8)
    cos_h, sin_h = j_rotary_cos_sin(jnp.arange(16)[None], 8, 10000.0,
                                    jnp.float32)
    cos_t, sin_t = np.asarray(cos_h[0, :, 0]), np.asarray(sin_h[0, :, 0])
    if not half:   # full-width [max_pos, d] tables
        cos_t, sin_t = np.repeat(cos_t, 2, -1), np.repeat(sin_t, 2, -1)
    pos = np.array([[0, 0, 1, 2]], np.int64)
    got = _both("fused_rotary_position_embedding", [q],
                dict(sin=sin_t, cos=cos_t, position_ids=pos))[0]
    plain = TIF.fused_rotary_position_embedding(
        torch.from_numpy(q), position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="rotary table rows"):
        TIF.fused_rotary_position_embedding(
            torch.from_numpy(q), sin=torch.from_numpy(sin_t),
            cos=torch.from_numpy(cos_t),
            position_ids=torch.tensor([[0, 1, 2, 16]]))


def test_ffn_downscale_in_infer():
    rs = np.random.RandomState(8)
    x = _x(rs, 2, 4, 8)
    w1, w2 = _x(rs, 8, 16), _x(rs, 16, 8)
    g, b = _x(rs, 8), _x(rs, 8)
    _both("fused_feedforward", [x, w1, w2],
          dict(ln1_scale=g, ln1_bias=b, dropout1_rate=0.5,
               dropout2_rate=0.0, pre_layer_norm=True, training=False,
               mode="downscale_in_infer"))


def test_causal_composes_with_mask():
    rs = np.random.RandomState(9)
    q, k, v = _x(rs, 1, 8, 2, 8), _x(rs, 1, 8, 2, 8), _x(rs, 1, 8, 2, 8)
    pad = (np.arange(8) < 6)[None, None, None, :]
    out = _both("fused_dot_product_attention", [q, k, v],
                dict(attn_mask=pad, is_causal=True), atol=2e-5)[0]
    bidir = TIF.fused_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(pad))
    assert not torch.allclose(out, bidir)


def test_begin_norm_axis():
    rs = np.random.RandomState(10)
    x, w, b = _x(rs, 2, 3, 4), _x(rs, 12), _x(rs, 12)
    _both("fused_layer_norm", [x, w, None], dict(begin_norm_axis=1))
    _both("fused_rms_norm", [x, w, b], dict(begin_norm_axis=1))


def test_dropout_add_eval_is_identity_add():
    rs = np.random.RandomState(11)
    x, y = _x(rs, 3, 5), _x(rs, 3, 5)
    _both("fused_dropout_add", [x, y], dict(p=0.5, training=False))
    _both("fused_dropout_add", [x, y],
          dict(p=0.5, training=False, mode="downscale_in_infer"))
    _both("fused_dropout_add", [x, y], dict(p=0.0))


def test_dropout_add_in_training_draws_the_ambient_stream():
    import paddle_tpu_torch as ptt
    x, y = torch.ones(2000), torch.zeros(2000)
    ptt.seed(1)
    a = TIF.fused_dropout_add(x, y, p=0.25)
    ptt.seed(1)
    b = TIF.fused_dropout_add(x, y, p=0.25)
    assert torch.equal(a, b)
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.04
    c = TIF.fused_dropout_add(x, y, p=0.25,
                              generator=ptt.make_generator(2, "cpu"))
    assert not torch.equal(a, c)


# ------------------------------------------------------------ the route
def _qkv(rs, b, s, h, kv, d):
    return (_x(rs, b, s, h, d), _x(rs, b, s, kv, d), _x(rs, b, s, kv, d))


def test_causal_unmasked_attention_goes_through_the_flash_kernels(
        monkeypatch):
    calls = []
    apply = FlashAttentionFunction.apply

    def counted(*a):
        calls.append(a[3])
        return apply(*a)
    monkeypatch.setattr(FlashAttentionFunction, "apply", counted)
    q, k, v = map(torch.from_numpy, _qkv(np.random.RandomState(12),
                                         1, 128, 4, 2, 64))
    TIF.fused_dot_product_attention(q, k, v, is_causal=True)
    assert calls == [True]
    mask = torch.ones(1, 1, 128, 128, dtype=torch.bool)
    TIF.fused_dot_product_attention(q, k, v, is_causal=True, attn_mask=mask)
    TIF.fused_dot_product_attention(q, k, v, is_causal=False)
    TIF.fused_dot_product_attention(q, k, v, is_causal=True, dropout_p=0.1,
                                    generator=torch.Generator())
    TIF.fused_dot_product_attention(q[:, :96], k[:, :96], v[:, :96],
                                    is_causal=True)
    assert calls == [True]
    TIF.fused_dot_product_attention(q, k, v, is_causal=True, dropout_p=0.1,
                                    training=False)
    assert calls == [True, True]


def test_flash_route_gradients_match_jax_grad(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    rs = np.random.RandomState(13)
    q, k, v = _qkv(rs, 1, 128, 4, 2, 64)
    w = _x(rs, 1, 128, 4, 64)

    def jloss(q, k, v):
        return jnp.sum(JIF.fused_dot_product_attention(
            q, k, v, is_causal=True) * w)
    jout = JIF.fused_dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                           is_causal=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TIF.fused_dot_product_attention(tq, tk, tv, is_causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    for name, g, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=name)
