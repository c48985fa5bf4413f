"""The port's ``nn`` pieces of this slice against the JAX package's:
``LayerNorm`` (its rounding point in bf16), GELU (exact and tanh),
dropout in both of Paddle's modes and attention dropout (held to their
rates, scalings and streams: a JAX key has no bitwise counterpart), and
Paddle's Transformer layers: ``MultiHeadAttention`` with a cache, the
encoder and decoder layers pre- and post-norm with relu and gelu, the
stacks and ``Transformer``, on the dense route (s 16) and the flash
route (s 128, head_dim 64: the flash kernels' plain version here), the
encoder's gradients too. The JAX layers are built from a seed and their
weights cross as numpy through ``load_jax_state_dict``; fp32 on the
CPU, in eval mode (dropout off) for parity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.attention import dense_attention

# fp32 outputs of a few layers: the same math, summed in another order
ATOL = 1e-4
# fp32 gradients through 2 layers, relative to the largest of them all
RTOL_GRAD = 1e-4
# dropout's keep rate over 2^20 draws: 5 standard deviations at p = 0.1
KEEP_TOL = 5 * (0.1 * 0.9 / 2 ** 20) ** 0.5


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sd(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(tm, jm):
    """(jm, tm) with the JAX layer's weights in the port's, both in eval
    mode."""
    ptt.load_jax_state_dict(tm, _sd(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _layer_pair(cls_j, cls_t, seed, *args, **kw):
    pt.seed(seed)
    jm = cls_j(*args, **kw)
    return _load(cls_t(*args, device="cpu", **kw), jm)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_layer_norm_matches_jax_at_its_rounding_point(dtype):
    """fp32 statistics, rounded to the input dtype, then the weight and
    the bias: bit for bit the JAX layer in bf16 too."""
    pt.seed(1)
    jl = jnn.LayerNorm(64, epsilon=1e-12)
    rs = np.random.RandomState(2)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    b = (0.1 * rs.randn(64)).astype(np.float32)
    x = _x(4, 8, 64, seed=3) * 3 + 1
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tl = nn.LayerNorm(64, epsilon=1e-12, device="cpu", dtype=tdt)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    ref = JF.layer_norm(jnp.asarray(x, jdt), 64, jnp.asarray(w, jdt),
                        jnp.asarray(b, jdt), 1e-12)
    got = tl(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got.float().detach().numpy(), ref)
    assert jl.state_dict().keys() == tl.state_dict().keys()


@pytest.mark.parametrize("approximate", (False, True))
def test_gelu_matches_jax(approximate):
    x = _x(1000, seed=4) * 4
    ref = np.asarray(JF.gelu(jnp.asarray(x), approximate=approximate))
    got = F.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        nn.GELU(approximate=approximate)(torch.from_numpy(x)).numpy(), ref,
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ("upscale_in_train", "downscale_in_infer"))
def test_dropout_modes_rates_and_streams(mode):
    """Training keeps a share 1 - p of the elements (within 5 sigma),
    scaled by 1 / (1 - p) (``upscale_in_train``) or not at all
    (``downscale_in_infer``); inference is the identity or the 1 - p
    scale, as the JAX function gives it; the same generator state gives
    the same mask, another seed another one."""
    p = 0.1
    x = torch.full((1 << 20,), 2.0)
    draws = [F.dropout(x, p, generator=ptt.make_generator(s, "cpu"),
                       mode=mode) for s in (5, 5, 6)]
    kept = draws[0] != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < KEEP_TOL
    want = 2.0 / (1 - p) if mode == "upscale_in_train" else 2.0
    assert torch.allclose(draws[0][kept], torch.tensor(want))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    got = F.dropout(x[:8], p, training=False, mode=mode).numpy()
    ref = np.asarray(JF.dropout(jnp.asarray(x[:8].numpy()), p,
                                training=False, mode=mode))
    np.testing.assert_allclose(got, ref, rtol=1e-7)
    with pytest.raises(ValueError, match="Generator"):
        F.dropout(x, p)
    layer = nn.Dropout(p, mode=mode, generator=ptt.make_generator(5, "cpu"))
    assert torch.equal(layer(x), draws[0])
    layer.eval()
    np.testing.assert_allclose(layer(x[:8]).numpy(), ref, rtol=1e-7)


def test_attention_dropout():
    """``dense_attention``'s dropout: p = 0 or no generator is the plain
    attention; with one, the kept probabilities are scaled by 1 / (1 -
    p), so the mean over many draws is the plain output, and the same
    generator state gives the same bits."""
    q, k, v = (torch.from_numpy(_x(1, 16, 2, 8, seed=s)) for s in (7, 8, 9))
    plain = dense_attention(q, k, v)
    assert torch.equal(dense_attention(q, k, v, dropout_p=0.3), plain)
    gen = ptt.make_generator(10, "cpu")
    a = dense_attention(q, k, v, dropout_p=0.3, generator=gen)
    b = dense_attention(q, k, v, dropout_p=0.3,
                        generator=ptt.make_generator(10, "cpu"))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    mean = torch.stack([dense_attention(q, k, v, dropout_p=0.3,
                                        generator=gen)
                        for _ in range(2000)]).mean(0)
    assert float((mean - plain).abs().max()) < 0.1


def test_multi_head_attention_with_a_cache_matches_jax():
    """Self-attention under a boolean mask, then a step appending to a
    (k, v) cache, and cross-attention with kdim / vdim: the JAX layer's
    outputs and the grown cache."""
    jm, tm = _layer_pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, 11,
                         32, 4, kdim=24, vdim=24)
    q, mem = _x(2, 6, 32, seed=12), _x(2, 10, 24, seed=13)
    ref = jm(jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mem))
    got = tm(torch.from_numpy(q), torch.from_numpy(mem),
             torch.from_numpy(mem))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    js, ts = _layer_pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, 14,
                         32, 4)
    ck, cv = _x(2, 5, 4, 8, seed=15), _x(2, 5, 4, 8, seed=16)
    mask = np.ones((2, 1, 6, 11), bool)
    mask[1, :, :, :3] = False
    ref, (rk, rv) = js(jnp.asarray(q), attn_mask=jnp.asarray(mask),
                       cache=(jnp.asarray(ck), jnp.asarray(cv)))
    got, (gk, gv) = ts(torch.from_numpy(q),
                       attn_mask=torch.from_numpy(mask),
                       cache=(torch.from_numpy(ck), torch.from_numpy(cv)))
    for a, b in ((got, ref), (gk, rk), (gv, rv)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize_before,activation,seq", (
    (False, "relu", 16), (True, "gelu", 16), (False, "gelu", 128),
    (True, "relu", 128)), ids=("post-relu", "pre-gelu", "post-gelu-flash",
                               "pre-relu-flash"))
def test_encoder_matches_jax(normalize_before, activation, seq):
    """A 2-layer encoder from one layer (its deep copies), with an
    additive padding mask on the dense route; at s 128 and head_dim 64
    without a mask the flash route, whose gradients are held to
    ``jax.grad``'s too."""
    width = 256 if seq == 128 else 32
    layer_kw = dict(dropout=0.0, activation=activation,
                    normalize_before=normalize_before)
    pt.seed(17)
    jl = jnn.TransformerEncoderLayer(width, 4, 2 * width, **layer_kw)
    je = jnn.TransformerEncoder(jl, 2)
    tl = nn.TransformerEncoderLayer(width, 4, 2 * width, device="cpu",
                                    **layer_kw)
    je, te = _load(nn.TransformerEncoder(tl, 2), je)
    x = _x(2, seq, width, seed=18)
    mask = None
    if seq == 16:
        mask = np.zeros((2, 1, 1, seq), np.float32)
        mask[1, ..., 12:] = -1e9
    ref = je(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    tx = torch.from_numpy(x).requires_grad_()
    got = te(tx, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    if mask is not None:
        return
    fn, params = je.functional()
    g = np.array(jax.random.normal(jax.random.key(19), x.shape))
    jgrads = jax.grad(lambda p, xx: jnp.sum(fn(p, xx) * g),
                      argnums=(0, 1))(params, jnp.asarray(x))
    (got * torch.from_numpy(g)).sum().backward()
    wants = {name: np.asarray(jgrads[1] if name == "x" else jgrads[0][name])
             for name, _ in [("x", tx), *te.named_parameters()]}
    # k_proj's bias has a zero gradient up to rounding (softmax ignores a
    # shift shared by every key): the scale is the largest gradient
    scale = max(float(np.abs(w).max()) for w in wants.values())
    for name, p in [("x", tx), *te.named_parameters()]:
        want = wants[name].T if p.dim() == 2 and name != "x" \
            else wants[name]
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=RTOL_GRAD * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("normalize_before", (False, True))
def test_decoder_and_transformer_match_jax(normalize_before):
    """A decoder layer under a causal target mask and a memory mask, and
    the whole ``Transformer`` (its encoder and decoder stacks, with the
    final norms pre-norm)."""
    dl_kw = dict(dropout=0.0, activation="gelu",
                 normalize_before=normalize_before)
    jd, td = _layer_pair(jnn.TransformerDecoderLayer,
                         nn.TransformerDecoderLayer, 20, 32, 4, 64, **dl_kw)
    tgt, mem = _x(2, 6, 32, seed=21), _x(2, 9, 32, seed=22)
    causal = np.tril(np.ones((6, 6), bool))[None, None]
    mmask = np.ones((2, 1, 6, 9), bool)
    mmask[0, ..., 7:] = False
    ref = jd(jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(causal),
             jnp.asarray(mmask))
    got = td(torch.from_numpy(tgt), torch.from_numpy(mem),
             torch.from_numpy(causal), torch.from_numpy(mmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    tr_kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
                 num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
                 normalize_before=normalize_before)
    pt.seed(23)
    jt = jnn.Transformer(**tr_kw)
    jt, tt = _load(nn.Transformer(device="cpu", **tr_kw), jt)
    src = _x(2, 9, 32, seed=24)
    ref = jt(jnp.asarray(src), jnp.asarray(tgt),
             tgt_mask=jnp.asarray(causal))
    got = tt(torch.from_numpy(src), torch.from_numpy(tgt),
             tgt_mask=torch.from_numpy(causal))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


def test_encoder_dropout_streams():
    """In training the stacked copies of one layer draw different masks
    from its one generator (deep copies share it), and a rebuilt encoder
    from the same seed draws the same ones."""
    def build(seed):
        layer = nn.TransformerEncoderLayer(
            32, 4, 64, dropout=0.5, device="cpu",
            generator=ptt.make_generator(seed, "cpu"))
        return nn.TransformerEncoder(layer, 2)

    x = torch.from_numpy(_x(2, 8, 32, seed=25))
    a, b = build(26), build(26)
    b.load_state_dict(a.state_dict())
    assert a.layers[0].dropout1.generator is a.layers[1].dropout1.generator
    assert torch.equal(a(x), b(x))
    a.eval()
    b.train()
    assert not torch.equal(a(x), b(x))
