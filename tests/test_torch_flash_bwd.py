"""The port's flash-attention backward against the JAX package's.

On the CPU ``flash_attention_bwd`` runs its plain version (the explicit
FA-2 formula), and ``FlashAttentionFunction``'s backward goes through it.
Both are held against ``jax.grad`` of
``paddle_tpu.ops.pallas.flash_attention.flash_attention_bshd``, whose
backward reaches the two Pallas backward kernels in interpret mode. The
inputs and the output gradient are made from a seed with numpy.
``test_torch_kernels_gpu.py`` holds the CUDA kernels against the plain
version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import flash_attention_bshd
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttentionFunction, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
    flash_attention_fwd)

# fp32 on the CPU: the same products summed in another order by XLA and
# torch; gradients of magnitude ~1 stay within 1e-4
ATOL_FP32 = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(b, sq, sk, h, kv, d, seed=0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rs.randn(b, sk, kv, d) * 0.5).astype(np.float32)
    v = rs.randn(b, sk, kv, d).astype(np.float32)
    g = rs.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, g


def _segments(b, s, seed=0):
    """Three packed segments per row and a pad tail (id 0)."""
    rs = np.random.RandomState(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        a, c = sorted(rs.choice(np.arange(16, s - 16), 2, replace=False))
        seg[i, :a], seg[i, a:c], seg[i, c:s - 8] = 1, 2, 3
    return seg


def _jax_grads(q, k, v, g, causal, window=None, seg=None):
    def loss(q, k, v):
        out = flash_attention_bshd(
            q, k, v, causal=causal, block_q=128, block_k=128, window=window,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(g))
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in grads]


CASES = [
    dict(causal=True, sq=256),
    dict(causal=False, sq=128),
    dict(causal=True, sq=256, window=40),
    dict(causal=True, sq=256, seg=True),
    dict(causal=False, sq=128, seg=True),
    dict(causal=True, sq=128, h=8, kv=2),             # GQA group 4
    dict(causal=True, sq=128, sk=256),                 # sk > sq
    dict(causal=False, sq=128, sk=256),
]
IDS = ["causal", "full", "window", "segments", "segments-full", "group4",
       "causal-longer-keys", "full-longer-keys"]


def _case(case, seed=0):
    b, d = 2, 64
    sq = case["sq"]
    sk = case.get("sk", sq)
    h, kv = case.get("h", 4), case.get("kv", 2)
    q, k, v, g = _inputs(b, sq, sk, h, kv, d, seed)
    seg = _segments(b, sq, seed) if case.get("seg") else None
    return q, k, v, g, seg


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_backward_matches_jax_grad(pallas_interpret, case):
    """``FlashAttentionFunction`` forward + ``.backward(g)`` vs ``jax.grad``
    of the Pallas flash kernel (interpret), fp32, within 1e-4."""
    q, k, v, g, seg = _case(case)
    window = case.get("window")
    ref = _jax_grads(q, k, v, g, case["causal"], window, seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = FlashAttentionFunction.apply(
        tq, tk, tv, case["causal"], None, window,
        None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(g))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[6]],
                         ids=["causal", "segments", "causal-longer-keys"])
def test_plain_backward_matches_jax_grad(pallas_interpret, case):
    """``flash_attention_bwd_plain`` called directly on the forward's out
    and lse vs ``jax.grad``, fp32, within 1e-4."""
    q, k, v, g, seg = _case(case, seed=1)
    ref = _jax_grads(q, k, v, g, case["causal"], seg=seg)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = flash_attention_fwd(tq, tk, tv, causal=case["causal"],
                                   segment_ids=tseg)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg,
                                    causal=case["causal"], segment_ids=tseg)
    for a, want in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), want, atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_parts_equal_the_whole_plain_backward(dtype):
    """The dq-only and dk/dv-only plain versions (each kernel's own) give
    the bits of the whole plain backward, GQA group 2 with segments."""
    q, k, v, g, seg = _case(CASES[3], seed=5)
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    kw = dict(causal=True, segment_ids=torch.from_numpy(seg))
    out, lse = flash_attention_fwd(tq, tk, tv, **kw)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, **kw)
    assert torch.equal(
        flash_attention_bwd_dq_plain(tq, tk, tv, out, lse, tg, **kw), dq)
    pk, pv = flash_attention_bwd_dkv_plain(tq, tk, tv, out, lse, tg, **kw)
    assert torch.equal(pk, dk) and torch.equal(pv, dv)


def test_plain_backward_matches_autograd_of_dense_attention():
    """An independent check with no JAX: the FA-2 formula equals torch
    autograd through ``dense_attention`` (causal, GQA, window)."""
    q, k, v, g, _ = _case(dict(sq=128), seed=2)
    args = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    port_attn.dense_attention(*args, causal=True, window=50).backward(
        torch.from_numpy(g).double())
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True, window=50)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tg, causal=True,
                              window=50)
    for a, ref in zip(got, args):
        np.testing.assert_allclose(a.numpy(), ref.grad.numpy(),
                                   atol=ATOL_FP32, rtol=0)


def test_attention_output_carries_the_flash_backward():
    """The fault fixed here: ``ops.attention.flash_attention`` returns a
    tensor whose grad_fn is ``FlashAttentionFunction``'s, so gradients
    flow through attention on the card as on the CPU; the CPU backward
    counts no kernel launch."""
    q, k, v, g, _ = _case(dict(sq=128), seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_attn.flash_attention(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    n = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    out.backward(torch.from_numpy(g))
    assert all(float(x.grad.abs().sum()) > 0 for x in (tq, tk, tv))
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == n


def test_strided_output_gradient_is_taken():
    """Autograd may hand the backward a strided view of dout; the Function
    makes it contiguous and gives the same gradients."""
    q, k, v, g, _ = _case(dict(sq=128), seed=4)
    grads = []
    for strided in (False, True):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        out, _ = FlashAttentionFunction.apply(tq, tk, tv, True)
        tg = torch.from_numpy(g)
        if strided:
            # a transposed copy viewed back: same values, other strides
            tg = tg.transpose(1, 2).contiguous().transpose(1, 2)
            assert not tg.is_contiguous()
        out.backward(tg)
        grads.append([x.grad for x in (tq, tk, tv)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_backward_rejects_mismatched_inputs():
    q, k, v, g, _ = _case(dict(sq=128))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(tq, tk, tv, out, lse[:, :1], tg, causal=True)
    with pytest.raises(TypeError, match="dout"):
        flash_attention_bwd(tq, tk, tv, out, lse, tg.double(), causal=True)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention_bwd(tq, tk, tv, out, lse,
                            torch.empty_like(tg, device="meta"), causal=True)
