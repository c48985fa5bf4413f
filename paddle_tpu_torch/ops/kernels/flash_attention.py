"""Flash-attention forward on Hopper, and its plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/flash_attention.py`` ``_flash_fwd``
(:149; kernel ``_fwd_kernel`` :83, masks ``_scores`` :58), the forward
that ``flash_attention_bshd`` (:465) reaches. Same function: FA-2 forward
with an online softmax, returning out and fp32 lse; causal mask aligned
bottom-right (offset sk - sq); optional sliding window; optional segment
ids; GQA query head hh reads kv head hh // (h // hk). The finite -1e30
mask value, the fp32 accumulation, ``p`` cast to V's type before the PV
product and the 1e-30 clamp of the final divide are the TPU kernel's.

Types: fp32, bf16 and fp16 in, out in the inputs' type, lse fp32. The
mask value, the running max and lse stay in fp32 on every route, as in
the TPU kernel's ``_scores`` (fp16 has no finite -1e30).

Routes, chosen from the dtype and head dim alone (:func:`flash_route`),
never after a failure: bf16 or fp16 at d in {64, 128} takes the ``wgmma``
kernel; fp32 (wgmma has no fp32 product, and TF32 would break the fp32
checks) and d = 256 take the ``simt`` kernel. A failed build or launch
raises. Each wrapper (the forward, dq and dk/dv) counts its launches, in
all and by route (``launches_by_route``).

Bound on the H100: at the prefill shape of Llama-3-8B (q [4, 512, 32,
128], k/v [4, 512, 8, 128], bf16, causal) the function moves about 42 MB
(q, k, v read once, out and lse written once: about 12.6 us at 3.35 TB/s)
and does about 8.6 GFLOP on the causal half (about 8.7 us at 989 TFLOP/s
in bf16), so its bound is the bytes. At the training shape (q [2, 2048,
32, 128], k/v [2, 2048, 8, 128]) it does 68.7 GFLOP against 84 MB, so
its bound is the operations: 69.5 us.

Design (``csrc/flash_attention_fwd.cu``). ``wgmma``: the TPU's
sequential kv grid axis becomes a loop inside one block per (batch*head,
128-row q tile) with two consumer warpgroups of 64 rows and a producer
warpgroup that hands them its registers. The producer loads Q once and
streams 128-key K/V tiles through a ring of 3 shared-memory stages by TMA
(128-byte swizzle, mbarriers), so copies overlap the products; S = Q K^T
and O += P V run on the tensor cores (``wgmma``), the online softmax on
the fp32 accumulator fragment while the last tile's P V is in flight,
and p becomes the register operand of P V without a trip through shared
memory. Tiles wholly above the causal diagonal or before the window band
are never loaded; the per-element masks run only on tiles that need
them. ``simt``: one block per (batch*head, 64-row q tile),
K/V tiles staged with an odd word stride and the products as fp32 FMAs on
the CUDA cores, far from either bound.

Backward: ``flash_attention_bwd`` replaces ``_flash_bwd`` (:307), which
reaches two TPU kernels, ``_bwd_dq_kernel`` (:208, call :375) and
``_bwd_dkv_kernel`` (:253, call :389). Same function: delta =
rowsum(dout * out) in fp32 (a torch reduction, outside the kernels, as
the JAX package keeps it outside the ``pallas_call``); p recomputed from
the forward's lse with the same masks; ds = p * (dp - delta) * scale; p
cast to dout's type before p^T dout, ds to q/k's type before ds K and
ds^T q, the outputs cast once at the end. ``FlashAttentionFunction`` is
the counterpart of the ``custom_vjp`` wiring (``_flash``, ``_flash_seg``
:415-462).

Bound of the backward on the H100: at the training shape of the slice (q
[2, 2048, 32, 128], k/v [2, 2048, 8, 128], bf16, causal) the function
does 5 products of 2 * d FLOP per live (row, key) pair (s, dp, dq, dk,
dv: about 172 GFLOP, 0.174 ms at 989 TFLOP/s) and moves about 170 MB
(0.05 ms), so it is bound by operations. The TPU split recomputes s and
dp in both kernels: on that work the dq kernel's bound is 3 products and
the dk/dv kernel's 4.

Design (``csrc/flash_attention_bwd.cu``): dq takes one block per
(batch*head, q tile) and loops over the live kv tiles; dk/dv takes one
block per (batch*kv head, kv tile) and loops over the GQA group's query
heads and their live q tiles, so no head repeat is materialised and no
atomics are needed: each output element is summed by one block in a
fixed order and two runs give the same bits. The blocks with the most
live tiles under the causal mask (the last q tiles for dq, the first kv
tiles for dk/dv) are launched first. Both kernels have the forward's two
routes. dq on ``wgmma`` keeps a 128-row Q and dout tile in shared memory
and, in two consumer warpgroups of 64 rows, the fp32 dQ accumulator in
registers, while a producer thread streams 64-key K and V tiles of the
kv head by TMA; its three products run on the tensor cores (ds as the
register operand of dS K) and each thread keeps the lse and delta of its
fixed rows in registers. dk/dv on ``wgmma`` keeps a 128-key K/V tile in
shared memory and, in two consumer warpgroups of 64 keys, the fp32 dK,
dV accumulators in registers, while a producer warp streams 64-row q and
dout tiles by TMA; all four products run on the tensor cores (p and ds
as register operands). The ``simt`` kernels run theirs as fp32 FMAs on
the CUDA cores from shared-memory tiles of packed 16-bit words, two
blocks per SM at d <= 128.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, check_layout, count_launch, stream_of, use_kernel

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("wgmma", "simt")
WGMMA_DTYPES = (torch.bfloat16, torch.float16)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_BWD_TAIL = ([ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_DQ_ARGTYPES = [ctypes.c_void_p] * 8 + _BWD_TAIL
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + _BWD_TAIL


def _check(q, k, v, causal, window, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [b, sq, h, d] and k, v [b, sk, hk, d]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if segment_ids is not None and (tuple(segment_ids.shape) != (b, sq)
                                    or k.shape[1] != sq):
        raise ValueError(f"segment_ids must be [b, s] = {(b, sq)} with "
                         f"sq == sk; got {tuple(segment_ids.shape)}")


def _masked_scores(qf, kf, scale, causal, window, segment_ids):
    """fp32 scores [b, h, sq, sk] of q [b, h, sq, d] against k [b, h, sk,
    d], with the kernels' masks at the finite NEG_INF: causal aligned
    bottom-right (offset sk - sq), the window band, segment equality."""
    sq, sk = qf.shape[2], kf.shape[2]
    s = (qf @ kf.transpose(-1, -2)) * scale
    keep = torch.ones(sq, sk, dtype=torch.bool, device=qf.device)
    if causal:
        qpos = torch.arange(sq, device=qf.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=qf.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
    keep = keep[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return torch.where(keep, s, torch.full_like(s, NEG_INF))


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that the forward and both backward kernels launch for
    this dtype and head dim: ``"wgmma"`` (tensor cores, TMA) for bf16 or
    fp16 at d 64 or 128, else ``"simt"`` (CUDA-core FMAs)."""
    if dtype in WGMMA_DTYPES and head_dim in (64, 128):
        return "wgmma"
    return "simt"


def _count(fn, route):
    count_launch(fn, route)


def _reset_counts(fn):
    fn.launches = 0
    fn.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale=None,
                              window=None, segment_ids=None):
    """The same function in plain PyTorch, over the whole score matrix:
    (out [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32)."""
    _check(q, k, v, causal, window, segment_ids)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    group = h // hk
    qf = q.float().transpose(1, 2)                       # [b, h, sq, d]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(group, dim=1)
    s = _masked_scores(qf, kf, scale, causal, window, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p.to(v.dtype).float() @ vt.float()) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return out.to(q.dtype).transpose(1, 2).contiguous(), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward on [b, s, h, d] tensors: (out, lse [b, h,
    sq] fp32). ``segment_ids`` [b, s] (0 = pad) keeps attention inside a
    segment; ``window`` (causal only) keeps the trailing ``window`` keys.

    CPU tensors take :func:`flash_attention_fwd_plain`; CUDA tensors launch
    the kernel of :func:`flash_route`, on the current stream, or raise."""
    _check(q, k, v, causal, window, segment_ids)
    extra = [] if segment_ids is None else [segment_ids]
    if not use_kernel(q, k, v, *extra):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                         window=window,
                                         segment_ids=segment_ids)
    check_layout(q=q, k=k, v=v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    route = flash_route(q.dtype, d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_fwd", f"flash_attention_fwd_{route}",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hk, d, float(scale), int(causal),
            0 if window is None else int(window), DTYPES[q.dtype],
            stream_of(q))
    _build.check("flash_attention_fwd", rc)
    _count(flash_attention_fwd, route)
    return out, lse


_reset_counts(flash_attention_fwd)


# ---------------------------------------------------------------- backward
def _check_bwd(q, k, v, out, lse, dout, causal, window, segment_ids):
    _check(q, k, v, causal, window, segment_ids)
    b, sq, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}; got {out.dtype}, "
                        f"{dout.dtype}")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [b, h, sq] = {(b, h, sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def _delta(out, dout):
    """rowsum(dout * out) in fp32, [b, h, sq] like lse."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, out, lse, dout, causal, scale, window, segment_ids,
               dq_part, dkv_part):
    """The plain FA-2 backward; forms dq (``dq_part``) and/or dk, dv
    (``dkv_part``), as a list in that order."""
    _check_bwd(q, k, v, out, lse, dout, causal, window, segment_ids)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    group = h // hk
    qf = q.float().transpose(1, 2)                       # [b, h, sq, d]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    gf = dout.float().transpose(1, 2)
    s = _masked_scores(qf, kf, scale, causal, window, segment_ids)
    p = torch.exp(s - lse[..., None])
    dp = gf @ vf.transpose(-1, -2)
    ds = (p * (dp - _delta(out, dout)[..., None]) * scale).to(q.dtype).float()
    grads = []
    if dq_part:
        grads.append((ds @ kf).to(q.dtype))               # [b, h, sq, d]
    if dkv_part:
        p = p.to(dout.dtype).float()
        dk = (ds.transpose(-1, -2) @ qf).reshape(b, hk, group, sk, d).sum(2)
        dv = (p.transpose(-1, -2) @ gf).reshape(b, hk, group, sk, d).sum(2)
        grads += [dk.to(k.dtype), dv.to(v.dtype)]
    return [t.transpose(1, 2).contiguous() for t in grads]


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=False,
                              scale=None, window=None, segment_ids=None):
    """The backward in plain PyTorch, as the explicit FA-2 formula over the
    whole score matrix (not autograd through the forward): p recomputed
    from ``lse``, ds = p * (dp - delta) * scale, with the kernels'
    rounding points. Returns (dq, dk, dv) in the inputs' dtype."""
    return tuple(_bwd_plain(q, k, v, out, lse, dout, causal, scale, window,
                            segment_ids, True, True))


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, *, causal=False,
                                 scale=None, window=None, segment_ids=None):
    """The dq kernel's plain version: dq alone (s, dp and ds @ K: three
    products), as :func:`flash_attention_bwd_plain` forms it."""
    return _bwd_plain(q, k, v, out, lse, dout, causal, scale, window,
                      segment_ids, True, False)[0]


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, *, causal=False,
                                  scale=None, window=None, segment_ids=None):
    """The dk/dv kernel's plain version: (dk, dv) alone (s, dp, ds^T q and
    p^T dout: four products), as :func:`flash_attention_bwd_plain` forms
    them."""
    return tuple(_bwd_plain(q, k, v, out, lse, dout, causal, scale, window,
                            segment_ids, False, True))


def _bwd_args(q, k, v, dout, lse, delta, seg, causal, scale, window):
    extra = [] if seg is None else [seg]
    if not use_kernel(q, k, v, dout, lse, delta, *extra):
        raise ValueError("the backward kernels take CUDA tensors; "
                         "flash_attention_bwd routes CPU tensors to the "
                         "plain version")
    check_layout(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             None if seg is None else seg.data_ptr()],
            [b, sq, sk, h, hk, d, float(scale), int(causal),
             0 if window is None else int(window), DTYPES[q.dtype],
             stream_of(q)])


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, seg, *, causal,
                           scale, window):
    """Launch the dq kernel of :func:`flash_route` on CUDA tensors
    (contiguous; ``delta`` and ``lse`` fp32 [b, h, sq], ``seg`` int32 or
    None). Returns dq."""
    ptrs, tail = _bwd_args(q, k, v, dout, lse, delta, seg, causal, scale,
                           window)
    route = flash_route(q.dtype, q.shape[3])
    dq = torch.empty_like(q)
    fn = _build.entry("flash_attention_bwd",
                      f"flash_attention_bwd_dq_{route}", _DQ_ARGTYPES)
    _build.check("flash_attention_bwd", fn(*ptrs, dq.data_ptr(), *tail))
    _count(flash_attention_bwd_dq, route)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, seg, *, causal,
                            scale, window):
    """Launch the dk/dv kernel of :func:`flash_route` on CUDA tensors (as
    :func:`flash_attention_bwd_dq`). Returns (dk, dv)."""
    ptrs, tail = _bwd_args(q, k, v, dout, lse, delta, seg, causal, scale,
                           window)
    route = flash_route(q.dtype, q.shape[3])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.entry("flash_attention_bwd",
                      f"flash_attention_bwd_dkv_{route}", _DKV_ARGTYPES)
    _build.check("flash_attention_bwd",
                 fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail))
    _count(flash_attention_bwd_dkv, route)
    return dk, dv


_reset_counts(flash_attention_bwd_dq)
_reset_counts(flash_attention_bwd_dkv)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=False,
                        scale=None, window=None, segment_ids=None):
    """Flash-attention backward on [b, s, h, d] tensors: (dq, dk, dv) from
    the forward's inputs, its ``out`` and fp32 ``lse`` [b, h, sq], and the
    output's gradient ``dout``.

    CPU tensors take :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the dq and the dk/dv kernels, on the current stream, or raise."""
    _check_bwd(q, k, v, out, lse, dout, causal, window, segment_ids)
    extra = [] if segment_ids is None else [segment_ids]
    if not use_kernel(q, k, v, out, lse, dout, *extra):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, scale=scale,
                                         window=window,
                                         segment_ids=segment_ids)
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    delta = _delta(out, dout)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, seg, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, seg, **kw)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its own backward (the counterpart of the JAX
    package's ``custom_vjp`` wiring, ``_flash`` / ``_flash_seg``): the
    forward saves q, k, v, out and the fp32 lse; the backward runs
    :func:`flash_attention_bwd`, the kernels on the card and the plain
    formula on the CPU. ``segment_ids`` gets no gradient.

        out = FlashAttentionFunction.apply(q, k, v, causal, scale, window,
                                           segment_ids)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, window=None,
                segment_ids=None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       window=window,
                                       segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.opts = dict(causal=causal, scale=scale, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         segment_ids=segment_ids,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
