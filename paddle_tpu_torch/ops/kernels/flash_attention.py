"""Flash-attention forward on Hopper, and its plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/flash_attention.py`` ``_flash_fwd``
(:149; kernel ``_fwd_kernel`` :83, masks ``_scores`` :58), the forward
that ``flash_attention_bshd`` (:465) reaches. Same function: FA-2 forward
with an online softmax, returning out and fp32 lse; causal mask aligned
bottom-right (offset sk - sq); optional sliding window; optional segment
ids; GQA query head hh reads kv head hh // (h // hk). The finite -1e30
mask value, the fp32 accumulation, ``p`` cast to V's type before the PV
product and the 1e-30 clamp of the final divide are the TPU kernel's.

Bound on the H100: at the prefill shape of Llama-3-8B (q [4, 512, 32,
128], k/v [4, 512, 8, 128], bf16, causal) the function moves about 42 MB
(q, k, v read once, out and lse written once: about 12.6 us at 3.35 TB/s)
and does about 8.6 GFLOP on the causal half (about 8.7 us at 989 TFLOP/s
in bf16), so its bound is the bytes.

Design (``csrc/flash_attention_fwd.cu``): the TPU's sequential kv grid
axis becomes a loop inside one block per (batch*head, 64-row q tile);
tiles wholly above the causal diagonal or before the window band are
never loaded. K/V tiles are staged in shared memory with an odd word
stride, so the score loop reads them without bank conflicts, and each
K/V element read from shared memory serves 4 query rows. This first
version does its products with fp32 FMAs on the CUDA cores, not on the
tensor cores, so it runs far from the byte bound; moving QK^T and PV onto
``wgmma`` with TMA-fed tiles is the next step.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, check_layout, use_kernel

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


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
    s = (qf @ kf.transpose(-1, -2)) * scale              # [b, h, sq, sk]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
    keep = keep[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
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
    the kernel, on the current stream, or raise."""
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
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_fwd", "flash_attention_fwd",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hk, d, float(scale), int(causal),
            0 if window is None else int(window), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
