"""Single-query decode attention over a static KV cache on Hopper, and its
plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/decode_attention.py``
``decode_attention_pallas`` (:161; kernel ``_decode_kernel`` :113). Same
function: one query per row and head over a cache [b, T, kv, d];
positions 0..cache_index attend, only the trailing ``window`` of them
with a sliding window; GQA-native, each K/V row read once per kv head for
its whole query group; fp32 softmax and accumulation with the finite
-1e30 mask, ``p`` cast to V's type before the PV product and the 1e-30
clamp of the final divide. The TPU kernel's (8, 128) tiling and its
head-pair zero-embedding serve Mosaic's layout rules and are not carried
over.

Bound on the H100: the function must read the valid K/V positions once.
For Llama-3-8B at b=4, kv=8, d=128, bf16 and cache_index 639 that is
about 10.5 MB, about 3.1 us at 3.35 TB/s; its 4 FLOP per position and
query dim are far below the tensor-core rate, so the bound is the bytes,
and at a smaller cache_index only the valid positions count.

Design (``csrc/decode_attention.cu``): the TPU's sequential T grid axis
becomes a loop inside one block per (row, kv head). Each lane owns d/32
contiguous dims of the group's queries; warps take interleaved runs of
positions and load a whole run's K and V rows before using them, so
several loads are in flight per warp; the 8 warps' partial softmaxes
merge through shared memory at the end. Positions past ``cache_index``
or before the window are never read. With one block per (row, kv head),
a batch of 4 over 8 kv heads fills only 32 of the 132 SMs; splitting T
across blocks (a second merge pass) is the next step.
"""
from __future__ import annotations

import ctypes
import math
import operator
from typing import Optional

import torch

from . import _build, check_layout, use_kernel

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def _check(q, k_cache, v_cache, cache_index, window):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q [b, h, d] and caches [b, T, kv, d]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, T, kv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or h % kv:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"q and caches must share one of {list(DTYPES)}; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if not 0 <= cache_index < T:
        raise ValueError(f"cache_index {cache_index} outside [0, {T})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def decode_attention_fwd_plain(q, k_cache, v_cache, cache_index: int,
                               scale: Optional[float] = None, window=None):
    """The same function in plain PyTorch, over the whole cache: [b, h, d]
    in q's dtype."""
    cache_index = operator.index(cache_index)
    _check(q, k_cache, v_cache, cache_index, window)
    b, h, d = q.shape
    T, kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qg = q.float().reshape(b, kv, h // kv, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    pos = torch.arange(T, device=q.device)
    keep = pos <= cache_index
    if window is not None:
        keep = keep & (pos > cache_index - window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float()) / safe_l
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_index: int,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q [b, h, d]; k/v_cache [b, T, kv, d]; ``cache_index`` is a Python
    int, the write position of the current token. Returns [b, h, d].

    CPU tensors take :func:`decode_attention_fwd_plain`; CUDA tensors
    launch the kernel, on the current stream, or raise."""
    cache_index = operator.index(cache_index)
    _check(q, k_cache, v_cache, cache_index, window)
    if not use_kernel(q, k_cache, v_cache):
        return decode_attention_fwd_plain(q, k_cache, v_cache, cache_index,
                                          scale, window)
    check_layout(q=q, k_cache=k_cache, v_cache=v_cache)
    b, h, d = q.shape
    T, kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention", "decode_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, T, h, kv, d, cache_index, float(scale),
            0 if window is None else int(window), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", rc)
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0
