"""Single-query decode attention over a static KV cache on Hopper, and its
plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/decode_attention.py``
``decode_attention_pallas`` (:161; kernel ``_decode_kernel`` :113). Same
function: one query per row and head over a cache [b, T, kv, d];
positions 0..cache_index attend, only the trailing ``window`` of them
with a sliding window; GQA-native, each K/V row read once per kv head for
its whole query group; fp32 softmax and accumulation with the finite
-1e30 mask, ``p`` cast to V's type before the PV product and the 1e-30
clamp of the final divide; fp32, bf16 or fp16 in, out in q's dtype. The
TPU kernel's (8, 128) tiling and its head-pair zero-embedding serve
Mosaic's layout rules and are not carried over.

Bound on the H100: the function must read the valid K/V positions once.
For Llama-3-8B at b=4, kv=8, d=128, bf16 and cache_index 639 that is
about 10.5 MB, about 3.1 us at 3.35 TB/s; its 4 FLOP per position and
query dim are far below the tensor-core rate, so the bound is the bytes,
and at a smaller cache_index only the valid positions count.

Design (``csrc/decode_attention.cu``): the TPU's sequential T grid axis
becomes a split of T across blocks. Each (row, kv head) takes ``splits``
blocks (:func:`decode_splits`: from T, b * kv and the card's SM count
alone, never from ``cache_index``, so the launch shape is the same at
every step and a CUDA graph of the step can replay it); split s covers
positions [s * chunk, (s + 1) * chunk), and a split with no attended
position returns at once. Two kernels, chosen from the dtype alone
(:func:`decode_route`), never after a failure: ``mma`` (bf16, fp16)
stages 16 positions of K and V at a time per warp with cp.async and runs
S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16, the
group's query heads as the rows); ``simt`` (fp32, which the 16-bit
tensor-core products cannot hold exactly) reads each row with 16-byte
loads spread over d / 4 lanes and sums the scores over them. Every K/V
row is read once for the whole query group. The splits merge in the
same launch: the last live block of a (row, kv head) to arrive at its
counter (an atomic add) merges the live splits' (m, l, acc) from a
workspace in split order, whatever the order of arrival, so two runs
give the same bits; with one live split the block writes the output
itself. ``launches`` stays one per call, counted by route in
``launches_by_route``. The workspace and the counters are kept per card
and reused (the kernel leaves the counters at 0), so the wrapper
allocates only the output; calls that run concurrently on two streams of
one card would share them.
"""
from __future__ import annotations

import ctypes
import math
import operator
from typing import Dict, Optional, Tuple

import torch

from . import (_build, check_layout, count_launch, sm_count, stream_of,
               use_kernel)

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the least positions a split covers: below this a block's fixed costs
# (loading the queries, the merge) outweigh its share of the rows
MIN_CHUNK = 64
MAX_SPLITS = 64     # the kernel's merge holds at most this many

ROUTES = ("mma", "simt")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# per card: the (workspace, counters) scratch
_scratch: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


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


def decode_route(dtype: torch.dtype) -> str:
    """The kernel a call launches: ``"mma"`` (tensor cores) for bf16 and
    fp16, ``"simt"`` (CUDA-core FMAs) for fp32."""
    return "simt" if dtype == torch.float32 else "mma"


def decode_splits(T: int, pairs: int, sms: int) -> int:
    """Blocks along T per (row, kv head) for ``pairs`` = b * kv of them:
    at most one block per SM in all (more splits cost more in the merge
    than they gain in parallel reads), each over at least ``MIN_CHUNK``
    positions of the cache. Depends on the static shapes and the card
    alone, never on ``cache_index``."""
    return max(1, min(-(-T // MIN_CHUNK), sms // pairs, MAX_SPLITS))


def _scratch_for(dev: torch.device, floats: int, pairs: int):
    """The card's fp32 workspace of at least ``floats`` elements and its
    int32 counters (at least ``pairs``, all 0), grown when too small."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    work, arrivals = _scratch.get(idx, (None, None))
    if work is None or work.numel() < floats or arrivals.numel() < pairs:
        work = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
        arrivals = torch.zeros(max(pairs, 1), dtype=torch.int32, device=dev)
        _scratch[idx] = (work, arrivals)
    return work, arrivals


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
    splits = decode_splits(T, b * kv, sm_count(q))
    work, arrivals = _scratch_for(q.device, b * kv * splits * (h // kv)
                                  * (d + 2), b * kv)
    route = decode_route(q.dtype)
    out = torch.empty_like(q)
    fn = _build.entry("decode_attention", f"decode_attention_fwd_{route}",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), work.data_ptr(), arrivals.data_ptr(), b, T, h,
            kv, d, cache_index, float(scale),
            0 if window is None else int(window), splits, DTYPES[q.dtype],
            stream_of(q))
    _build.check("decode_attention", rc)
    count_launch(decode_attention_fwd, route)
    return out


decode_attention_fwd.launches = 0
decode_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
