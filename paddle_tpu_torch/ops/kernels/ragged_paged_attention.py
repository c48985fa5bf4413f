"""Ragged paged attention on Hopper, and its plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/ragged_paged_attention.py``
``ragged_paged_attention_pallas`` (:164; kernel ``_ragged_kernel`` :106,
schedule ``build_schedule`` :70). Same function: query t of row r sits at
position ``seq_lens[r] + t`` and attends positions 0 .. seq_lens[r] + t of
the row's paged K/V (a sliding window keeps only the trailing ``window``
of them); GQA-native; fp32 scores and accumulator with the finite -1e30
mask, ``p`` cast to V's type before the PV product, the final divide
clamped at 1e-30. Single-query rows q [R, h, d] (the decode tick) and
multi-query rows q [R, T, h, d] (the speculative verify) both run. Every
row attends at least one position: an idle row (seq_len 0, table of
zeros) attends position 0 of garbage block 0, as on the TPU.

Bound on the H100: the function must read each row's valid K/V positions
once (per kv head, for all its query heads): at R = 16, 8 kv heads,
d = 128, bf16 and a mean seq_len near 540 that is about 36 MB, about 11 us
at 3.35 TB/s. Its 4 FLOP per position, query head and dim are far below
the tensor-core rate, so the bound is the bytes, counted from the run's
``seq_lens``.

Design (``csrc/ragged_paged_attention.cu``). The TPU kernel flattens the
work into a live-first ``(kvh, S = R*M)`` schedule because a Pallas grid
runs in order on one core and every dead grid step costs scalar work. On
Hopper blocks run in parallel and a block can read its own indices, so
there is no schedule: one block per (row, kv head) reads ``seq_lens[r]``
and the row's table entries from device memory, loops over that row's
live positions only, holds the head's T x group query rows, and streams
each physical K/V row once, one tile ahead of the compute. What holds it
back: R x kvh blocks (128 at R = 16) on 132 SMs, and one long row holds up
the whole launch. Split-KV over a flat work list of (row, position-range)
items with a merge pass is the later fix (and brings ``build_schedule``
back).

The launch shape depends only on static shapes (R, T, h, kvh, M, B, d),
the wrapper reads nothing of ``seq_lens`` or the tables on the host and
allocates only the output, so a call can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, check_layout, stream_of, use_kernel

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_ROWS = 32       # T x (query heads per kv head) the kernel holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(q, kp, vp, block_tables, seq_lens, window):
    if q.dim() not in (3, 4) or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"want q [R, h, d] or [R, T, h, d] and pools "
                         f"[P, B, kvh, d]; got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    R, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    T = q.shape[1] if q.dim() == 4 else 1
    kvh = kp.shape[2]
    if kp.shape[3] != d or h % kvh:
        raise ValueError(f"pools {tuple(kp.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != R \
            or tuple(seq_lens.shape) != (R,):
        raise ValueError(f"want block_tables [R, M] and seq_lens [R] for "
                         f"R = {R}; got {tuple(block_tables.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"block_tables and seq_lens must be int32; got "
                        f"{block_tables.dtype}, {seq_lens.dtype}")
    if (q.dtype not in DTYPES or kp.dtype != q.dtype
            or vp.dtype != q.dtype):
        raise TypeError(f"q and pools must share one of {list(DTYPES)}; "
                        f"got {q.dtype}, {kp.dtype}, {vp.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if T * (h // kvh) > MAX_ROWS:
        raise ValueError(f"{T} queries x {h // kvh} heads per kv head; the "
                         f"kernel takes at most {MAX_ROWS} query rows")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def ragged_paged_attention_plain(q, kp, vp, block_tables, seq_lens,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """The same function in plain PyTorch: gather each row's whole table
    ``kp[block_tables]`` and mask, with the kernel's rounding points.
    Returns q's shape and dtype."""
    _check(q, kp, vp, block_tables, seq_lens, window)
    qq = q if q.dim() == 4 else q[:, None]
    R, T, h, d = qq.shape
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    tbl = block_tables.long()
    ks = kp[tbl].reshape(R, M * B, kvh, d).float()
    vs = vp[tbl].reshape(R, M * B, kvh, d)
    qg = qq.float().reshape(R, T, kvh, h // kvh, d)
    s = torch.einsum("rtkgd,rskd->rtkgs", qg, ks) * scale
    kpos = torch.arange(M * B, device=q.device)
    qpos = seq_lens.long()[:, None] + torch.arange(T, device=q.device)
    keep = kpos[None, None, :] <= qpos[:, :, None]               # [R, T, S]
    if window is not None:
        keep = keep & (kpos[None, None, :] > qpos[:, :, None] - window)
    s = torch.where(keep[:, :, None, None, :], s, torch.full_like(s,
                                                                  NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("rtkgs,rskd->rtkgd", p.to(vp.dtype).float(),
                       vs.float()) / safe_l
    out = out.reshape(R, T, h, d).to(q.dtype)
    return out if q.dim() == 4 else out[:, 0]


def ragged_paged_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """q [R, h, d] or [R, T, h, d]; kp/vp [P, B, kvh, d] pools;
    block_tables [R, M] and seq_lens [R], int32. Returns q's shape.

    CPU tensors take :func:`ragged_paged_attention_plain`; CUDA tensors
    launch the kernel, on the current stream, or raise."""
    _check(q, kp, vp, block_tables, seq_lens, window)
    if not use_kernel(q, kp, vp, block_tables, seq_lens):
        return ragged_paged_attention_plain(q, kp, vp, block_tables,
                                            seq_lens, scale, window)
    check_layout(q=q, kp=kp, vp=vp, block_tables=block_tables,
                 seq_lens=seq_lens)
    R, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    T = q.shape[1] if q.dim() == 4 else 1
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    fn = _build.entry("ragged_paged_attention", "ragged_paged_attention_fwd",
                      _ARGTYPES)
    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            R, T, h, kvh, d, M, B, float(scale),
            0 if window is None else int(window), DTYPES[q.dtype],
            stream_of(q))
    _build.check("ragged_paged_attention", rc)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
