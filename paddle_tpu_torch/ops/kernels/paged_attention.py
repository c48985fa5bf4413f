"""Grid paged attention (single-query paged decode) on Hopper, and its
plain PyTorch version.

Replaces: ``paddle_tpu/ops/pallas/paged_attention.py``
``paged_attention_pallas`` (:92; kernel ``_paged_kernel`` :47). Same
function: row r's single query sits at position ``seq_lens[r]`` and
attends tokens 0 .. seq_lens[r] of the row's paged K/V (a sliding window
keeps only the trailing ``window`` of them); GQA-native, each K/V block
read once per kv head for its whole query group; fp32 scores and
accumulator with the finite -1e30 mask, ``p`` cast to V's type before the
PV product, the final divide clamped at 1e-30. An idle row (seq_len 0)
attends position 0, as on the TPU. Table slots past a row's live count
may hold any index: they are never read. The JAX package selects it with
``PADDLE_TPU_PAGED_ATTN=grid``, and so does the port
(``generation/paged.py``).

Bound on the H100: the function must read each row's valid K/V positions
once per kv head: at R = 16, 8 kv heads, d = 128, bf16 and seq_lens near
540 that is about 36 MB, about 11 us at 3.35 TB/s; its 4 FLOP per
position, query head and dim are far below the tensor-core rate, so the
bound is the bytes, counted from the run's ``seq_lens``.

Design (``csrc/paged_attention.cu``): the TPU kernel's fixed (R, kvh, M)
grid, with the table slots as its sequential innermost axis and an index
map that clamps dead slots to the last live block, becomes one block per
(row, kv head) that reads ``seq_lens[r]`` and its table row from device
memory and loops over its slots from the first in-window one to the last
live one. The launch shape depends only on (R, h, kvh, M, B, d): the
wrapper reads nothing of ``seq_lens`` or the tables on the host and
allocates only the output, so a call can be captured in a CUDA graph.
It keeps the ragged kernel's tiles and order of sums, so without a window
the two agree bit for bit. What holds it back is what holds the ragged
kernel back: R x kvh blocks (128 at R = 16) on 132 SMs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, check_layout, stream_of, use_kernel
from .ragged_paged_attention import (DTYPES, HEAD_DIMS,
                                     ragged_paged_attention_plain)

MAX_GROUP = 32      # query heads per kv head the kernel holds

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(q, kp, vp, block_tables, seq_lens, window):
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"want q [R, h, d] and pools [P, B, kvh, d]; got "
                         f"{tuple(q.shape)}, {tuple(kp.shape)}, "
                         f"{tuple(vp.shape)}")
    R, h, d = q.shape
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
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def paged_attention_plain(q, kp, vp, block_tables, seq_lens,
                          scale: Optional[float] = None,
                          window: Optional[int] = None):
    """The same function in plain PyTorch: the single-query case of the
    ragged kernel's plain version (a gather of each row's whole table and a
    mask, with the kernels' rounding points)."""
    _check(q, kp, vp, block_tables, seq_lens, window)
    return ragged_paged_attention_plain(q, kp, vp, block_tables, seq_lens,
                                        scale, window)


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [R, h, d]; kp/vp [P, B, kvh, d] pools; block_tables [R, M] and
    seq_lens [R], int32. Returns [R, h, d].

    CPU tensors take :func:`paged_attention_plain`; CUDA tensors launch the
    kernel, on the current stream, or raise."""
    _check(q, kp, vp, block_tables, seq_lens, window)
    if not use_kernel(q, kp, vp, block_tables, seq_lens):
        return paged_attention_plain(q, kp, vp, block_tables, seq_lens,
                                     scale, window)
    check_layout(q=q, kp=kp, vp=vp, block_tables=block_tables,
                 seq_lens=seq_lens)
    R, h, d = q.shape
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    fn = _build.entry("paged_attention", "paged_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            R, h, kvh, d, M, B, float(scale),
            0 if window is None else int(window), DTYPES[q.dtype],
            stream_of(q))
    _build.check("paged_attention", rc)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
