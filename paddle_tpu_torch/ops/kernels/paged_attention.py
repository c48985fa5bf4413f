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

Design (``csrc/paged_attention.cu``). Two kernels, chosen from the dtype
and head_dim alone (:func:`grid_route`), never after a failure:

- ``mma`` (bf16, fp16 at head_dim 64 and 128): split-KV on the tensor
  cores over a fixed grid. The TPU kernel's (R, kvh, M) grid, whose
  innermost axis walks a row's table slots with dead steps predicated off
  and clamped, becomes chunks x R x kv-head groups blocks
  (:func:`grid_split`, from the static shapes and the SM count): chunk j
  of row r covers table slots [j C, (j + 1) C), and a block whose chunk
  holds no attended position streams nothing (:func:`grid_live_chunks`
  is that rule in plain PyTorch). One warp per kv head streams the
  chunk's K/V rows through the block table (cp.async, two stages) and
  runs S^T = K Q^T and O^T += V^T P^T with ``mma.sync`` m16n8k16: the
  positions are the 16-row side and the head's query rows the 8-wide n
  side (at 4 query heads a kv head half a tile is padding, not three
  quarters), O^T stays in registers. A row's chunks are one
  thread-block cluster: each leaves its (acc, m, l) in its own shared
  memory, and after a cluster barrier the cluster's blocks merge the
  row's live chunks in chunk order through distributed shared memory and
  write the output. No workspace, fence or counter in device memory, no
  work list: the wrapper allocates only the output.
- ``simt`` (fp32, and head_dim 256): the first port's design, one block
  per (row, kv head) over the row's live positions on CUDA-core FMAs,
  with the ragged ``simt`` kernel's tiles and order of sums, so without a
  window the two agree bit for bit.

The launch shape depends only on (R, h, kvh, M, B, d) and the card: the
wrapper reads nothing of ``seq_lens`` or the tables on the host, so a
call can be captured in a CUDA graph and replayed after they change;
``launches`` counts one per call, by route in ``launches_by_route``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import (_build, check_layout, count_launch, sm_count, stream_of,
               use_kernel)
from .ragged_paged_attention import (DTYPES, HEAD_DIMS,
                                     ragged_paged_attention_plain,
                                     ragged_route)

MAX_GROUP = 32      # query heads per kv head the kernel holds
ROUTES = ("mma", "simt")
CLUSTER = 8         # chunks a row (one thread-block cluster), portable
MAX_CLUSTER = 16    # the largest cluster the card admits (non-portable)
HEADS_PER_BLOCK = (4, 2, 1)  # kv heads a block of the mma kernel may take

_ARGTYPES = {
    "simt": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]),
    "mma": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])}


def grid_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call launches: ``"mma"`` (tensor cores) for bf16 and
    fp16 at head_dim 64 or 128, ``"simt"`` (CUDA-core FMAs) for fp32 and
    for head_dim 256 -- the ragged kernel's rule."""
    return ragged_route(dtype, head_dim)


def grid_split(R: int, M: int, kvh: int, sms: int,
               cluster: Optional[int] = None) -> Tuple[int, int, int]:
    """(chunks, chunk_blocks, heads_per_block) of the mma kernel. A row's
    M table slots are cut into ``chunks`` chunks of ``chunk_blocks`` slots,
    one cluster a row: chunks a power of two, no more than M needs, at
    most ``cluster``, which is 16 when 16 chunks for every (row, kv head)
    stay within 8 warps a streaming multiprocessor (few rows: shorter
    chunks, a shorter critical path), else 8 (more chunks would not all
    be resident at once). A block takes the most kv heads (4, 2 or 1)
    that still gives the card two blocks per streaming multiprocessor.
    Depends on the static shapes and the card alone, never on
    ``seq_lens``."""
    if cluster is None:
        cluster = MAX_CLUSTER if MAX_CLUSTER * R * kvh <= 8 * sms else CLUSTER
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, got "
                         f"{cluster}")
    chunks = 1
    while chunks < min(cluster, M):
        chunks *= 2
    chunks = min(chunks, cluster)
    for hpb in HEADS_PER_BLOCK:
        hpb = min(hpb, kvh)
        if chunks * R * -(-kvh // hpb) >= 2 * sms:
            break
    return chunks, -(-M // chunks), hpb


def grid_live_chunks(seq_lens: torch.Tensor, M: int, chunks: int,
                     chunk_blocks: int, block_size: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Which (row, chunk) blocks of the mma kernel stream K/V: bool
    [R, chunks]. Row r attends positions [lo, hi), hi = min(seq_lens[r] +
    1, M B) and, with a window, lo = seq_lens[r] + 1 - window clamped at
    0 (else 0);
    chunk j covers positions [j C B, (j + 1) C B) and is live when the two
    overlap -- the TPU kernel's ``run`` predicate and index-map clamp
    (``paged_attention.py:58-61``, ``:110-118``) at chunk granularity. The
    kernel computes the same from ``seq_lens`` on the device."""
    lens = seq_lens.long()
    span = chunk_blocks * block_size
    hi = torch.clamp(lens + 1, max=M * block_size)
    lo = (torch.clamp(lens + 1 - window, min=0) if window is not None
          else torch.zeros_like(lens))
    start = torch.arange(chunks, device=lens.device) * span
    p0 = torch.maximum(lo[:, None], start[None, :])
    p1 = torch.minimum(hi[:, None], start[None, :] + span)
    return p0 < p1


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
    kvh = kp.shape[2]
    M = block_tables.shape[1]
    route = grid_route(q.dtype, d)
    split = (grid_split(R, M, kvh, sm_count(q)) if route == "mma"
             else None)
    out = _launch(route, q, kp, vp, block_tables, seq_lens, scale, window,
                  split)
    count_launch(paged_attention, route)
    return out


def _launch(route, q, kp, vp, block_tables, seq_lens, scale, window,
            split=None):
    """One launch of the ``route`` kernel (``split``: the mma kernel's
    (chunks, chunk_blocks, heads_per_block)), uncounted."""
    R, h, d = q.shape
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    window = 0 if window is None else int(window)
    out = torch.empty_like(q)
    fn = _build.entry("paged_attention", f"paged_attention_fwd_{route}",
                      _ARGTYPES[route])
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            R, h, kvh, d, M, B, float(scale), window)
    if route == "mma":
        args += tuple(split)
    rc = fn(*args, DTYPES[q.dtype], stream_of(q))
    _build.check("paged_attention", rc)
    return out


paged_attention.launches = 0
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
