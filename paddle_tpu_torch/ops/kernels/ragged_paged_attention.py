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

Design (``csrc/ragged_paged_attention.cu``). Two kernels, chosen from
the dtype and head_dim alone (:func:`ragged_route`), never after a
failure:

- ``mma`` (bf16, fp16 at head_dim 64 and 128): split-KV on the tensor
  cores. The TPU kernel's live-first schedule of (row, block) steps
  (:func:`build_schedule`) comes back at chunk granularity
  (:func:`build_chunk_schedule`, chunks of :func:`ragged_chunk_blocks`
  table blocks, from the static shapes and the SM count): each block of
  the kernel finds its (row, chunk) item in that list itself, from
  ``seq_lens`` on the device, and the list's capacity is R x ceil(M / C)
  whatever the pool holds (:func:`schedule_capacity`: prefix sharing
  puts one physical block in many rows). One warp per kv head streams
  the chunk's K/V rows through the block table (cp.async, two stages)
  and runs S = Q K^T and O += P V with ``mma.sync`` m16n8k16, the head's
  T x group query rows as the A operand and O in registers; a long row
  no longer holds up the launch, since its chunks run side by side. The
  chunks of a row merge in the same launch, in chunk order, through the
  last arrival at a per-row counter, as the decode kernel's splits do;
  the workspace and counters are kept per card. What holds it back: that
  merge (a fence, an atomic and the last block's pass over the
  partials) costs about a third of the launch at the engine's shape,
  and smaller chunks would stream faster but merge slower.
- ``simt`` (fp32, and head_dim 256, whose fp32 output tile would not fit
  a warp's registers): the first port's design, one block per (row, kv
  head) over the row's live positions on CUDA-core FMAs.

The launch shape depends only on static shapes (R, T, h, kvh, M, B, d)
and the card, the wrapper reads nothing of ``seq_lens`` or the tables on
the host and allocates only the output, so a call can be captured in a
CUDA graph; ``launches`` counts one per call, by route in
``launches_by_route``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import (_build, check_layout, count_launch, sm_count, stream_of,
               use_kernel)

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_ROWS = 32       # T x (query heads per kv head) one launch holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("mma", "simt")
MMA_HEAD_DIMS = (64, 128)
MIN_CHUNK = 64      # the least positions a chunk of the mma kernel covers
MAX_CHUNKS = 32     # chunks a row, at most (the merge's statistics)
HEADS_PER_BLOCK = 4  # kv heads a block of the mma kernel takes

_ARGTYPES = {
    "simt": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]),
    "mma": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])}
# per card: the mma kernel's (workspace, counters) scratch
_scratch: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def ragged_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call launches: ``"mma"`` (tensor cores) for bf16 and
    fp16 at head_dim 64 or 128, ``"simt"`` (CUDA-core FMAs) for fp32 and
    for head_dim 256."""
    return ("mma" if dtype in (torch.bfloat16, torch.float16)
            and head_dim in MMA_HEAD_DIMS else "simt")


def schedule_capacity(R: int, M: int, P: int) -> int:
    """Static schedule length (``ragged_paged_attention.py:54``): every
    row can hold M live logical blocks, so the schedule holds R * M. A
    bound taken from the pool size P is wrong under prefix caching, where
    one physical block appears in the tables of many rows."""
    del P
    return R * M


def _live_blocks(block_tables, seq_lens, block_size, window, q_len):
    """Per row: the first live logical block and one past the last, as
    ``build_schedule`` counts them (int32)."""
    M = block_tables.shape[1]
    lens = seq_lens.to(torch.int32)
    valid = lens + q_len
    nb = torch.clamp(torch.div(valid + block_size - 1, block_size,
                               rounding_mode="floor"), 1, M)
    if window is None:
        lo = torch.zeros_like(lens)
    else:
        lo = torch.div(torch.clamp(lens + 1 - window, min=0), block_size,
                       rounding_mode="floor")
    return lo.to(torch.int32), nb.to(torch.int32)


def _packed(cnt, first, S: int):
    """Live-first (row, index, live) of length S from per-row counts and
    first indices, as ``build_schedule`` packs them: dead steps repeat the
    last live step."""
    R = cnt.shape[0]
    cum = torch.cumsum(cnt, 0, dtype=torch.int32)
    total = cum[-1]
    starts = cum - cnt
    s = torch.arange(S, dtype=torch.int32, device=cnt.device)
    row = torch.searchsorted(cum, s, right=True).to(torch.int32)
    rowc = torch.clamp(row, 0, R - 1).long()
    idx = first[rowc] + (s - starts[rowc])
    live = s < total
    li = torch.clamp(total - 1, 0, S - 1).long()
    row_s = torch.where(live, rowc.to(torch.int32), rowc[li].to(torch.int32))
    idx_s = torch.where(live, idx, idx[li])
    return row_s, idx_s.to(torch.int32), live.to(torch.int32)


def build_schedule(block_tables, seq_lens, S: int, block_size: int,
                   window=None, q_len: int = 1):
    """The TPU kernel's flattened live-first schedule
    (``ragged_paged_attention.py:70``), in plain PyTorch: int32 (row[S],
    blk[S], live[S]), where (row, blk) index ``block_tables``, a row's
    live blocks run from the first query's window start to the last
    query's position, and dead steps repeat the last live step."""
    lo, nb = _live_blocks(block_tables, seq_lens, block_size, window, q_len)
    return _packed(nb - lo, lo, S)


def build_chunk_schedule(block_tables, seq_lens, chunk_blocks: int,
                         block_size: int, window=None, q_len: int = 1):
    """The mma kernel's work list: :func:`build_schedule` at the
    granularity of chunks of ``chunk_blocks`` logical blocks (chunk j of
    a row holds blocks [j C, (j + 1) C)). Returns int32 (row, chunk, live)
    of capacity R x ceil(M / C); each block of the kernel finds its item
    in this list from ``seq_lens`` on the device."""
    R, M = block_tables.shape
    C = chunk_blocks
    lo, nb = _live_blocks(block_tables, seq_lens, block_size, window, q_len)
    c0 = torch.div(lo, C, rounding_mode="floor")
    cnt = torch.div(nb - 1, C, rounding_mode="floor") - c0 + 1
    return _packed(cnt.to(torch.int32), c0.to(torch.int32),
                   R * -(-M // C))


def ragged_chunk_blocks(R: int, M: int, B: int, kvh: int, sms: int) -> int:
    """Table blocks per chunk of the mma kernel: the fewest that cover at
    least ``MIN_CHUNK`` positions, keep a row at ``MAX_CHUNKS`` chunks at
    most, and keep the launch at most four blocks per streaming
    multiprocessor (R x ceil(M / C) x kv-head groups, live or not): more
    chunks a row lengthen the merge, whose cost grows with them.
    Depends on the static shapes and the card alone, never on
    ``seq_lens``."""
    groups = -(-kvh // min(kvh, HEADS_PER_BLOCK))
    c = max(1, -(-MIN_CHUNK // B), -(-M // MAX_CHUNKS))
    while c < M and R * -(-M // c) * groups > 4 * sms:
        c += 1
    return min(c, M)


def query_windows(T: int, group: int):
    """The (first, end) query indices of each launch for a window of T
    queries a row at ``group`` query heads per kv head: one window when
    T x group fits ``MAX_ROWS``, else the fewest windows of whole queries
    that fit, of near-equal length (9 queries at group 4: 5 and 4)."""
    n = -(-T // (MAX_ROWS // group))
    size = -(-T // n)
    return [(t, min(t + size, T)) for t in range(0, T, size)]


def _scratch_for(dev: torch.device, floats: int, counters: int):
    """The card's fp32 workspace of at least ``floats`` elements and its
    int32 counters (at least ``counters``, all 0), grown when too
    small."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    work, arrivals = _scratch.get(idx, (None, None))
    if (work is None or work.numel() < floats
            or arrivals.numel() < counters):
        work = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
        arrivals = torch.zeros(max(counters, 1), dtype=torch.int32,
                               device=dev)
        _scratch[idx] = (work, arrivals)
    return work, arrivals


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
    if h // kvh > MAX_ROWS:
        raise ValueError(f"{h // kvh} query heads per kv head; the kernel "
                         f"takes at most {MAX_ROWS} query rows")
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
    launch the kernel, on the current stream, or raise. A launch holds at
    most ``MAX_ROWS`` query rows a kv head (T x query heads per kv head):
    a longer window runs as :func:`query_windows` of consecutive queries,
    one launch each, window j's queries at seq_lens + its first index (the
    caller wrote the K/V of every query before the call)."""
    _check(q, kp, vp, block_tables, seq_lens, window)
    T = q.shape[1] if q.dim() == 4 else 1
    spans = query_windows(T, q.shape[-2] // kp.shape[2])
    if len(spans) > 1:
        return torch.cat([
            ragged_paged_attention(q[:, t0:t1].contiguous(), kp, vp,
                                   block_tables, seq_lens + t0, scale,
                                   window) for t0, t1 in spans], dim=1)
    if not use_kernel(q, kp, vp, block_tables, seq_lens):
        return ragged_paged_attention_plain(q, kp, vp, block_tables,
                                            seq_lens, scale, window)
    check_layout(q=q, kp=kp, vp=vp, block_tables=block_tables,
                 seq_lens=seq_lens)
    R, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    route = ragged_route(q.dtype, d)
    chunk = (ragged_chunk_blocks(R, M, B, kvh, sm_count(q))
             if route == "mma" else 0)
    out = _launch(route, q, kp, vp, block_tables, seq_lens, scale, window,
                  chunk)
    count_launch(ragged_paged_attention, route)
    return out


def _launch(route, q, kp, vp, block_tables, seq_lens, scale, window,
            chunk):
    """One launch of the ``route`` kernel (``chunk``: table blocks per
    chunk, mma only), uncounted."""
    R, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    T = q.shape[1] if q.dim() == 4 else 1
    _, B, kvh, _ = kp.shape
    M = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    window = 0 if window is None else int(window)
    out = torch.empty_like(q)
    fn = _build.entry("ragged_paged_attention",
                      f"ragged_paged_attention_fwd_{route}",
                      _ARGTYPES[route])
    ptrs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr())
    if route == "mma":
        nc = -(-M // chunk)
        groups = -(-kvh // min(kvh, HEADS_PER_BLOCK))
        span = -(-T * (h // kvh) * (d + 2) // 4) * 4  # one partial
        work, arrivals = _scratch_for(q.device, R * kvh * nc * span,
                                      R * groups)
        rc = fn(*ptrs, work.data_ptr(), arrivals.data_ptr(), R, T, h, kvh,
                d, M, B, float(scale), window, chunk, DTYPES[q.dtype],
                stream_of(q))
    else:
        rc = fn(*ptrs, R, T, h, kvh, d, M, B, float(scale), window,
                DTYPES[q.dtype], stream_of(q))
    _build.check("ragged_paged_attention", rc)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
