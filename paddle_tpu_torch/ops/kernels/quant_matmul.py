"""Fused weight-only dequant-matmul on Hopper, and its plain PyTorch
version.

Replaces: ``paddle_tpu/ops/pallas/quant_matmul.py`` ``quant_matmul_pallas``
(:67; kernel ``_qmm_kernel`` :43, gate ``use_quant_matmul`` :116). Same
function: ``out = (x.float() @ (q.float() * s.float())).to(x.dtype)`` for
x [m, din], codes int8 [din, dout] (``bits=8``) or int4 packed two to a
byte along din [din/2, dout] (``bits=4``: low nibble the even row, high
nibble the odd one, both sign-extended), and bf16 scales [din/128, dout],
one per 128 code rows and column. The dequant is in fp32, the sums are in
fp32, the output is rounded once, and the full-precision weight never
exists in device memory. Bias stays outside, as in the JAX package. The
TPU kernel's 8-row pad of x and its 8-sublane regrouping of the scales
serve Mosaic's tiling and are not carried over.

Bound on the H100: at m <= 64 the function is one pass over the codes
and scales (x and out are small): Llama-3-8B's gate projection 4096 ->
14336 moves 58.7 MB of int8 codes and 0.9 MB of scales, 17.8 us at 3.35
TB/s (int4 about 9 us); its 2 m din dout operations are far below the
tensor-core rate, so the bound is the bytes.

Design (``csrc/quant_matmul.cu``). Two kernels, chosen from x's dtype
alone (:func:`quant_route`), never after a failure:

- ``mma`` (bf16, fp16 activations): the tensor cores, with the weight as
  the 16-row operand of ``mma.sync`` m16n8k16 and all m <= 64 activation
  rows on its n side (1, 2, 4 or 8 tiles of 8), so every code byte
  crosses from device memory and is converted once per call, whatever m
  is. Codes become floats by a byte-into-mantissa trick and then x's
  type, exactly (|q| <= 128); each 128-row scale block's fp32 partial is
  multiplied by its scales after the product, so no rounding is added
  that the JAX function lacks. Codes, x rows and scales are staged with
  cp.async three scale blocks deep. The contraction is split
  (:func:`mma_splits`, from the shapes and the card's SM count alone:
  the k/v projection has only 8 column tiles of 128, gate_proj 112), and
  the splits
  merge in the same launch: the last block of a column tile to arrive
  at its counter adds the fp32 partials in split order and resets the
  counter. One launch a call; the workspace and counters are kept per
  card (calls running at once on two streams of one card would share
  them), so the wrapper allocates only the output and a call can be
  captured in a CUDA graph. What holds it back: at m = 64 every column
  tile stages all its x rows from L2 (as many bytes as the codes), and
  int4 spends the same conversions and syncs per scale block on half the
  bytes.
- ``simt`` (fp32 activations, which the 16-bit tensor-core products
  cannot hold): the first port's kernel. Each lane loads 16 bytes of a
  code row, 8 rows in flight, and accumulates fp32 products for a chunk
  of up to 4 activation rows on CUDA-core FMAs; a second pass adds the
  split-K partials in a fixed order.

No atomics decide an order of sums: both repeat bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import (_build, check_layout, count_launch, sm_count, stream_of,
               use_kernel, workspace)

QUANT_BLOCK = 128   # code rows per scale (quantize_blockwise block_size)
MAX_ROWS = 64       # the gate's largest m
COLS = 512          # output columns per block of the kernel
MMA_COLS = 128     # output columns per block of the mma kernel
MMA_ROWS = 64      # activation rows per block of the mma kernel
# the least 128-row scale blocks a split of the mma kernel takes
MIN_SPLIT_BLOCKS = 2
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("mma", "simt")

_ARGTYPES = {
    "simt": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "mma": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}


def use_quant_matmul(x2d, qweight, block_size: int) -> bool:
    """The kernel targets decode-sized activations (small m) where the
    weight stream dominates; larger m goes to a plain dequant + matmul."""
    m, din = x2d.shape
    dout = qweight.shape[1]
    return (block_size == QUANT_BLOCK and m <= MAX_ROWS
            and din % QUANT_BLOCK == 0 and dout % 128 == 0)


def unpack_int4(qweight: torch.Tensor) -> torch.Tensor:
    """Packed int4 [din/2, dout] -> int32 codes [din, dout]: the low nibble
    is the even row, the high nibble the odd one, both sign-extended."""
    b = qweight.to(torch.int32)
    lo = ((b & 0x0F) ^ 8) - 8
    hi = b >> 4                     # arithmetic: the signed high nibble
    return torch.stack([lo, hi], dim=1).reshape(-1, qweight.shape[1])


def _check(x, qweight, scales, bits):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.dim() != 2 or qweight.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"want x [m, din], qweight [din or din/2, dout], "
                         f"scales [din/128, dout]; got {tuple(x.shape)}, "
                         f"{tuple(qweight.shape)}, {tuple(scales.shape)}")
    m, din = x.shape
    dout = qweight.shape[1]
    rows = din if bits == 8 else din // 2
    if (din % QUANT_BLOCK or qweight.shape[0] != rows
            or tuple(scales.shape) != (din // QUANT_BLOCK, dout)):
        raise ValueError(f"qweight {tuple(qweight.shape)} and scales "
                         f"{tuple(scales.shape)} do not fit x "
                         f"{tuple(x.shape)} at {bits} bits")
    if x.dtype not in DTYPES or qweight.dtype != torch.int8 \
            or scales.dtype != torch.bfloat16:
        raise TypeError(f"want x in {list(DTYPES)}, int8 codes and bf16 "
                        f"scales; got {x.dtype}, {qweight.dtype}, "
                        f"{scales.dtype}")


def quant_matmul_plain(x, qweight, scales, bits: int = 8):
    """The same function in plain PyTorch, with the kernel's rounding
    points: fp32 dequant, fp32 matmul, one rounding to x's dtype."""
    _check(x, qweight, scales, bits)
    q = unpack_int4(qweight) if bits == 4 else qweight
    din, dout = q.shape
    w = (q.float().reshape(din // QUANT_BLOCK, QUANT_BLOCK, dout)
         * scales.float()[:, None, :]).reshape(din, dout)
    return (x.float() @ w).to(x.dtype)


def quant_route(dtype: torch.dtype) -> str:
    """The kernel a call launches: ``"mma"`` (tensor cores) for bf16 and
    fp16 activations, ``"simt"`` (CUDA-core FMAs) for fp32."""
    return "simt" if dtype == torch.float32 else "mma"


def mma_splits(m: int, din: int, dout: int, sms: int, bits: int = 8) -> int:
    """Contraction splits of the mma kernel: the largest divisor of the
    scale-block count (so every split streams the same bytes) that gives
    at most about two blocks per streaming multiprocessor in all (four
    for int4, whose blocks stream half the bytes), each split over at
    least ``MIN_SPLIT_BLOCKS`` scale blocks. Depends on the shapes and the
    card alone, so a call repeats bit for bit."""
    nkb = din // QUANT_BLOCK
    tiles = -(-dout // MMA_COLS) * -(-m // MMA_ROWS)
    target = max(1, min(nkb // MIN_SPLIT_BLOCKS,
                        -(-2 * sms * (8 // bits) // tiles)))
    return max(s for s in range(1, target + 1) if nkb % s == 0)


def _mma_rows(m: int) -> int:
    """Activation rows one mma block holds: 8, 16, 32 or 64."""
    return next(n for n in (8, 16, 32, 64) if m <= n or n == 64)



def splits_for(m: int, din: int, dout: int, sms: int) -> int:
    """Contraction splits: as many blocks as fit in one wave at three a
    streaming multiprocessor (a fourth would wait for a second wave), at
    most one split per 128-row scale block. Depends on the shapes alone,
    so a call repeats bit for bit."""
    base = -(-m // row_chunk(m)) * -(-dout // COLS)
    return max(1, min(din // QUANT_BLOCK, 3 * sms // base))


def row_chunk(m: int) -> int:
    """Activation rows one block of the kernel holds: 1, 2 or 4."""
    return 1 if m == 1 else 2 if m == 2 else 4


def scale_rows(scales: torch.Tensor, din: int, block_offset: int = 0):
    """The ``din / 128`` scale blocks of a product over ``din`` code rows
    that start at block ``block_offset`` of ``scales`` (a row-parallel
    rank's rows of a replicated table): a view, contiguous rows of a
    contiguous table, so the kernel reads them at a base address and its
    indexing is unchanged."""
    n = din // QUANT_BLOCK
    if block_offset == 0 and scales.shape[0] == n:
        return scales
    if block_offset < 0 or block_offset + n > scales.shape[0]:
        raise ValueError(f"scale blocks {block_offset}..{block_offset + n} "
                         f"outside a table of {scales.shape[0]}")
    return scales.narrow(0, block_offset, n)


def quant_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, bits: int = 8,
                 block_offset: int = 0) -> torch.Tensor:
    """x [m, din] @ dequant(qweight, scales) -> [m, dout] in x's dtype.
    ``block_offset``: the first of ``scales``' 128-row blocks the codes
    take (:func:`scale_rows`; a row-parallel rank's offset into the
    replicated table).

    CPU tensors take :func:`quant_matmul_plain`; CUDA tensors launch the
    kernel, on the current stream, or raise."""
    if x.dim() == 2:
        scales = scale_rows(scales, x.shape[1], block_offset)
    _check(x, qweight, scales, bits)
    if not use_kernel(x, qweight, scales):
        return quant_matmul_plain(x, qweight, scales, bits)
    x = x.contiguous()
    check_layout(qweight=qweight, scales=scales)
    m, din = x.shape
    dout = qweight.shape[1]
    if dout % 16:
        raise ValueError(f"dout {dout} must be a multiple of 16")
    out = torch.empty(m, dout, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    route = quant_route(x.dtype)
    fn = _build.entry("quant_matmul", f"quant_matmul_fwd_{route}",
                      _ARGTYPES[route])
    if route == "mma":
        splits = mma_splits(m, din, dout, sm_count(x), bits)
        tiles = -(-dout // MMA_COLS) * -(-m // MMA_ROWS)
        work, arrivals = workspace(
            "quant_matmul", x.device,
            tiles * splits * _mma_rows(m) * MMA_COLS, tiles)
        rc = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                out.data_ptr(), work.data_ptr(), arrivals.data_ptr(), m,
                din, dout, bits, splits, DTYPES[x.dtype], stream_of(x))
    else:
        splits = splits_for(m, din, dout, sm_count(x))
        partial = (torch.empty(splits, m, dout, dtype=torch.float32,
                               device=x.device) if splits > 1 else out)
        rc = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                out.data_ptr(), partial.data_ptr(), m, din, dout, bits,
                row_chunk(m), splits, DTYPES[x.dtype], stream_of(x))
    _build.check("quant_matmul", rc)
    count_launch(quant_matmul, route)
    return out


quant_matmul.launches = 0
quant_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
