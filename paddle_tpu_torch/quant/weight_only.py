"""Weight-only quantization for inference (counterpart of
``paddle_tpu/quant/weight_only.py``).

The JAX package's layout, kept as it is so that a JAX checkpoint's codes
cross unchanged and the kernel reads what the reference reads:

- ``qweight`` is int8 [din, dout] (``bits=8``) or int4 packed two to a
  byte along din, [din/2, dout] (``bits=4``; the low nibble is the even
  input row, the high nibble the odd one);
- ``scales`` is bf16 [din/128, dout], one per 128 input rows and output
  column, symmetric (int4 clips to +-7, not -8).

The weights are [din, dout] here, not torch's [out, in]. Decode-sized
products (at most 64 activation rows) run the fused dequant-matmul kernel
(``ops/kernels/quant_matmul.py``), or its plain version on CPU tensors;
larger ones dequantize into the activations' dtype and take one plain
matmul. The tensor's device decides the route: there is no switch that
sends CUDA tensors anywhere else. Tensor-parallel metadata
(``linear_quant_meta`` and the partition fields) comes with the
multi-device slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.common import Linear
from ..ops.kernels.quant_matmul import (QUANT_BLOCK, quant_matmul,
                                        unpack_int4, use_quant_matmul)


def quantize_blockwise(w: torch.Tensor, bits: int = 8,
                       block_size: int = QUANT_BLOCK):
    """Symmetric per-(block, column) quantization of a [in, out] weight.

    Returns (qweight, scales): int8 [in, out] (bits=8) or packed int8
    [in/2, out] (bits=4), and bf16 scales [in/block, out]. The codes come
    from the fp32 scales, before those are rounded to bf16; ``round`` is
    half to even, as in JAX."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    din, dout = w.shape
    if din % block_size:
        raise ValueError(f"in_features {din} not divisible by block "
                         f"{block_size}")
    # contiguous first: a transposed [out, in] weight would otherwise give
    # codes with its strides, and the kernel reads dense rows
    wf = w.float().contiguous().reshape(din // block_size, block_size, dout)
    qmax = 127.0 if bits == 8 else 7.0
    scales = wf.abs().amax(dim=1) / qmax                       # [nb, out]
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(wf / safe[:, None, :]), -qmax, qmax)
    q = q.reshape(din, dout).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scales.to(torch.bfloat16)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack consecutive input-row pairs: low nibble the even row, high
    nibble the odd one. In int32, then wrapped to int8 explicitly
    (``(q & 0x0F) << 4`` overflows int8)."""
    q32 = q.to(torch.int32)
    packed = (q32[0::2] & 0x0F) | ((q32[1::2] & 0x0F) << 4)     # 0 .. 255
    return packed.to(torch.uint8).view(torch.int8)


def dequantize_weight(qweight, scales, bits: int = 8,
                      block_size: int = QUANT_BLOCK, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_blockwise`, in ``dtype``: codes and
    scales are cast to it and multiplied there (for a bf16 model the
    product is rounded to bf16, as in JAX)."""
    q = unpack_int4(qweight) if bits == 4 else qweight
    din, dout = q.shape
    qf = q.to(dtype).reshape(din // block_size, block_size, dout)
    return (qf * scales.to(dtype)[:, None, :]).reshape(din, dout)


def weight_only_linear(x, qweight, scales, bias=None, bits: int = 8,
                       block_size: int = QUANT_BLOCK):
    """y = x @ dequant(qweight) (+ bias). At most 64 rows: the fused
    kernel (its plain version on CPU tensors); more rows: dequantize in
    x's dtype and one matmul."""
    lead, din = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, din)
    if use_quant_matmul(x2d, qweight, block_size):
        out = quant_matmul(x2d, qweight, scales, bits)
    else:
        out = x2d @ dequantize_weight(qweight, scales, bits, block_size,
                                      x.dtype)
    out = out.reshape(*lead, out.shape[-1])
    if bias is not None:
        out = out + bias
    return out


class QuantizedLinear(nn.Module):
    """A quantized stand-in for ``Linear`` / ``Column|RowParallelLinear``.
    ``qweight``, ``scales`` and ``bias`` are buffers, not trainable
    parameters. It does not subclass the port's ``Linear``: ``convert``
    transposes every ``Linear`` weight, and the codes must cross as they
    are."""

    def __init__(self, qweight, scales, bias=None, bits: int = 8,
                 block_size: int = QUANT_BLOCK):
        super().__init__()
        self.bits, self.block_size = bits, block_size
        self.register_buffer("qweight", qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, linear: Linear, bits: int = 8,
                    block_size: int = QUANT_BLOCK, qweight=None,
                    scales=None):
        """``qweight``/``scales`` override the default round-to-nearest
        codes (the GPTQ pass computes better ones in the same layout)."""
        if qweight is None:
            qweight, scales = quantize_blockwise(linear.weight.detach().T,
                                                 bits, block_size)
        bias = linear.bias.detach() if linear.bias is not None else None
        return cls(qweight, scales, bias, bits, block_size)

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.scales, self.bias,
                                  self.bits, self.block_size)

    def extra_repr(self):
        return f"bits={self.bits}, block={self.block_size}"


def quantize_model(model: nn.Module, bits: int = 8,
                   block_size: int = QUANT_BLOCK,
                   skip: Optional[list] = None, build=None,
                   extra_filter=None) -> int:
    """Post-training weight-only quantization in place: swap every
    eligible ``Linear`` (``Column|RowParallelLinear`` included) for a
    ``QuantizedLinear``, and return how many were swapped.

    ``skip``: substrings of module paths to keep in full precision.
    ``build(sub, path) -> Module`` makes a custom quantized module (the
    GPTQ/AWQ passes); ``extra_filter(path) -> bool`` narrows eligibility.
    Eligible: a ``Linear`` whose path holds no ``skip`` entry and whose
    in_features is a multiple of ``block_size``."""
    skip = skip or []
    build = build or (lambda sub, path:
                      QuantizedLinear.from_linear(sub, bits, block_size))

    def eligible(path, sub):
        if not isinstance(sub, Linear):
            return False
        if any(s in path for s in skip):
            return False
        if extra_filter is not None and not extra_filter(path):
            return False
        return sub.in_features % block_size == 0

    swapped = 0
    # only the parents are listed up front, so each swapped-out Linear is
    # freed as soon as its replacement is in place
    parents = [(p, m) for p, m in model.named_modules() if len(m._modules)]
    for path, parent in parents:
        for name, sub in list(parent.named_children()):
            child_path = f"{path}.{name}" if path else name
            if eligible(child_path, sub):
                setattr(parent, name, build(sub, child_path))
                swapped += 1
    return swapped
