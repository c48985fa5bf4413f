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
sends CUDA tensors anywhere else.

Tensor parallel, as in the JAX package: ``linear_quant_meta`` reads a
layer's partitions, and ``QuantizedLinear.from_linear`` moves them onto
its ``weight_partition`` (the source weight's, in the port's [out, in]
layout), ``bias_partition``, ``input_parallel_axis`` and
``output_parallel_axis``. The codes follow the weight: a column-parallel
layer's codes and scales split on out; a row-parallel layer's codes split
on in, and its scales table stays whole, as the JAX package keeps it
(``[din/128, dout]``), each rank reading the blocks of its own input
rows (``quant_matmul``'s ``block_offset``). So a row split must fall on
a 128-row block (``din / tp`` a multiple of 128: ``ValueError`` else),
which also splits int4's packed pairs at an even row. A rank holds 1/tp
of the codes: ``shard_layer`` cuts a quantized layer's buffers
(``buffer_partitions``), and quantizing a sharded model quantizes each
rank's own shard.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..distributed import collective as C
from ..distributed.collective import axis_index, axis_size
from ..distributed.env import axis_degree
from ..nn.common import Linear, partition_of
from ..ops.kernels.quant_matmul import (QUANT_BLOCK, quant_matmul,
                                        unpack_int4, use_quant_matmul)
from ..parallel.layers import reduce_from
from ..parallel.sharding import _shard_axes, local


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
                       block_size: int = QUANT_BLOCK, block_offset: int = 0):
    """y = x @ dequant(qweight) (+ bias). At most 64 rows: the fused
    kernel (its plain version on CPU tensors); more rows: dequantize in
    x's dtype and one matmul. ``block_offset``: the first scale block the
    codes take (a row-parallel rank's, in a whole table)."""
    lead, din = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, din)
    if use_quant_matmul(x2d, qweight, block_size):
        out = quant_matmul(x2d, qweight, scales, bits, block_offset)
    else:
        scales = scales.narrow(0, block_offset, din // block_size)
        out = x2d @ dequantize_weight(qweight, scales, bits, block_size,
                                      x.dtype)
    out = out.reshape(*lead, out.shape[-1])
    if bias is not None:
        out = out + bias
    return out


def linear_quant_meta(linear):
    """The tp metadata ``QuantizedLinear.from_linear`` moves onto a
    quantized layer, without quantizing anything: (weight partition,
    bias partition, input parallel axis, output parallel axis), the JAX
    function's tuple with the weight partition in the port's [out, in]
    layout (the JAX one reversed)."""
    from ..parallel.layers import ColumnParallelLinear, RowParallelLinear
    in_axis = out_axis = None
    if isinstance(linear, ColumnParallelLinear) and not linear.gather_output:
        out_axis = "tp"
    if isinstance(linear, RowParallelLinear) and linear.input_is_parallel:
        in_axis = "tp"
    return (partition_of(linear._parameters.get("weight")),
            partition_of(linear._parameters.get("bias")), in_axis, out_axis)


def _local_tp(p, name):
    """A parameter's local tensor on a model sharded over tp only (the
    tensor itself when it is not sharded)."""
    axes = _shard_axes(p)
    if any(a != "tp" for a in axes):
        raise NotImplementedError(
            f"{name} is sharded over {axes}: weight-only quant takes tp "
            f"shards only")
    return local(p).detach()


class QuantizedLinear(nn.Module):
    """A quantized stand-in for ``Linear`` / ``Column|RowParallelLinear``.
    ``qweight``, ``scales`` and ``bias`` are buffers, not trainable
    parameters. It does not subclass the port's ``Linear``: ``convert``
    transposes every ``Linear`` weight, and the codes must cross as they
    are.

    The tp contracts of the source layer survive (module docstring):
    ``weight_partition`` and ``bias_partition`` in the source's layout,
    ``input_parallel_axis`` (a row layer's input arrives split) and
    ``output_parallel_axis`` (a column layer's output stays split).
    ``in_features`` and ``out_features`` are the logical widths; codes
    narrower than them are this rank's shard, and the forward adds the
    collective the source layer would: a tp sum after a row shard, a tp
    gather after a column shard whose output is not left split."""

    def __init__(self, qweight, scales, bias=None, bits: int = 8,
                 block_size: int = QUANT_BLOCK, weight_partition=None,
                 bias_partition=None, input_parallel_axis=None,
                 output_parallel_axis=None, in_features=None,
                 out_features=None):
        super().__init__()
        self.bits, self.block_size = bits, block_size
        self.weight_partition = tuple(weight_partition) \
            if weight_partition else None
        self.bias_partition = tuple(bias_partition) \
            if bias_partition else None
        self.input_parallel_axis = input_parallel_axis
        self.output_parallel_axis = output_parallel_axis
        self.in_features = in_features or \
            qweight.shape[0] * (2 if bits == 4 else 1)
        self.out_features = out_features or qweight.shape[1]
        self.register_buffer("qweight", qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, linear: Linear, bits: int = 8,
                    block_size: int = QUANT_BLOCK, qweight=None,
                    scales=None):
        """``qweight``/``scales`` override the default round-to-nearest
        codes (the GPTQ pass computes better ones in the same layout).

        On a model sharded over tp, the source's local shard is
        quantized: a column rank's codes and scales are its columns' (the
        same values the whole weight's codes hold there, since a scale
        covers one column); a row rank's codes are its input rows', and
        the ranks' scale blocks are gathered into the whole table."""
        wp, bp, in_axis, out_axis = linear_quant_meta(linear)
        w = _local_tp(linear._parameters["weight"], "weight")
        b = linear._parameters.get("bias")
        b = _local_tp(b, "bias") if b is not None else None
        sharded = bool(_shard_axes(linear._parameters["weight"]))
        row = w.shape[1] < linear.in_features
        if qweight is None:
            if row and w.shape[1] % block_size:
                raise ValueError(
                    f"a row-parallel rank's {w.shape[1]} input rows do "
                    f"not fill {block_size}-row scale blocks; quantize "
                    f"before sharding at a tp degree that divides "
                    f"in_features / {block_size}")
            qweight, scales = quantize_blockwise(w.T, bits, block_size)
            if row:
                scales = C._gather(scales, "tp", 0)
        q = cls(qweight, scales, b, bits, block_size, weight_partition=wp,
                bias_partition=bp, input_parallel_axis=in_axis,
                output_parallel_axis=out_axis,
                in_features=linear.in_features,
                out_features=linear.out_features)
        q._buffers_sharded = sharded
        return q

    def buffer_partitions(self):
        """{buffer: partition} for ``parallel.sharding.shard_layer``: the
        codes [din, dout] split as the source weight, the scales on out
        only, the bias as the source bias. ``ValueError`` where a row
        split would cut a 128-row scale block."""
        if not self.weight_partition:
            return {}
        in_axis, out_axis = tuple(reversed(self.weight_partition))
        n = axis_degree(in_axis) if in_axis else 1
        if (self.in_features // n) % self.block_size:
            raise ValueError(
                f"in_features {self.in_features} over {in_axis} degree {n} "
                f"gives {self.in_features // n} rows a rank, not a "
                f"multiple of the {self.block_size}-row scale block")
        parts = {"qweight": (in_axis, out_axis), "scales": (None, out_axis)}
        if self.bias is not None and self.bias_partition:
            parts["bias"] = self.bias_partition
        return parts

    def forward(self, x):
        din = self.qweight.shape[0] * (2 if self.bits == 4 else 1)
        row = din < self.in_features
        col = self.qweight.shape[1] < self.out_features
        offset = 0
        if row:
            axis = self.weight_partition[1]
            if x.shape[-1] != din:
                # the source's input_is_parallel=False: this rank's slice
                x = x.chunk(axis_size(axis), dim=-1)[axis_index(axis)]
            if self.scales.shape[0] * self.block_size > din:
                offset = axis_index(axis) * (din // self.block_size)
        y = weight_only_linear(x, self.qweight, self.scales, None,
                               self.bits, self.block_size,
                               block_offset=offset)
        if row:
            y = reduce_from(y, axis)
        if self.bias is not None:
            y = y + self.bias
        if col and self.output_parallel_axis is None:
            y = C._gather(y.contiguous(), self.weight_partition[0],
                          y.dim() - 1)
        return y

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
