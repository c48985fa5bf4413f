"""Tensor-parallel layers (counterpart of ``paddle_tpu/parallel/layers.py``;
reference: paddle/distributed/fleet/layers/mpu/mp_layers.py —
ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
parallel_matmul — and mp_ops.py's _c_identity/_c_concat/_mp_allreduce).

The JAX package keeps each weight logically full-size with a ``tp``
partition and lets GSPMD insert the collectives. Here the weights carry
the same partitions in the port's layout (a Linear weight is [out, in],
so the JAX ``(None, "tp")`` is ``("tp", None)``), ``parallel.sharding``
splits them over the ``tp`` ranks as DTensors, and each layer runs on
its rank's shard with the Megatron collectives written out:

  ColumnParallelLinear  W [out/tp, in]: x enters through ``_copy`` (the
                        identity forward, a tp all-reduce of its
                        gradient), y leaves split on out, or gathered
                        (``gather_output``, the JAX default)
  RowParallelLinear     W [out, in/tp]: x arrives split on in
                        (``input_is_parallel``, the default; else this
                        rank's slice is taken), the partial products are
                        summed over tp (``_reduce``), then the bias
  VocabParallelEmbedding  rows [vocab/tp, h]: ids outside this rank's
                        rows read zeros, and the tp sum merges

With ``tp`` of degree 1 (or no mesh) every collective is the identity
and the layers are the dense ones, bit for bit. Parameter names and
default initializers are the JAX package's.
"""
from __future__ import annotations

import torch

from ..distributed import collective as C
from ..distributed.collective import axis_index, axis_size
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.common import Embedding, Linear, set_fused, set_partition

TP = "tp"


class _Copy(torch.autograd.Function):
    """The identity forward, an all-reduce over ``axis`` backward
    (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C._reduce_(g.clone(), C.ReduceOp.SUM, ctx.axis), None


class _Reduce(torch.autograd.Function):
    """An all-reduce over ``axis`` forward, the identity backward
    (Megatron's g: the output's cotangent is the same on every rank of
    the axis)."""

    @staticmethod
    def forward(ctx, x, axis):
        return C._reduce_(x.clone(), C.ReduceOp.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, axis: str):
    """Megatron's f over ``axis``: ``x`` enters work split over the axis
    (each rank computes a part of a sum from it), so its gradient is the
    sum of the ranks' gradients."""
    return _Copy.apply(x, axis)


def reduce_from(x, axis: str):
    """Megatron's g over ``axis``: the sum of the ranks' parts, whose
    cotangent every rank of the axis already holds whole."""
    return _Reduce.apply(x, axis)


class _Gather(torch.autograd.Function):
    """Gather the last dim over tp forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x):
        return C._gather(x, TP, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        n = axis_size(TP)
        return g.chunk(n, dim=-1)[axis_index(TP)].contiguous()


class _Split(torch.autograd.Function):
    """This rank's slice of the last dim forward; a tp gather backward."""

    @staticmethod
    def forward(ctx, x):
        n = axis_size(TP)
        return x.chunk(n, dim=-1)[axis_index(TP)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return C._gather(g, TP, g.dim() - 1)


def _tp() -> int:
    return axis_size(TP)


def local_heads(cfg):
    """(query heads, kv heads) of this rank: the config's, divided by the
    installed mesh's ``tp`` degree. ``ValueError`` when the degree does
    not divide them (the JAX package's partition check rejects the same
    head split)."""
    kv = getattr(cfg, "num_key_value_heads", None) or cfg.num_attention_heads
    h = getattr(cfg, "num_attention_heads", kv)
    tp = _tp()
    if h % tp or kv % tp:
        raise ValueError(f"heads ({h}q/{kv}kv) not divisible by tp degree "
                         f"{tp}")
    return h // tp, kv // tp


class ColumnParallelLinear(Linear):
    """Output dim split over ``tp``: weight partition ``("tp", None)``,
    bias ``("tp",)``. ``fused_parts`` > 1 (a fused qkv: q, k and v
    stacked on the outputs) splits each part apart
    (``nn.common.set_fused``), so a rank's outputs are its own heads'
    columns of each part, which the JAX package's global reshape to
    [..., 3, heads, d] gives the rank's heads under GSPMD."""

    def __init__(self, in_features, out_features, *, gather_output=True,
                 fused_parts: int = 1, **kw):
        super().__init__(in_features, out_features, **kw)
        self.gather_output = gather_output
        set_partition(self.weight, ("tp", None))
        if self.bias is not None:
            set_partition(self.bias, ("tp",))
        if fused_parts > 1:
            for p in (self.weight, self.bias):
                if p is not None:
                    set_fused(p, fused_parts)

    def forward(self, x):
        if _tp() == 1:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(_Copy.apply(x, TP), self.weight, self.bias)
        return _Gather.apply(y) if self.gather_output else y

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}, col-parallel"


class RowParallelLinear(Linear):
    """Input dim split over ``tp``: weight partition ``(None, "tp")``; the
    bias is added after the sum, replicated."""

    def __init__(self, in_features, out_features, *, input_is_parallel=True,
                 **kw):
        super().__init__(in_features, out_features, **kw)
        self.input_is_parallel = input_is_parallel
        set_partition(self.weight, (None, "tp"))

    def forward(self, x):
        if _tp() == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _Split.apply(x)
        y = _Reduce.apply(F.linear(x, self.weight), TP)
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}, row-parallel"


class VocabParallelEmbedding(Embedding):
    """Vocab dim split over ``tp``: weight partition ``("tp", None)``.
    Initialised N(0, 0.02), as in the JAX package."""

    def __init__(self, num_embeddings, embedding_dim, **kw):
        kw.setdefault("weight_attr", I.Normal(0.0, 0.02))
        super().__init__(num_embeddings, embedding_dim, **kw)
        set_partition(self.weight, ("tp", None))

    def forward(self, x):
        if _tp() == 1:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        start = axis_index(TP) * rows
        mine = (x >= start) & (x < start + rows)
        y = F.embedding(torch.where(mine, x - start, torch.zeros_like(x)),
                        self.weight)
        y = y * mine[..., None].to(y.dtype)
        return _Reduce.apply(y, TP)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}, vocab-parallel"


def parallel_matmul(x, weight, transpose_y: bool = False):
    """LM-head projection against an embedding table (``transpose_y`` for
    tied embeddings, whose weight is [vocab, hidden]). Under tp the table
    is vocab-split: each rank projects onto its rows and the logits are
    gathered over tp."""
    if _tp() == 1:
        return x @ (weight.T if transpose_y else weight)
    y = _Copy.apply(x, TP) @ (weight.T if transpose_y else weight)
    return _Gather.apply(y)
