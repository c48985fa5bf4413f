"""Core layers (counterpart of ``paddle_tpu/nn/common.py``: ``Linear``,
``Embedding``, ``Dropout``).

Each layer allocates its parameters on ``device`` in ``dtype`` and fills
them from the ``generator`` it is given. Linear weights are stored
[out, in], the torch way; the JAX package stores [in, out].

Partition metadata (the JAX package's ``ParamMeta.partition``): a
parameter may carry ``partition``, one mesh-axis name (or tuple of
names, or None) per dim, in the port's own layout: a Linear weight's
tuple is the JAX one reversed, as its shape is. ``parallel.sharding``
reads it through :func:`partition_of`.

A fused projection's weight (the GPT, BERT, ViT, CLIP and DiT families'
qkv: [3 h, in], q, k and v stacked on dim 0) also carries
``fused_parts`` (:func:`set_fused`): dim 0 is that many blocks, and a tp
split cuts each block apart, so rank t holds ``[q_t; k_t; v_t]``, its
own heads' columns of each (``parallel.sharding``; the order of
``nn.fuse``'s interleave).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F
from . import initializer as I


def partition_of(param):
    """A parameter's partition tuple (see the module docstring), or None."""
    return getattr(param, "partition", None)


def set_partition(param, partition):
    """Tag ``param`` with a partition tuple in the port's layout; returns
    it."""
    param.partition = tuple(partition) if partition is not None else None
    return param


def fused_of(param) -> int:
    """How many blocks a tp split cuts apart on dim 0 of ``param`` (1: a
    plain split)."""
    return getattr(param, "fused_parts", 1)


def set_fused(param, parts: int):
    """Tag ``param`` as ``parts`` blocks stacked on dim 0, each split over
    tp on its own (module docstring); returns it."""
    param.fused_parts = int(parts)
    return param


def copy_meta(src, dst):
    """Give ``dst`` the partition metadata of ``src``; returns ``dst``."""
    for k in ("partition", "fused_parts"):
        if hasattr(src, k):
            setattr(dst, k, getattr(src, k))
    return dst


def _param(shape, init, generator, device, dtype):
    t = torch.empty(shape, device=device, dtype=dtype)
    init(t, generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, has_bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((out_features, in_features),
                             I.XavierNormal(), generator,
                             device, dtype)
        self.bias = (_param((out_features,), I.Constant(0.0), generator,
                            device, dtype) if has_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: torch.Generator,
                 weight_init: Optional[I.Initializer] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim),
                             weight_init or I.Normal(0.0, 1.0), generator,
                             device, dtype)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """Dropout in Paddle's two modes (``functional.dropout``). In training
    with p > 0 the mask is drawn from ``generator``, which must then be
    given (the JAX layer draws from the global ``next_key()``; the port
    keeps no global random state)."""

    def __init__(self, p=0.5, mode="upscale_in_train", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"
