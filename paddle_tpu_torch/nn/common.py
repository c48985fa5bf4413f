"""Core layers (counterpart of ``paddle_tpu/nn/common.py``: ``Linear``,
``Embedding``).

Each layer allocates its parameters on ``device`` in ``dtype`` and fills
them from the ``generator`` it is given. Linear weights are stored
[out, in], the torch way; the JAX package stores [in, out].
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F
from . import initializer as I


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
