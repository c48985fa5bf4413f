"""``LayerNorm`` and ``RMSNorm`` (counterpart of ``paddle_tpu/nn/norm.py``).
Both normalise in fp32 and round to the input's dtype before the
weight (and bias) are applied."""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=resolve_device(device),
                       dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{self.hidden_size}, eps={self.epsilon}"


class LayerNorm(nn.Module):
    """``weight_attr=False`` / ``bias_attr=False`` build it without the
    weight / the bias, as in Paddle."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(self.normalized_shape, **kw))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(self.normalized_shape, **kw))
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, eps={self.epsilon}"
