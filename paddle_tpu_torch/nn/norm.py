"""``RMSNorm`` (counterpart of ``paddle_tpu/nn/norm.py``)."""
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
