"""Activation layers (counterpart of ``paddle_tpu/nn/activation.py``): the
layers of the activations ``functional`` holds, which
``TransformerEncoderLayer``'s ``activation=`` names and the vision
models build."""
from __future__ import annotations

from torch import nn

from . import functional as F


def _make(name, fn, **defaults):
    class _Act(nn.Module):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)
    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", F.relu)
GELU = _make("GELU", F.gelu)
SiLU = _make("SiLU", F.silu)
Tanh = _make("Tanh", F.tanh)
Sigmoid = _make("Sigmoid", F.sigmoid)
