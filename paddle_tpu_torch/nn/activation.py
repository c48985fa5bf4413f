"""Activation layers (counterpart of ``paddle_tpu/nn/activation.py``):
one :class:`Layer` per activation of ``functional``, its keyword
arguments fixed at construction (``LeakyReLU(negative_slope=0.2)``,
``Softmax(axis=1)``), and ``PReLU`` with its learned slopes."""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import functional as F
from .layer import Layer


def _make(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)
    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", F.relu)
ReLU6 = _make("ReLU6", F.relu6)
GELU = _make("GELU", F.gelu)
SiLU = _make("SiLU", F.silu)
Swish = _make("Swish", F.silu)
Mish = _make("Mish", F.mish)
Sigmoid = _make("Sigmoid", F.sigmoid)
LogSigmoid = _make("LogSigmoid", F.log_sigmoid)
Tanh = _make("Tanh", F.tanh)
Tanhshrink = _make("Tanhshrink", F.tanhshrink)
Hardswish = _make("Hardswish", F.hardswish)
Hardsigmoid = _make("Hardsigmoid", F.hardsigmoid)
Hardtanh = _make("Hardtanh", F.hardtanh)
Hardshrink = _make("Hardshrink", F.hardshrink)
Softshrink = _make("Softshrink", F.softshrink)
Softplus = _make("Softplus", F.softplus)
Softsign = _make("Softsign", F.softsign)
ELU = _make("ELU", F.elu)
SELU = _make("SELU", F.selu)
CELU = _make("CELU", F.celu)
LeakyReLU = _make("LeakyReLU", F.leaky_relu)
Softmax = _make("Softmax", F.softmax)
LogSoftmax = _make("LogSoftmax", F.log_softmax)
GLU = _make("GLU", F.glu)


class PReLU(Layer):
    """Leaky ReLU with learned slopes: ``weight`` [num_parameters], one
    slope, or one a channel (dim 1) of an NC... input."""

    def __init__(self, num_parameters=1, init=0.25, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(name)
        self.weight = torch.nn.Parameter(torch.full(
            (num_parameters,), init, dtype=dtype,
            device=resolve_device(device)))

    def forward(self, x):
        w = self.weight
        if w.shape[0] > 1:
            w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
        return F.prelu(x, w)
