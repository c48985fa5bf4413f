"""The weight initializers the port's models use (counterpart of
``paddle_tpu/nn/initializer.py``: ``Constant``, ``Normal``,
``TruncatedNormal``, ``Uniform``, ``XavierNormal``, ``KaimingUniform``).

Each initializer fills a tensor in place from an explicit
``torch.Generator``. The draw is made in fp32 on the tensor's device and
then cast, as the JAX initializers draw in fp32 and ``astype``.
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    """fan_in, fan_out for a weight stored the torch way ([out, in])."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    return shape[1], shape[0]


class Initializer:
    def __call__(self, tensor: torch.Tensor, generator: torch.Generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    @torch.no_grad()
    def __call__(self, tensor, generator=None):
        return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    @torch.no_grad()
    def __call__(self, tensor, generator):
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        draw.normal_(self.mean, self.std, generator=generator)
        return tensor.copy_(draw)


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) truncated to [a, b] (the JAX initializer's
    defaults: a = -2, b = 2)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    @torch.no_grad()
    def __call__(self, tensor, generator):
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return tensor.copy_(self.mean + self.std * draw)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    @torch.no_grad()
    def __call__(self, tensor, generator):
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        draw.uniform_(self.low, self.high, generator=generator)
        return tensor.copy_(draw)


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, tensor, generator):
        fan_in, fan_out = _fans(tensor.shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std)(tensor, generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = sqrt(2) * sqrt(3 / fan_in) (the JAX
    initializer's defaults: relu gain), with fan_in given (a conv's in /
    groups x kernel size) or else the in dim of a [out, in] (or [r, in])
    weight: the JAX limit for the transposed shape."""

    def __init__(self, fan_in=None):
        self.fan_in = fan_in

    @torch.no_grad()
    def __call__(self, tensor, generator):
        fan_in = self.fan_in or _fans(tensor.shape)[0]
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        draw.uniform_(-limit, limit, generator=generator)
        return tensor.copy_(draw)
