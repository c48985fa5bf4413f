"""The weight initializers Llama and its LoRA adapters use (counterpart
of ``paddle_tpu/nn/initializer.py``: ``Constant``, ``Normal``,
``XavierNormal``, ``KaimingUniform``).

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


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, tensor, generator):
        fan_in, fan_out = _fans(tensor.shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std)(tensor, generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = sqrt(2) * sqrt(3 / fan_in) (the JAX
    initializer's defaults: relu gain), with fan_in the in dim of a
    [out, in] (or [r, in]) weight: the JAX limit for the transposed
    shape."""

    @torch.no_grad()
    def __call__(self, tensor, generator):
        limit = math.sqrt(2.0) * math.sqrt(3.0 / _fans(tensor.shape)[0])
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=tensor.device)
        draw.uniform_(-limit, limit, generator=generator)
        return tensor.copy_(draw)
