"""Convolution and pooling layers (counterpart of ``paddle_tpu/nn/conv.py``:
``Conv1D``, ``Conv2D``, ``Conv3D``, ``Conv2DTranspose``, ``MaxPool2D``,
``AvgPool2D``, ``AdaptiveAvgPool2D``, ``AdaptiveMaxPool2D``).

Weights keep the Paddle layout, which is torch's too: a conv's [out, in /
groups, k...], a transposed conv's [in, out / groups, k...]; ``convert``
copies them untransposed. They are drawn as the JAX layers draw them:
Kaiming-uniform on fan_in = in / groups x the kernel's size, a conv's
bias U(-1 / sqrt(fan_in), 1 / sqrt(fan_in)), a transposed conv's bias
zero; ``bias_attr=False`` builds none, and an ``Initializer`` as
``weight_attr`` replaces the weight's. Without a ``generator`` a layer
takes the ambient stream's next one (``utils.rng``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..utils import rng
from . import functional as F
from . import initializer as I
from .layer import Layer
from .common import _param
from .functional import _ntuple


class _ConvNd(Layer):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr, ndim, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        generator = generator or rng.next_generator(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, ndim)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.KaimingUniform(fan_in=fan_in)
        self.weight = _param(
            (out_channels, in_channels // groups) + self.kernel_size, init,
            generator, device, dtype)
        bound = 1 / math.sqrt(fan_in)
        self.bias = (_param((out_channels,), I.Uniform(-bound, bound),
                            generator, device, dtype)
                     if bias_attr is not False else None)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"k={self.kernel_size}, s={self.stride}, p={self.padding}, "
                f"g={self.groups}")


def _conv_class(name, ndim, fn):
    class _Conv(_ConvNd):
        _fn = staticmethod(fn)

        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, dilation=1, groups=1, weight_attr=None,
                     bias_attr=None, *, generator=None, device=None,
                     dtype=torch.float32):
            super().__init__(in_channels, out_channels, kernel_size, stride,
                             padding, dilation, groups, weight_attr,
                             bias_attr, ndim, generator=generator,
                             device=device, dtype=dtype)
    _Conv.__name__ = _Conv.__qualname__ = name
    return _Conv


Conv1D = _conv_class("Conv1D", 1, F.conv1d)
Conv2D = _conv_class("Conv2D", 2, F.conv2d)
Conv3D = _conv_class("Conv3D", 3, F.conv3d)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        generator = generator or rng.next_generator(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.dilation, self.groups = dilation, groups
        fan_in = in_channels * math.prod(self.kernel_size) // groups
        init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.KaimingUniform(fan_in=fan_in)
        self.weight = _param(
            (in_channels, out_channels // groups) + self.kernel_size, init,
            generator, device, dtype)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device,
                                              dtype=dtype))
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
