"""Core layers (counterpart of ``paddle_tpu/nn/common.py``: ``Linear``,
``Embedding``, ``Bilinear``, the dropouts, the pads, pools, shuffles and
the other thin layers over ``functional``), each a :class:`Layer`.

Each layer with weights allocates them on ``device`` (the card unless the
caller asks for the CPU) in ``dtype`` and fills them from the
``generator`` it is given, or else from the next generator of the
ambient stream (``utils.rng``: ``paddle_tpu_torch.seed(s)`` makes the
draws repeat). A layer with random masks draws them from that generator
too. Linear weights are stored [out, in], the torch way; the JAX package
stores [in, out]; an initializer given as ``weight_attr`` reads the JAX
shape's fans (``initializer``).

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

from .. import tensor as _tensor
from ..device import resolve_device
from ..utils import rng
from . import functional as F
from . import initializer as I
from .layer import Layer


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


def _init(attr, default):
    return attr if isinstance(attr, I.Initializer) else default


class Linear(Layer):
    """y = x W^T + b, W stored [out, in]. ``weight_attr`` / ``bias_attr``
    as in Paddle: an ``Initializer`` fills the weight (bias);
    ``bias_attr=False`` (or ``has_bias=False``) leaves no bias."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 has_bias: bool = True, device=None, dtype=torch.float32):
        super().__init__(name)
        device = resolve_device(device)
        generator = generator or rng.next_generator(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((out_features, in_features),
                             _init(weight_attr, I.XavierNormal()), generator,
                             device, dtype)
        self.bias = (_param((out_features,), _init(bias_attr, I.Constant(0.0)),
                            generator, device, dtype)
                     if has_bias and bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(name)
        device = resolve_device(device)
        generator = generator or rng.next_generator(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = _param((num_embeddings, embedding_dim),
                             _init(weight_attr, I.Normal(0.0, 1.0)),
                             generator, device, dtype)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Bilinear(Layer):
    """x1 W x2 + b, W [out, in1, in2] in both packages."""

    def __init__(self, in1_features, in2_features, out_features,
                 bias_attr=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        generator = generator or rng.next_generator(device)
        self.weight = _param((out_features, in1_features, in2_features),
                             I.XavierNormal(), generator, device, dtype)
        self.bias = (_param((out_features,), I.Constant(0.0), generator,
                            device, dtype) if bias_attr is not False
                     else None)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _Random(Layer):
    """A layer with random masks: drawn from the generator it was given,
    else from one seeded by the ambient stream at construction
    (``utils.rng.LayerGenerator``)."""

    def __init__(self, generator=None):
        super().__init__()
        self.generator = generator
        self._draws = rng.LayerGenerator(generator)

    def _gen(self, x):
        return self._draws.on(x.device)


class Dropout(_Random):
    """Dropout in Paddle's two modes (``functional.dropout``)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = p
        self.mode = mode

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return F.dropout(x, self.p, training=False, mode=self.mode)
        return F.dropout(x, self.p, training=True, generator=self._gen(x),
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class Dropout2D(_Random):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__(generator)
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return F.dropout2d(x, self.p, training=True, generator=self._gen(x))


class Dropout3D(_Random):
    def __init__(self, p=0.5, *, generator=None):
        super().__init__(generator)
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return F.dropout3d(x, self.p, training=True, generator=self._gen(x))


class AlphaDropout(_Random):
    def __init__(self, p=0.5, *, generator=None):
        super().__init__(generator)
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return F.alpha_dropout(x, self.p, training=True,
                               generator=self._gen(x))


class RReLU(_Random):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, *, generator=None):
        super().__init__(generator)
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if not self.training:
            return F.rrelu(x, self.lower, self.upper, training=False)
        return F.rrelu(x, self.lower, self.upper, training=True,
                       generator=self._gen(x))


class _Call(Layer):
    """A layer that calls ``fn(x, *args)`` with its constructor's
    arguments."""
    fn = None

    def __init__(self, *args):
        super().__init__()
        self.args = args

    def forward(self, x):
        return type(self).fn(x, *self.args)


class Identity(Layer):
    def forward(self, x):
        return x


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return _tensor.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size, scale_factor, "bilinear", True)


class Pad2D(Layer):
    """``tensor.pad``, as the JAX layer calls it: a flat [lo0, hi0, lo1,
    hi1, ...] pads the trailing dims in order (pair 0 on the first of
    them), an int every dim; ``mode`` a ``jnp.pad`` mode."""

    def __init__(self, padding, mode="constant", value=0.0):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return _tensor.pad(x, self.padding, self.mode, self.value)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     data_format="NCL")


class ZeroPad2D(_Call):
    fn = staticmethod(F.zeropad2d)

    def __init__(self, padding):
        super().__init__(padding)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.args = (p, epsilon, keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, *self.args)


class _PoolND(_Call):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__(kernel_size, stride, padding)


class MaxPool1D(_PoolND):
    fn = staticmethod(F.max_pool1d)


class MaxPool3D(_PoolND):
    fn = staticmethod(F.max_pool3d)


class AvgPool1D(_PoolND):
    fn = staticmethod(F.avg_pool1d)


class AvgPool3D(_PoolND):
    fn = staticmethod(F.avg_pool3d)


class AdaptiveAvgPool1D(_Call):
    fn = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size):
        super().__init__(output_size)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x, indices, output_size=None):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size)


class Fold(_Call):
    fn = staticmethod(F.fold)

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__(output_sizes, kernel_sizes, strides, paddings,
                         dilations)


class Unfold(_Call):
    fn = staticmethod(F.unfold)

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__(kernel_sizes, strides, paddings, dilations)


class PixelShuffle(_Call):
    fn = staticmethod(F.pixel_shuffle)

    def __init__(self, upscale_factor):
        super().__init__(upscale_factor)


class PixelUnshuffle(_Call):
    fn = staticmethod(F.pixel_unshuffle)

    def __init__(self, downscale_factor):
        super().__init__(downscale_factor)


class ChannelShuffle(_Call):
    fn = staticmethod(F.channel_shuffle)

    def __init__(self, groups):
        super().__init__(groups)


class LocalResponseNorm(_Call):
    fn = staticmethod(F.local_response_norm)

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0):
        super().__init__(size, alpha, beta, k)


class Maxout(_Call):
    fn = staticmethod(F.maxout)

    def __init__(self, groups, axis=1):
        super().__init__(groups, axis)


class ThresholdedReLU(_Call):
    fn = staticmethod(F.thresholded_relu)

    def __init__(self, threshold=1.0):
        super().__init__(threshold)
