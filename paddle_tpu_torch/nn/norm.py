"""Normalization layers (counterpart of ``paddle_tpu/nn/norm.py``:
``LayerNorm``, ``RMSNorm``, ``BatchNorm2D`` and its aliases ``BatchNorm1D``,
``BatchNorm3D`` and ``BatchNorm``, ``SyncBatchNorm``, ``GroupNorm``,
``InstanceNorm2D``). Each normalises in fp32 and rounds to the input's
dtype before the weight (and bias) are applied.

BatchNorm keeps its running statistics in the buffers ``_mean`` and
``_variance``, the JAX names. A forward in training mode moves them, as
the JAX layer rebinds them, except inside :func:`running_stats_kept`,
which the ``Trainer``'s step enters: the JAX Trainer runs
``model.functional()`` without buffers, and ``Layer.bound`` restores them
after the forward, so its steps normalise by the batch's statistics and
leave the running ones where they were.

On a mesh whose dp x fsdp degree is above 1 a rank holds its own rows of
the batch, while the JAX layer normalises a global array: a training
forward all-reduces the per-channel sums over the data axes (the mean,
then the biased variance, as differentiable collectives), so every
rank normalises by the global batch's statistics and the running ones
move by them. ``SyncBatchNorm`` is the same layer, as in the JAX
package. At a degree of 1 no collective is issued
(``stat_reductions`` counts them).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F
from .layer import Layer

_kept = threading.local()
# the all-reduces of batch statistics issued in training forwards on a
# mesh that splits the batch (none at a dp x fsdp degree of 1)
stat_reductions = 0


@contextlib.contextmanager
def running_stats_kept():
    """Inside this block, on this thread, a BatchNorm in training mode
    normalises by its batch's statistics and leaves its running
    statistics as they are (the JAX Trainer's step)."""
    prev = getattr(_kept, "on", False)
    _kept.on = True
    try:
        yield
    finally:
        _kept.on = prev


class RMSNorm(Layer):
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


class LayerNorm(Layer):
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


class BatchNorm2D(Layer):
    """Batch norm over dim 1 of a [N, C, ...] input (so also the 1-D and
    3-D layers), Paddle's momentum convention (``functional.batch_norm``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self._mean, self._variance, self.weight,
                                self.bias, training=False,
                                epsilon=self.epsilon)
        from ..distributed.env import BATCH_AXES, axis_degree
        ranks = axis_degree(BATCH_AXES)
        if ranks > 1:
            global stat_reductions
            stat_reductions += 2
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=True, momentum=self.momentum, epsilon=self.epsilon,
            ranks=ranks, axes=BATCH_AXES)
        if not getattr(_kept, "on", False):
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out

    def extra_repr(self):
        return f"{self.num_features}"


BatchNorm1D = BatchNorm2D    # the same math; F.batch_norm reads the rank
BatchNorm3D = BatchNorm2D
BatchNorm = BatchNorm2D


class SyncBatchNorm(BatchNorm2D):
    """``BatchNorm``, as in the JAX package ("SyncBatchNorm == BatchNorm
    here"): every BatchNorm's batch statistics span the whole data-parallel
    batch (module docstring)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.weight = (nn.Parameter(torch.ones(num_channels, **kw))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(num_channels, **kw))
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"{self.num_groups}, {self.num_channels}, eps={self.epsilon}"


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.num_features = num_features
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)
