"""Containers (counterpart of ``paddle_tpu/nn/container.py``):
``Sequential`` and ``LayerList`` (``torch.nn.Sequential`` and
``torch.nn.ModuleList`` under the JAX names, so that the state-dict keys,
``layers.0.…`` and ``stem.0.…``, are the JAX package's), ``LayerDict``
and ``ParameterList``, each a :class:`Layer`."""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from .layer import Layer, Parameter, _as_parameter


class LayerList(nn.ModuleList, Layer):
    pass


class Sequential(nn.Sequential, Layer):
    """Layers in order; also Paddle's ``Sequential([(name, layer),
    ...])``, which names them."""

    def __init__(self, *layers):
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = (OrderedDict((str(k), v) for k, v in layers[0]),)
        super().__init__(*layers)


class LayerDict(nn.ModuleDict, Layer):
    pass


class ParameterList(Layer):
    """Parameters named "0", "1", ...: tensors, arrays or
    :class:`Parameter` declarations."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or []:
            self.append(p)

    def append(self, p):
        if isinstance(p, Parameter):
            p = _as_parameter(p.value, p.meta.trainable, p.meta.partition)
        elif not isinstance(p, nn.Parameter):
            p = _as_parameter(torch.as_tensor(p))
        self.register_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
