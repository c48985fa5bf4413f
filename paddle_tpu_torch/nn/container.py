"""Containers (counterpart of ``paddle_tpu/nn/container.py``):
``LayerList`` and ``Sequential``, ``torch.nn.ModuleList`` and
``torch.nn.Sequential`` under the JAX names, so that the state-dict keys
(``layers.0.…``, ``stem.0.…``) are the JAX package's."""
from __future__ import annotations

from torch import nn


class LayerList(nn.ModuleList):
    pass


class Sequential(nn.Sequential):
    pass
