"""Containers (counterpart of ``paddle_tpu/nn/container.py``):
``LayerList``, a ``torch.nn.ModuleList`` under the JAX name, so that the
state-dict keys (``layers.0.…``) are the JAX package's."""
from __future__ import annotations

from torch import nn


class LayerList(nn.ModuleList):
    pass
