"""Optimizers, LR schedules and gradient clipping (counterpart of
``paddle_tpu/optimizer``): ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
every schedule of ``lr.py``, and the clips. Lamb, Adafactor, RMSProp and
the other optimizers of the JAX package come with a later training
slice."""
from . import lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   global_norm)
from .optimizers import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "global_norm", "SGD", "Adam", "AdamW",
           "Momentum", "Optimizer"]
