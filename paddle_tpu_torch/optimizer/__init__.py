"""Optimizers, LR schedules, gradient clipping and the moving average of
weights (counterpart of ``paddle_tpu/optimizer``): every optimizer of the
JAX package (Adam and AdamW through one fused pass), every schedule of
``lr.py``, the clips, and ``ema``."""
from . import ema, lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   global_norm)
from .ema import ExponentialMovingAverage
from .optimizers import (SGD, Adadelta, Adafactor, Adagrad, Adam, Adamax,
                         AdamW, Lamb, Momentum, NAdam, Optimizer, RAdam,
                         RMSProp, Rprop)

__all__ = ["lr", "ema", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "global_norm", "ExponentialMovingAverage",
           "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp", "Lamb",
           "Adafactor", "Adadelta", "Adamax", "NAdam", "RAdam", "Rprop",
           "Optimizer"]
