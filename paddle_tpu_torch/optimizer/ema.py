"""Exponential moving average of weights (counterpart of
``paddle_tpu/optimizer/ema.py``; reference:
paddle.incubate.ExponentialMovingAverage, shadow weights with
``apply()`` / ``restore()`` swapped in for eval).

The JAX package returns a new shadow tree each update; here the shadow
tensors are updated in place (one multiply-add pass over the parameters,
no new memory), and ``ema_update`` returns the same dict.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Shadow = a copy of the parameters (fp32 recommended for long
    averages: pass fp32 copies)."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(shadow, params, decay: float = 0.999, step=None):
    """One EMA step, in place: s = d * s + (1 - d) * p. With ``step``, the
    reference's warm-up d = min(decay, (1 + step) / (10 + step)) keeps the
    early average from being dominated by the initial weights. d and
    1 - d are fp32, as in the JAX package."""
    d = np.float32(decay)
    if step is not None:
        d = min(d, np.float32((1.0 + step) / (10.0 + step)))
    omd = float(np.float32(1.0) - d)
    d = float(d)
    for k, s in shadow.items():
        s.copy_(d * s + omd * params[k].detach().to(s.dtype))
    return shadow


class ExponentialMovingAverage:
    """Stateful facade: track a module (or a dict of parameters), swap the
    shadows in for eval with ``apply()`` and back with ``restore()``."""

    def __init__(self, layer_or_params, decay: float = 0.999,
                 use_warmup: bool = False):
        self.decay = decay
        self.use_warmup = use_warmup
        self._layer = None
        if isinstance(layer_or_params, torch.nn.Module):
            self._layer = layer_or_params
            params = self._trainable()
        else:
            params = dict(layer_or_params)
        self.shadow = ema_init(params)
        self._backup = None
        self._step = 0

    def _trainable(self):
        return {k: p for k, p in self._layer.named_parameters()
                if p.requires_grad}

    def update(self, params=None):
        if params is None:
            if self._layer is None:
                raise ValueError("pass params or track a module")
            params = self._trainable()
        step = self._step if self.use_warmup else None
        ema_update(self.shadow, params, self.decay, step)
        self._step += 1
        return self.shadow

    @torch.no_grad()
    def apply(self):
        """Copy the shadow weights into the tracked module (for eval)."""
        if self._layer is None:
            raise ValueError("apply() needs a tracked module")
        live = self._trainable()
        self._backup = {k: live[k].detach().clone() for k in self.shadow}
        for k, s in self.shadow.items():
            live[k].copy_(s.to(live[k].dtype))

    @torch.no_grad()
    def restore(self):
        if self._backup is None:
            raise ValueError("apply() first")
        live = self._trainable()
        for k, b in self._backup.items():
            live[k].copy_(b)
        self._backup = None
