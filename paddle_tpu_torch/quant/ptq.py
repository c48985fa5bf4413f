"""Post-training quantization with activation calibration (counterpart of
``paddle_tpu/quant/ptq.py``; reference: python/paddle/quantization, PTQ
with AbsmaxObserver, and the paddlenlp llm A8W8 recipes).

Calibration is a host-side pass: forward pre-hooks record each Linear's
input abs-max over the calibration batches. ``convert`` then removes the
hooks and swaps each observed Linear for a ``W8A8Linear``, whose forward
fake-quantizes its activations with the FROZEN calibrated scale and runs
the int8 weight-only matmul (``QuantizedLinear``: the quantized-matmul
kernel on the card at decode's row counts).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from .weight_only import QuantizedLinear

__all__ = ["AbsMaxObserver", "PTQ", "W8A8Linear"]


class AbsMaxObserver:
    """Running abs-max over calibration batches (reference:
    paddle.quantization.observers.AbsmaxObserver); ``ema`` smooths
    outliers the way the reference's EMA observer does. Each update
    reads one number back to the host."""

    def __init__(self, ema: float = 0.0):
        self.ema = ema
        self.stat: Optional[float] = None

    def update(self, x):
        cur = float(torch.as_tensor(x).float().abs().amax())
        if self.stat is None or self.ema == 0.0:
            self.stat = cur if self.stat is None else max(self.stat, cur)
        else:
            self.stat = self.ema * self.stat + (1 - self.ema) * cur

    def scale(self) -> float:
        return max(self.stat or 0.0, 1e-8) / 127.0


class W8A8Linear(QuantizedLinear):
    """int8 weights and int8-fake-quantized activations with a frozen
    calibrated scale (reference: paddlenlp llm A8W8). A
    ``QuantizedLinear``, so its tp contracts and its kernel route carry
    over."""

    def __init__(self, *args, act_scale: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.act_scale = float(act_scale)

    def forward(self, x):
        # the activations rounded to int8 codes of the frozen scale, in
        # fp32, and cast back. The scale is a fill on the device, not a
        # host copy (a captured step replays it), and a tensor divisor,
        # not a Python one (which CUDA turns into a reciprocal multiply)
        s = torch.full((), self.act_scale, dtype=torch.float32,
                       device=x.device)
        xq = (torch.clamp(torch.round(x.float() / s), -127, 127)
              * s).to(x.dtype)
        return super().forward(xq)

    def extra_repr(self):
        return (f"{super().extra_repr()}, "
                f"A8 act_scale={self.act_scale:.3g}")


class PTQ:
    """Calibrate, then convert (reference: paddle.quantization.PTQ).

    ptq = PTQ(model)                      # hooks every Linear-family layer
    for batch in calib_data: model(batch) # observers record abs-max
    ptq.convert()                         # swap in W8A8Linear, drop hooks

    ``skip``: path prefixes or substrings to leave in full precision.
    """

    def __init__(self, model: nn.Module, ema: float = 0.0,
                 skip: Optional[List[str]] = None):
        from ..nn.common import Linear
        self.model = model
        self.observers: Dict[str, AbsMaxObserver] = {}
        self._hooked = []
        skip = tuple(skip or ())
        for path, sub in model.named_modules():
            if not path or not isinstance(sub, Linear):
                continue
            if path.startswith(skip) or any(s in path for s in skip):
                continue
            obs = AbsMaxObserver(ema=ema)
            self.observers[path] = obs
            handle = sub.register_forward_pre_hook(
                lambda layer, args, _obs=obs: _obs.update(args[0]) or None)
            self._hooked.append((path, sub, handle))
        if not self.observers:
            raise ValueError("no Linear-family layers to calibrate")

    @torch.no_grad()
    def convert(self, bits: int = 8, block_size: int = 128) -> nn.Module:
        """Swap the calibrated layers for W8A8Linear in place and remove
        the hooks. A layer whose in_features ``block_size`` does not
        divide takes one scale block over all its input rows."""
        uncalibrated = [p for p, o in self.observers.items()
                        if o.stat is None]
        if uncalibrated:
            raise RuntimeError(
                f"run calibration batches first; no activations seen for "
                f"{uncalibrated[:4]}")
        for path, sub, handle in self._hooked:
            handle.remove()
            parent = self.model
            parts = path.split(".")
            for p in parts[:-1]:
                parent = getattr(parent, p)
            din = sub.in_features
            bs = block_size if din % block_size == 0 else din
            lay = W8A8Linear.from_linear(sub, bits=bits, block_size=bs)
            lay.act_scale = self.observers[path].scale()
            setattr(parent, parts[-1], lay)
        self._hooked = []
        return self.model
