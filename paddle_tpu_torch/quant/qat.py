"""Quantization-aware training (counterpart of ``paddle_tpu/quant/qat.py``;
reference: PaddleSlim QAT, fake-quant around the matmuls with a
straight-through gradient).

``fake_quant`` is a plain function with a straight-through estimator, so
it runs inside the ordinary train step: the scale comes from the current
tensor (dynamic), the point PaddleSlim's moving-average observers
converge to.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as F


def fake_quant(x, bits: int = 8, axis=None):
    """Simulated symmetric quantization with a straight-through gradient:
    the forward rounds ``x`` to ``bits``-bit codes times an abs-max scale
    (over all of ``x``, or per slice along the dims ``axis`` reduces),
    the backward passes the gradient through as the identity."""
    qmax = 2.0 ** (bits - 1) - 1
    if axis is None:
        scale = x.abs().amax() / qmax
    else:
        scale = x.abs().amax(dim=axis, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()   # STE


class FakeQuantLinear(nn.Module):
    """A Linear with fake-quantized weights (and optionally activations)
    for QAT fine-tuning; export with ``quant.quantize_blockwise`` after.
    The weight is [out, in] (the JAX package's is [in, out]), so its
    per-output-channel scale reduces the in dim: ``axis=1`` here for the
    JAX ``axis=0``. The wrapped layer's tp collectives are not applied,
    as in the JAX package (a plain ``F.linear``)."""

    def __init__(self, linear, bits: int = 8,
                 quant_activations: bool = False):
        super().__init__()
        self.inner = linear
        self.bits = bits
        self.quant_activations = quant_activations

    def forward(self, x):
        if self.quant_activations:
            x = fake_quant(x, self.bits)
        w = fake_quant(self.inner.weight, self.bits, axis=1)
        return F.linear(x, w, getattr(self.inner, "bias", None))
