"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``).

Each clip takes a dict ``{name: gradient}``, scales or clamps the
gradients in place (``torch._foreach_*`` where a whole dict is scaled by
one factor) and returns the same dict. Norms are taken in fp32 whatever
the gradients' dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every gradient's squared entries), fp32, as a tensor on
    the gradients' device."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


class GradClipBase:
    def __call__(self, grads: Dict[str, torch.Tensor]):
        raise NotImplementedError


class ClipGradByValue(GradClipBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = min if min is not None else -max

    @torch.no_grad()
    def __call__(self, grads):
        for g in grads.values():
            g.clamp_(self.min, self.max)
        return grads


class ClipGradByNorm(GradClipBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, grads):
        for g in grads.values():
            n = torch.linalg.vector_norm(g, dtype=torch.float32)
            g.mul_(torch.clamp(self.clip_norm / n.clamp_min(1e-12), max=1.0))
        return grads


class ClipGradByGlobalNorm(GradClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, grads):
        if not grads:
            return grads
        scale = torch.clamp(
            self.clip_norm / global_norm(grads).clamp_min(1e-12), max=1.0)
        torch._foreach_mul_(list(grads.values()), scale)
        return grads
