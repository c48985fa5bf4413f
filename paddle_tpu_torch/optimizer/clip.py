"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``).

Each clip takes a dict ``{name: gradient}``, scales or clamps the
gradients in place (``torch._foreach_*`` where a whole dict is scaled by
one factor) and returns the same dict. Norms are taken in fp32 whatever
the gradients' dtype, as in the JAX package. A gradient may be a
``DTensor`` (a parameter sharded on the mesh): its norm is that of the
logical tensor, each element counted once (``sharding.full_norms``), and
it is scaled or clamped in its local shard.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..parallel.sharding import full_norms, local


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every gradient's squared entries), fp32, as a tensor on
    the gradients' device."""
    return torch.linalg.vector_norm(torch.stack(full_norms(grads.values())))


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
            local(g).clamp_(self.min, self.max)
        return grads


class ClipGradByNorm(GradClipBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def __call__(self, grads):
        for g, n in zip(grads.values(), full_norms(grads.values())):
            local(g).mul_(torch.clamp(self.clip_norm / n.clamp_min(1e-12),
                                      max=1.0))
        return grads


class ClipGradByGlobalNorm(GradClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def scale(self, grads, inv_scale=None) -> torch.Tensor:
        """The clip factor min(1, clip_norm / global norm) as an fp32
        tensor on the gradients' device, without touching the gradients:
        the fused Adam pass multiplies by it. With a GradScaler's
        ``inv_scale`` the norm is that of the unscaled gradients, taken
        as ``inv_scale`` times the scaled gradients' norm (the norm is
        homogeneous, and the scale is a power of two: the same value as
        the norm of the unscaled copies, without making them)."""
        norm = global_norm(grads)
        if inv_scale is not None:
            norm = norm * inv_scale
        return torch.clamp(self.clip_norm / norm.clamp_min(1e-12), max=1.0)

    @torch.no_grad()
    def __call__(self, grads):
        if not grads:
            return grads
        torch._foreach_mul_([local(g) for g in grads.values()],
                            self.scale(grads))
        return grads
