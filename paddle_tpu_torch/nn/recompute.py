"""Activation recompute (counterpart of ``paddle_tpu/nn/recompute.py``).

The JAX package wraps a function in ``jax.checkpoint`` with a policy that
says which intermediates the backward may keep. Here that is
``torch.utils.checkpoint`` (non-reentrant), with the same policy names:

- ``full`` and ``nothing_saveable``: save nothing, recompute everything;
- ``dots_saveable`` and ``dots_with_no_batch_dims_saveable``: keep the
  outputs of the matrix products (``mm``, ``addmm``, ``bmm`` for the
  first; the two-dimensional ``mm`` / ``addmm`` of the weight products
  for the second) and recompute the rest;
- ``everything_saveable``: no checkpoint at all.

The forward is replayed with the same inputs and no random state of its
own, so the recompute is deterministic (the port's forward draws no
random numbers; dropout comes with a later slice).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)

POLICIES = {
    "full": None,
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "everything_saveable": "everything",
}


def _keep(ops, ctx, op, *args, **kwargs):  # noqa: ARG001
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _resolve(policy):
    if policy is None:
        return None
    if isinstance(policy, str):
        if policy not in POLICIES:
            raise ValueError(f"unknown recompute policy {policy!r}; one of "
                             f"{sorted(POLICIES)}")
        return POLICIES[policy]
    return policy


def recompute(function, *args, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` so that its backward recomputes
    the forward instead of keeping its activations (``policy``: a name of
    ``POLICIES`` or a tuple of aten ops whose outputs are kept)."""
    ops = _resolve(policy)
    if ops == "everything":
        return function(*args, **kwargs)
    extra = {}
    if ops:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_keep, tuple(ops)))
    return checkpoint(function, *args, use_reentrant=False, **extra,
                      **kwargs)


def checkpoint_wrapper(layer_or_fn, policy=None):
    """Wrap a module (its ``forward``) or a function so that every call
    is recomputed in the backward."""
    if isinstance(layer_or_fn, torch.nn.Module):
        layer = layer_or_fn
        orig_forward = layer.forward

        def wrapped(*args, **kwargs):
            return recompute(orig_forward, *args, policy=policy, **kwargs)
        layer.forward = wrapped
        return layer
    return functools.wraps(layer_or_fn)(
        functools.partial(recompute, layer_or_fn, policy=policy))
