"""Explicit random generators (counterpart of ``paddle_tpu/utils/rng.py``).

The JAX package keeps a global key and splits it with ``next_key()``. The
port passes a ``torch.Generator`` to whatever draws random numbers
(weight init, sampling) instead: no module-level state. The two
frameworks give different numbers for one seed, so tests that compare
them make their inputs with numpy.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def make_generator(seed: int = 0, device=None) -> torch.Generator:
    """A generator on ``device`` (the card by default), seeded."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def fold_axis(generator: torch.Generator, axis: str) -> torch.Generator:
    """A generator decorrelated across the ranks of mesh ``axis``, for a
    draw over an activation sharded over it (counterpart of the JAX
    ``fold_axis``: the key folded with the axis index). Every rank draws
    one seed from ``generator`` (the streams stay in step: a later draw
    over a replicated activation still gives every rank the same mask)
    and seeds a new generator from it and its index on the axis. At an
    axis degree of 1 (or off a mesh), ``generator`` itself."""
    from ..distributed.collective import axis_index, axis_size
    if axis_size(axis) == 1:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    out = torch.Generator(device=generator.device)
    out.manual_seed((seed * 1_000_003 + axis_index(axis) + 1) % 2 ** 63)
    return out
