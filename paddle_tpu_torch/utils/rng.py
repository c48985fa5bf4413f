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
