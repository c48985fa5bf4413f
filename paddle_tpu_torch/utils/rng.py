"""Random generators (counterpart of ``paddle_tpu/utils/rng.py``).

Two ways to draw, as in the JAX package:

- **Explicit.** A function that draws (``F.dropout``, the initializers,
  sampling) takes a ``torch.Generator``, as the JAX function takes a key,
  and requires it where the JAX one asserts on its key.
- **The ambient stream.** ``seed(s)`` resets one process-wide stream (the
  JAX package's global key); ``next_seed()`` / ``next_generator(device)``
  take the next draw from it, as ``next_key()`` splits the global key. A
  layer built without a generator takes one from this stream, both to
  fill its weights and for its dropout masks, so ``seed(0); Net()``
  builds the same weights twice. ``generator_context(g)`` routes every
  layer draw through ``g`` for its duration, as ``key_context(key)`` does
  (``Layer.functional()``'s ``generator=``).

JAX's threefry and torch's Philox give different numbers for one seed,
so values drawn here match the JAX package's in distribution only; the
tests that compare the two make their inputs with numpy.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch

from ..device import resolve_device

_stream = torch.Generator()
_stream.manual_seed(0)
_active: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_generator", default=None)


def make_generator(seed: int = 0, device=None) -> torch.Generator:
    """A generator on ``device`` (the card by default), seeded."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def seed(s: int) -> int:
    """paddle.seed: reset the ambient stream."""
    _stream.manual_seed(int(s))
    return s


def get_rng_state() -> Dict[str, torch.Tensor]:
    return {"stream": _stream.get_state()}


def set_rng_state(state) -> None:
    _stream.set_state(state["stream"])


def next_seed() -> int:
    """The next 63-bit seed of the ambient stream."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=_stream))


def next_generator(device=None) -> torch.Generator:
    """A fresh generator on ``device`` (the card by default), seeded with
    the ambient stream's next seed."""
    return make_generator(next_seed(), device)


def ambient_generator(device=None) -> torch.Generator:
    """The generator of the active :func:`generator_context`, else
    :func:`next_generator` (a function's draw from the ambient stream, as
    the JAX functions draw ``next_key()``)."""
    active = _active.get()
    return active if active is not None else next_generator(device)


@contextlib.contextmanager
def generator_context(generator: Optional[torch.Generator]):
    """Every layer draw inside draws from ``generator`` (None: no
    change)."""
    token = _active.set(generator) if generator is not None else None
    try:
        yield
    finally:
        if token is not None:
            _active.reset(token)


class LayerGenerator:
    """A layer's source of random draws: the generator it was given, or
    one seed taken from the ambient stream at construction and a
    generator seeded with it on each device its draws land on. Inside
    :func:`generator_context` the context's generator wins."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.seed = None if generator is not None else next_seed()
        self._by_device: Dict[torch.device, torch.Generator] = {}

    def on(self, device) -> torch.Generator:
        active = _active.get()
        if active is not None:
            return active
        if self.generator is not None:
            return self.generator
        device = torch.device(device)
        gen = self._by_device.get(device)
        if gen is None:
            gen = self._by_device[device] = make_generator(self.seed, device)
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
