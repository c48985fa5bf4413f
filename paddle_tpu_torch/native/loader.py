"""Native batch assembly for ``paddle_tpu_torch.io.DataLoader`` (the
port's copy of ``paddle_tpu/native/loader.py``; reference: Paddle's C++
DataLoader worker pool; the loader routes here when ``use_native=True``).

Python still runs ``Dataset.__getitem__`` (arbitrary user code), but the
byte-moving half of collate (stacking N samples into one contiguous
batch) runs on the native pthread pool, writing into the page-aligned
staging arena the host-to-device copy reads from.

Which way a batch went depends on its data, as in the JAX package: a
sample that is not an ndarray (or a column under 4 KiB, too small for
the pool to win) goes to ``collate_fn``. ``counts`` says how many batches
took each way: ``"native"`` (stacked on the pool) and ``"collate"``
(also a batch that finds the arena full while a view into it is still
held).
"""
from __future__ import annotations

import threading
import weakref

import numpy as np

from . import StagingArena, ThreadPool, gather_stack

_state = threading.local()
counts = {"native": 0, "collate": 0}


def _pool() -> ThreadPool:
    if not hasattr(_state, "pool"):
        _state.pool = ThreadPool()
    return _state.pool


def _arena() -> StagingArena:
    if not hasattr(_state, "arena"):
        _state.arena = StagingArena(1 << 28)   # 256 MB staging slab
        _state.live = []                       # weakrefs to handed-out views
    return _state.arena


def _stack(items):
    first = items[0]
    if isinstance(first, np.ndarray) and first.nbytes >= 4096:
        arena = _arena()
        need = first.nbytes * len(items) + 64 * len(items)
        if arena.used() + need > arena.capacity:
            # recycle only when no prior batch view is still alive:
            # prefetch queues may hold views into this slab
            _state.live = [r for r in _state.live if r() is not None]
            if _state.live:
                return None      # collate_fn copies this batch
            arena.reset()
        out = gather_stack(_pool(), items, arena)
        _state.live.append(weakref.ref(out))
        return out
    return None  # too small to win, or not an ndarray


def assemble(dataset, indices, collate_fn):
    """Gather + collate one batch, using the native stack for ndarray
    leaves."""
    batch = [dataset[i] for i in indices]
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        out = _stack(batch)
        if out is not None:
            counts["native"] += 1
            return out
    elif isinstance(sample, (list, tuple)):
        cols = []
        for i in range(len(sample)):
            col = [b[i] for b in batch]
            out = _stack(col) if isinstance(col[0], np.ndarray) else None
            if out is None:
                break
            cols.append(out)
        else:
            counts["native"] += 1
            return type(sample)(cols)
    counts["collate"] += 1
    return collate_fn(batch)
