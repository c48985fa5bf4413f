"""Asynchronous device-prefetch input pipeline (counterpart of
``paddle_tpu/io/device_prefetch.py``).

``DevicePrefetcher`` wraps any dataloader or iterable and runs batch prep
(the trainer's accumulation fold) and the host-to-device copy in a
background thread with a bounded buffer, so the next batch's assembly and
copy overlap the current step's compute. On a CUDA device the producer
stages each batch in pinned host memory, copies it ``non_blocking`` on a
side CUDA stream, and records an event; the consumer makes the current
stream wait on that event (and marks the tensors as used by it, for the
caching allocator) before it hands the batch over. On the CPU the batch
is only converted to tensors.

Preemption safety: the wrapped sampler runs AHEAD of the consumer by up
to the buffer depth, so every buffered batch carries the loader's
``state_dict()`` snapshot taken right after it was drawn, and
``state_dict()`` reports the snapshot of the last batch actually yielded:
the consumer position.

Robustness: a wedged producer must degrade, not deadlock. When the
buffer stays empty past ``stall_timeout_s`` the consumer takes the fetch
lock and feeds itself synchronously from the wrapped iterator
(``sync_fallbacks`` counts these). The lock serializes every access to
the inner iterator, so producer and degraded consumer never interleave a
fetch.
"""
from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils import observability as obs

__all__ = ["DevicePrefetcher", "default_device_put"]

_BATCH, _ERROR, _END = "batch", "error", "end"


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return type(batch)((k, _tree_map(fn, v)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(batch)
    return batch


def _leaves(batch):
    out = []
    _tree_map(out.append, batch)
    return out


def default_device_put(batch, device: torch.device):
    """A host batch (array, tensor, or a dict / list / tuple of them) as
    tensors on ``device``. To a CUDA device the copy goes through pinned
    memory and does not block the host; it runs on the current stream."""
    def put(x):
        t = torch.as_tensor(x)
        if device.type != "cuda":
            return t.to(device)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return _tree_map(put, batch)


def _bounded_put(q: "queue.Queue", item, stop: threading.Event,
                 poll_s: float = 0.05) -> bool:
    """Producer put that re-checks ``stop`` while the queue is full, so an
    abandoned consumer can't leave the producer parked forever. Returns
    False when stopped before the item fit."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False


class _PrefetchIterator:
    """One epoch's background feed; created by ``iter(DevicePrefetcher)``."""

    def __init__(self, loader, prep, device, depth, stall_timeout_s):
        self._prep = prep
        self._device = device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._stall_timeout_s = stall_timeout_s
        self._inner = iter(loader)
        self._snapshot = getattr(loader, "state_dict", None)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._lock = threading.Lock()          # serializes self._inner
        self._stop = threading.Event()
        self._exhausted = False                # inner raised StopIteration
        self._finished = False                 # consumer saw the end
        self._degraded = False                 # stall latch: sync feeding
        self.state = self._snap()              # last-YIELDED position
        self.sync_fallbacks = 0
        self._warned_stall = False
        self._g_depth = obs.gauge("prefetch_buffer_depth")
        self._c_sync = obs.counter("prefetch_sync_fallbacks_total")
        self._c_stall = obs.counter("prefetch_stall_degradations_total")
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _snap(self) -> dict:
        if self._snapshot is None:
            return {}
        try:
            return self._snapshot() or {}
        except Exception as e:     # state is best-effort; feeding is not
            print(f"[prefetch] loader state_dict failed: {e}",
                  file=sys.stderr, flush=True)
            return {}

    def _fetch_locked(self):
        """next(inner) + state snapshot + prep + placement. Caller holds
        the lock: the snapshot only means "position after this batch" if
        no other fetch is in flight. Returns ((batch, event), snapshot)."""
        batch = next(self._inner)              # may raise StopIteration
        snap = self._snap()
        if self._prep is not None:
            batch = self._prep(batch)
        if self._stream is None:
            return (default_device_put(batch, self._device), None), snap
        with torch.cuda.stream(self._stream):
            placed = default_device_put(batch, self._device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return (placed, event), snap

    def _put(self, item) -> bool:
        ok = _bounded_put(self._q, item, self._stop)
        self._g_depth.set(self._q.qsize())
        return ok

    def _produce(self):
        try:
            while not self._stop.is_set():
                with self._lock:
                    if self._stop.is_set() or self._exhausted:
                        break
                    try:
                        item = self._fetch_locked()
                    except StopIteration:
                        self._exhausted = True
                        break
                    # still under the lock: a bypassing consumer must
                    # find either this batch already queued or a free
                    # lock and an empty queue, never a batch in limbo
                    if not self._put((_BATCH, item)):
                        return
        except BaseException as e:             # propagate into the consumer
            self._put((_ERROR, e))
            return
        self._put((_END, None))

    # ------------------------------------------------------------ consumer
    def __iter__(self):
        return self

    def _hand_over(self, placed, event):
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in _leaves(placed):
                if t.is_cuda:
                    t.record_stream(current)
        return placed

    def __next__(self):
        if self._finished:
            raise StopIteration
        while True:
            if self._degraded:
                kind, payload = self._degraded_fetch()
                if kind is None:
                    continue                   # producer holds the lock
            else:
                try:
                    kind, payload = self._q.get(
                        timeout=self._stall_timeout_s)
                except queue.Empty:
                    kind, payload = self._degraded_fetch()
                    if kind is None:
                        continue
            if kind == _BATCH:
                self._g_depth.set(self._q.qsize())
                (placed, event), snap = payload
                if snap:
                    self.state = snap
                return self._hand_over(placed, event)
            if kind == _ERROR:
                self._finished = True
                self.close()
                raise payload
            self._finished = True              # _END
            self.close()
            raise StopIteration

    def _degraded_fetch(self):
        """Stall path: the producer delivered nothing for a full timeout.
        Take the fetch lock and feed synchronously: training degrades to a
        serial feed instead of deadlocking."""
        try:
            # drain the buffer BEFORE taking the lock: a recovered producer
            # blocked in its put while holding the lock needs a free slot
            item = self._q.get_nowait()
            self._degraded = False
            return item
        except queue.Empty:
            pass
        if not self._lock.acquire(timeout=self._stall_timeout_s):
            return None, None                  # producer holds the lock
        try:
            try:
                item = self._q.get_nowait()    # raced a late delivery
                self._degraded = False
                return item
            except queue.Empty:
                pass
            if self._exhausted:
                return _END, None
            if not self._warned_stall:
                self._warned_stall = True
                print(f"[prefetch] no batch for {self._stall_timeout_s:.1f}s "
                      f"(stalled prefetch thread); degrading to synchronous "
                      f"feeding", file=sys.stderr, flush=True)
                self._c_stall.inc()
                obs.record_event("prefetch_stall",
                                 timeout_s=self._stall_timeout_s)
            try:
                item = self._fetch_locked()
            except StopIteration:
                self._exhausted = True
                return _END, None
            self.sync_fallbacks += 1
            self._c_sync.inc()
            self._degraded = True              # synchronous until the
            return _BATCH, item                # producer delivers again
        finally:
            self._lock.release()

    def close(self, join_timeout_s: float = 5.0):
        """Idempotent teardown: stop the producer, discard buffered
        batches (the consumer position ``state`` is kept), join."""
        self._stop.set()
        try:
            while True:                        # unblock a producer in put()
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout_s)


class DevicePrefetcher:
    """Iterable wrapper: each ``iter()`` starts a fresh background-fed
    epoch (tearing down the previous epoch's thread first).

    ``device`` is where batches go (the CUDA card when not given; pass
    ``"cpu"`` to run on the CPU). ``state_dict()`` reports the CONSUMER
    position in the wrapped loader's own schema."""

    def __init__(self, loader: Iterable, prep: Optional[Callable] = None,
                 depth: int = 2, stall_timeout_s: float = 5.0, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.prep = prep
        self.depth = depth
        self.device = resolve_device(device)
        self.stall_timeout_s = stall_timeout_s
        self._it: Optional[_PrefetchIterator] = None
        self._last_state: Optional[dict] = None

    def __iter__(self):
        self.close()
        self._it = _PrefetchIterator(self.loader, self.prep, self.device,
                                     self.depth, self.stall_timeout_s)
        return self._it

    def state_dict(self) -> dict:
        if self._it is not None:
            return dict(self._it.state)
        if self._last_state is not None:
            # closed epoch: the wrapped loader ran AHEAD by the buffer
            # depth; the retained consumer position is the truthful one
            return dict(self._last_state)
        sd = getattr(self.loader, "state_dict", None)
        return sd() if sd is not None else {}

    def close(self):
        if self._it is not None:
            self._last_state = dict(self._it.state)
            self._it.close()
            self._it = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
