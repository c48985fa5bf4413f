"""DataLoader (the port's copy of ``paddle_tpu/io/dataloader.py``;
reference: python/paddle/io/dataloader/dataloader_iter.py).

The card is fed from the host, so the loader's job is to overlap host
batch assembly with device compute and to keep a steady batch shape.
Batches are numpy arrays (the trainer's ``DevicePrefetcher`` turns them
into tensors on the card). ``num_workers > 0`` on a map-style dataset
runs spawned worker processes (``io/worker.py``); an iterable dataset
takes a background thread. ``state_dict`` / ``load_state_dict`` carry the
batch sampler's cursor for O(1) resume. ``use_native=True`` (the JAX
package's C++ batch assembler) is not ported: it raises.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def bounded_put(q: "queue.Queue", item, stop: threading.Event,
                poll_s: float = 0.05) -> bool:
    """Bounded producer put that re-checks ``stop`` while the queue is
    full, so an abandoned consumer (early break, preemption exit) can't
    leave the producer thread parked forever. Returns False when stopped
    before the item fit. Shared by the DataLoader prefetch threads and
    io.device_prefetch's producer — one copy of the shutdown race."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False


def default_collate_fn(batch):
    """Stack samples into batch arrays (mirrors paddle's default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if hasattr(sample, "__array__"):
        return np.stack([np.asarray(b) for b in batch])
    return batch


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=1, shuffle=False,
                 sampler=None, batch_sampler=None, num_workers=0,
                 collate_fn: Optional[Callable] = None, drop_last=False,
                 prefetch_factor=2, use_native=False, return_list=True,  # noqa: ARG002
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        if use_native:
            raise NotImplementedError(
                "use_native=True: the native C++ batch assembler is not "
                "ported (ROADMAP A10); use the default use_native=False")
        self.use_native = use_native
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, sampler=sampler,
                                              shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    # ------------------------------------------------------------ iteration
    def _assemble(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_sync(self):
        if self._iterable:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self._assemble(indices)

    def _iter_prefetch(self):
        """Background thread pool keeps `num_workers * prefetch_factor`
        batches in flight ahead of the consumer."""
        depth = self.num_workers * self.prefetch_factor
        q: queue.Queue = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()

        class _WorkerError:
            def __init__(self, exc):
                self.exc = exc

        def put(item):
            return bounded_put(q, item, stop)

        def producer():
            try:
                for batch in self._iter_sync():
                    if not put(batch):
                        return
            except BaseException as e:  # propagate into consumer
                put(_WorkerError(e))
            finally:
                # bounded put: waits for space while the consumer drains;
                # bails out via `stop` if the consumer abandoned the
                # iterator. Never discards a queued batch.
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield item
        finally:
            stop.set()

    def _iter_multiprocess(self):
        """True multiprocess workers (io/worker.py): spawned processes,
        ordered results, persistent across epochs when asked."""
        from .worker import WorkerPool
        pool = self._pool
        if pool is None:
            # fresh base seed per pool (drawn from the ambient numpy RNG,
            # so pt.seed/np.random.seed still gives reproducible runs):
            # respawned workers must NOT replay epoch 1's augmentations
            pool = WorkerPool(self.dataset, self.collate_fn,
                              self.num_workers, self.prefetch_factor,
                              self.worker_init_fn,
                              seed=int(np.random.randint(0, 2 ** 31 - 1)))
            if self.persistent_workers:
                self._pool = pool
        try:
            yield from pool.run_epoch(iter(self.batch_sampler))
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    # -------------------------------------------------- resumable state
    def state_dict(self):
        """Sampler position for preemption-safe resume (delegated to the
        batch sampler's (epoch, cursor) state). O(1) to capture and to
        restore — no batch replay. Caveat: with ``num_workers > 0`` the
        sampler runs ahead of the consumer by up to the prefetch depth,
        so a checkpoint taken mid-epoch counts in-flight batches as
        consumed (they are skipped on resume, never double-trained); the
        synchronous path is exact. IterableDataset has no index space to
        cursor — returns {} (resume falls back to the trainer's legacy
        skip-replay)."""
        bs = self.batch_sampler
        if bs is None or not hasattr(bs, "state_dict"):
            return {}
        sd = bs.state_dict()
        return {"batch_sampler": sd} if sd else {}

    def load_state_dict(self, state):
        inner = (state or {}).get("batch_sampler")
        if inner is not None and self.batch_sampler is not None \
                and hasattr(self.batch_sampler, "load_state_dict"):
            self.batch_sampler.load_state_dict(inner)

    def shutdown(self):
        """Tear down persistent workers (no-op otherwise)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def __iter__(self):
        if self.num_workers > 0:
            # map-style -> real worker processes; an iterable dataset keeps
            # the thread prefetcher (it shards via get_worker_info only
            # when the user opts in, so default to single-stream)
            if not self._iterable:
                return self._iter_multiprocess()
            return self._iter_prefetch()
        return self._iter_sync()
