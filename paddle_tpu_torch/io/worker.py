"""Multiprocess DataLoader workers (the port's copy of
``paddle_tpu/io/worker.py``; reference:
python/paddle/io/dataloader/dataloader_iter.py's _worker_loop process
pool, and worker.py's WorkerInfo).

- Workers are SPAWNED, not forked: a forked child inherits the parent's
  CUDA context, which it cannot use. Spawn gives each worker a clean
  interpreter; the dataset and collate_fn travel by pickle, and a worker
  never touches the card (data assembly is host work).
- Each worker gets an ordered index stream (round-robin) and results are
  re-sequenced in the parent, so output order matches num_workers=0
  exactly regardless of per-worker timing.
- The ``worker_crash`` fault site hard-exits a worker with a batch
  outstanding; the parent's dead-worker check ends the epoch with a
  ``WorkerError`` instead of waiting forever.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import threading
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["WorkerInfo", "get_worker_info", "WorkerPool", "WorkerError"]

_worker_info: Optional["WorkerInfo"] = None


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: object = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process: this worker's (id, num_workers, seed,
    dataset); None in the main process. Mirrors paddle.io.get_worker_info
    — IterableDataset shards itself with this."""
    return _worker_info


class WorkerError(RuntimeError):
    """A dataset/collate exception inside a worker, with its traceback."""


def _worker_loop(dataset, index_q, result_q, collate_fn, init_fn,
                 worker_id: int, num_workers: int, seed: int):
    global _worker_info
    _worker_info = WorkerInfo(id=worker_id, num_workers=num_workers,
                              seed=seed + worker_id, dataset=dataset)
    import numpy as np
    np.random.seed((seed + worker_id) % (2 ** 31))
    try:
        if init_fn is not None:
            init_fn(worker_id)
    except BaseException as e:
        result_q.put((-1, None, (type(e).__name__, str(e),
                                 traceback.format_exc())))
        return
    from ..utils import faults
    while True:
        item = index_q.get()
        if item is None:
            break
        seq, indices = item
        # chaos: OOM-kill stand-in — die hard with this batch
        # outstanding, so the parent's dead-worker detection (not an
        # eternal queue.get) is what ends the epoch. Spawned workers
        # inherit os.environ, so the PADDLE_TPU_FAULTS arming channel
        # reaches them for free.
        if faults.inject("worker_crash", worker_id=worker_id, seq=seq):
            os._exit(1)
        try:
            batch = collate_fn([dataset[i] for i in indices])
            result_q.put((seq, batch, None))
        except BaseException as e:
            result_q.put((seq, None, (type(e).__name__, str(e),
                                      traceback.format_exc())))


class WorkerPool:
    """Spawned worker pool shared across epochs (persistent_workers) or
    torn down per-iterator. The parent pumps `prefetch_factor` batches per
    worker ahead of the consumer and re-orders results by sequence id."""

    def __init__(self, dataset, collate_fn: Callable, num_workers: int,
                 prefetch_factor: int = 2,
                 worker_init_fn: Optional[Callable] = None, seed: int = 0):
        ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self.prefetch = max(prefetch_factor, 1)
        self._index_queues = [ctx.Queue() for _ in range(num_workers)]
        self._result_q = ctx.Queue()
        self._seq = 0  # monotonic across epochs: no stale-result collisions
        self._epoch_running = False
        self._alive = True
        self._workers = []
        for wid in range(num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(dataset, self._index_queues[wid], self._result_q,
                      collate_fn, worker_init_fn, wid, num_workers, seed),
                daemon=True)
            p.start()
            self._workers.append(p)

    # ------------------------------------------------------------- epoch run
    def run_epoch(self, batch_iter):
        """Yield collated batches for one pass over ``batch_iter`` (an
        iterator of index lists), in order."""
        assert self._alive, "pool already shut down"
        if self._epoch_running:
            # two live iterators would cross-consume one result queue and
            # deadlock; fail fast instead (matches the reference loader's
            # single-iterator contract for persistent workers)
            raise RuntimeError(
                "this DataLoader's persistent worker pool already has an "
                "active iterator; exhaust or close it first")
        self._epoch_running = True
        pending = {}          # seq -> batch
        epoch_start = self._seq
        next_out = epoch_start
        in_flight = 0
        exhausted = False

        def dispatch():
            nonlocal in_flight, exhausted
            while not exhausted and in_flight < self.num_workers * self.prefetch:
                try:
                    indices = next(batch_iter)
                except StopIteration:
                    exhausted = True
                    return
                wid = self._seq % self.num_workers
                self._index_queues[wid].put((self._seq, list(indices)))
                self._seq += 1
                in_flight += 1

        try:
            dispatch()
            while in_flight > 0:
                seq, batch, err = self._get_result()
                if seq != -1 and seq < epoch_start:
                    continue  # stale result from an aborted prior epoch
                if err is not None:
                    name, msg, tb = err
                    raise WorkerError(
                        f"DataLoader worker raised {name}: {msg}\n{tb}")
                pending[seq] = batch
                in_flight -= 1
                dispatch()
                while next_out in pending:
                    yield pending.pop(next_out)
                    next_out += 1
        except BaseException:
            # consumer broke / worker raised: the epoch's remaining results
            # are stale; drain them lazily on shutdown or next epoch
            self._drain_stale()
            raise
        finally:
            self._epoch_running = False
        assert not pending

    def _get_result(self):
        """Blocking result read that notices dead workers: a worker killed
        by the OOM killer — or crashed during spawn bootstrap because the
        user's __main__ lacks an ``if __name__ == '__main__'`` guard —
        must surface as an error, not an eternal queue.get()."""
        while True:
            try:
                return self._result_q.get(timeout=2.0)
            except _queue.Empty:
                for wid, p in enumerate(self._workers):
                    # ANY dead worker while results are outstanding is
                    # fatal — including exitcode 0 (e.g. a dataset that
                    # calls sys.exit()): its batches will never arrive.
                    if not p.is_alive():
                        raise WorkerError(
                            f"DataLoader worker {wid} died "
                            f"(exitcode {p.exitcode}). With spawned workers "
                            "the launching script must guard its entry "
                            "point with `if __name__ == '__main__':`")

    def _drain_stale(self):
        try:
            while True:
                self._result_q.get_nowait()
        except _queue.Empty:
            pass

    # -------------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 5.0):
        if not self._alive:
            return
        self._alive = False
        for q in self._index_queues:
            try:
                q.put(None)
            except Exception:
                pass
        deadline = timeout
        for p in self._workers:
            p.join(timeout=deadline)
            if p.is_alive():
                p.terminate()
        self._drain_stale()
        for q in self._index_queues + [self._result_q]:
            q.close()
            q.cancel_join_thread()

    def __del__(self):
        try:
            self.shutdown(timeout=0.5)
        except Exception:
            pass
