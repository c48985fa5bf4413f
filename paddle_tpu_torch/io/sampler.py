"""Samplers (the port's copy of ``paddle_tpu/io/sampler.py``; reference:
python/paddle/io/dataloader/sampler.py, batch_sampler.py).

The same classes and the same numpy generators as the JAX package, so one
seed gives one index order in both packages, and the same resumable
state (``state_dict`` / ``load_state_dict``: the in-epoch cursor, O(1) to
save and to restore). ``DistributedBatchSampler`` shards the index space
per data-parallel rank; its rank and world size default to the installed
mesh's batch coordinate (dp x fsdp, dp major: the ranks of one
coordinate, which differ only in tp, sp, pp or ep, read the same
batches), else to ``torch.distributed``'s when a process group is
initialised, and to 0 and 1 otherwise."""
from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

import numpy as np


def _dist_world():
    """(world size, rank) of the data: the installed mesh's batch degree
    and coordinate, else the initialised ``torch.distributed`` process
    group's, or (1, 0) without one."""
    import torch.distributed as dist
    from ..distributed import env
    if env.has_mesh():
        return env.batch_coordinates()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    """In-order indices, with a resumable in-epoch cursor (preemption
    safety: ``state_dict``/``load_state_dict`` restore the exact
    position in O(1) instead of replaying consumed samples)."""

    def __init__(self, data_source=None):
        super().__init__(data_source)
        self._cursor = 0
        self._resume_cursor = 0

    def __iter__(self):
        start, self._resume_cursor = self._resume_cursor, 0
        self._cursor = start
        for i in range(start, len(self.data_source)):
            self._cursor = i + 1
            yield i
        self._cursor = 0

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, state):
        self._resume_cursor = int(state.get("cursor", 0))
        self._cursor = self._resume_cursor


class RandomSampler(Sampler):
    """Shuffled indices. The per-epoch permutation is a pure function of
    (generator seed, epoch counter): a supplied ``generator`` seed keeps
    the run reproducible while every epoch still gets a *different*
    shuffle (the epoch counter is folded into the seed — a fixed seed
    alone would replay the identical permutation each epoch), and a
    resumed run can rebuild the exact permutation it was preempted in
    from ``state_dict()``'s (epoch, cursor) in O(1)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self.epoch = 0
        self._active_epoch = None
        self._cursor = 0
        self._resume_cursor = 0

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def _seed_base(self) -> Optional[int]:
        """Int seed base, or None when ``generator`` is a Generator
        OBJECT (torch/paddle-style) whose permutations cannot be
        rebuilt from (seed, epoch)."""
        if self.generator is None:
            return 0
        try:
            return int(self.generator)
        except (TypeError, ValueError):
            return None

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.data_source)
        base = self._seed_base()
        # base None: epochs differ by advancing the generator object's
        # state; pass an int seed instead for exact (epoch,cursor) resume
        rng = np.random.default_rng(self.generator if base is None
                                    else base + epoch)
        if self.replacement:
            return rng.integers(0, n, size=self.num_samples)
        return rng.permutation(n)[:self.num_samples]

    def __iter__(self):
        e = self.epoch
        self.epoch = e + 1          # a fresh __iter__ reshuffles (legacy)
        self._active_epoch = e
        idx = self._epoch_indices(e)
        start, self._resume_cursor = self._resume_cursor, 0
        self._cursor = start
        for i in range(start, len(idx)):
            # advance BEFORE yielding: a state_dict() taken between
            # batches counts the just-delivered sample as consumed
            self._cursor = i + 1
            yield int(idx[i])
        # reset the cursor BEFORE leaving the active epoch: a state_dict
        # snapshot from another thread (prefetch producer) between the
        # two writes must never pair the next epoch with a stale cursor
        self._cursor = 0
        self._active_epoch = None

    def state_dict(self):
        """(epoch, in-epoch cursor) — enough to rebuild the exact
        permutation and position after a preemption. The fallback
        branch returns the live ``_cursor`` (not 0) so a restored-but-
        not-yet-resumed position survives a second preemption that
        lands before the first batch."""
        if self._active_epoch is not None:
            return {"epoch": self._active_epoch, "cursor": self._cursor}
        return {"epoch": self.epoch, "cursor": self._cursor}

    def load_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        cursor = int(state.get("cursor", 0))
        if self._seed_base() is None:
            # the checkpointed permutation is NOT reconstructible from a
            # generator object: resuming mid-permutation would silently
            # skip never-seen samples of a fresh shuffle — restart the
            # epoch instead (full coverage beats exact position)
            cursor = 0
        self._resume_cursor = cursor
        self._active_epoch = None
        self._cursor = self._resume_cursor

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices: Sequence[int], generator=None):
        super().__init__(indices)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        rng = np.random.default_rng(self.generator)
        yield from (self.indices[i] for i in rng.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement=True, generator=None):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        rng = np.random.default_rng(self.generator)
        p = self.weights / self.weights.sum()
        yield from rng.choice(len(self.weights), size=self.num_samples,
                              replace=self.replacement, p=p).tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle=False, batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is None:
            assert dataset is not None
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    # -------------------------------------------------- resumable state
    def state_dict(self):
        """Delegates to the wrapped sampler (sample-level cursor; the
        Trainer checkpoints at step == batch boundaries, so the cursor
        is batch-aligned in practice)."""
        if hasattr(self.sampler, "state_dict"):
            return {"sampler": self.sampler.state_dict()}
        return {}

    def load_state_dict(self, state):
        inner = state.get("sampler")
        if inner is not None and hasattr(self.sampler, "load_state_dict"):
            self.sampler.load_state_dict(inner)


class DistributedBatchSampler(BatchSampler):
    """Index-sharded batch sampler (reference:
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _dist_world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks
        # global samples consumed in the current epoch (across ALL ranks;
        # ranks advance in lockstep under SPMD, so local batches * nranks)
        self._consumed = 0
        self._resume_consumed = 0
        self._resume_nranks = self.nranks

    def _epoch_indices(self, nranks: Optional[int] = None):
        """The epoch's GLOBAL index order, padded to an even shard for
        ``nranks`` — identical on every rank and a pure function of the
        epoch seed, so any rank (under any topology) can rebuild the
        stream another topology was consuming."""
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        nranks = self.nranks if nranks is None else nranks
        total = int(math.ceil(n / nranks)) * nranks
        indices += indices[: (total - n)]  # pad to even shards
        return indices

    def __iter__(self):
        consumed, self._resume_consumed = self._resume_consumed, 0
        self._consumed = consumed
        # Resuming mid-epoch (possibly under a DIFFERENT rank count than
        # the checkpoint's): rebuild the stream AS THE SAVING TOPOLOGY
        # PADDED IT, drop the globally-consumed prefix, then re-shard
        # the REMAINING index space over the current ranks (re-padding
        # from the remainder itself, never from consumed samples).
        # Rank-strided sharding makes "consumed" topology-independent —
        # after each lockstep batch the consumed set is exactly a prefix
        # of the global order — so the new shards are non-overlapping
        # and cover precisely the unseen remainder.
        rest = self._epoch_indices(self._resume_nranks
                                   if consumed else None)[consumed:]
        self._resume_nranks = self.nranks
        if rest and len(rest) % self.nranks:
            # cycle the remainder until it divides evenly — the unseen
            # rest can be SMALLER than the pad (epoch-tail resume onto
            # many ranks), and uneven shards would break SPMD lockstep
            pad = self.nranks - len(rest) % self.nranks
            rest = rest + (rest * (-(-pad // len(rest))))[:pad]
        local = rest[self.local_rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                # advance BEFORE yielding: a state_dict() taken between
                # batches counts the delivered batch as consumed
                consumed += self.batch_size * self.nranks
                self._consumed = consumed
                yield batch
                batch = []
        if batch and not self.drop_last:
            consumed += len(batch) * self.nranks
            self._consumed = consumed
            yield batch
        # epoch completed: advance so the next wrap reshuffles (same
        # identical-shuffle-per-epoch fix as RandomSampler — nothing in
        # the Trainer calls set_epoch, which still overrides explicitly).
        # Reset consumed FIRST: a state_dict snapshot between the two
        # writes must never pair the next epoch with a full-epoch count.
        self._consumed = 0
        self.epoch += 1

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._consumed = 0
        self._resume_consumed = 0

    # -------------------------------------------------- resumable state
    def state_dict(self):
        """Topology-portable position: (epoch, globally consumed
        samples, saving rank count). ``nranks`` is LOAD-BEARING: the
        saving topology's padding defined the stream the consumed
        counter was measured against, and load_state_dict rebuilds
        exactly that stream before re-sharding the remainder. While a
        restored position is still pending (no __iter__ yet), the
        counter is still measured against the ORIGINAL saving
        topology's stream — report that nranks, not the live one."""
        return {"epoch": self.epoch, "consumed": self._consumed,
                "nranks": self._resume_nranks if self._resume_consumed
                else self.nranks}

    def load_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        self._resume_consumed = int(state.get("consumed", 0))
        self._consumed = self._resume_consumed
        # the SAVING topology's rank count: its padding defined the
        # stream the consumed counter was measured against
        self._resume_nranks = int(state.get("nranks", self.nranks))
