"""The port's input pipeline against the JAX package's ``paddle_tpu.io``:
for the same seed the samplers give the same index order and the same
resumable state, a state restored mid-epoch continues the same stream,
and the DataLoader gives the same batches. The worker pool mirrors the
JAX package's tests/test_dataloader_mp.py: spawned workers keep the
serial order, a dataset error and a dead worker surface as
``WorkerError`` (the ``worker_crash`` fault site included), a persistent
pool survives an abandoned epoch. The datasets the workers unpickle live
in ``torch_io_datasets.py`` (no JAX import in the workers)."""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.utils import faults
from torch_io_datasets import (DyingDataset, FailingDataset, TokenDataset,
                               WorkerIdDataset)


def _as_np(batch):
    if isinstance(batch, dict):
        return {k: _as_np(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_as_np(v) for v in batch]
    return np.asarray(batch)


def _same(a, b):
    a, b = _as_np(a), _as_np(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("generator", [None, 123])
@pytest.mark.parametrize("replacement", [False, True])
def test_random_sampler_orders_match_jax(generator, replacement):
    src = list(range(29))
    kw = dict(replacement=replacement, generator=generator,
              num_samples=17 if replacement else None)
    j, t = jio.RandomSampler(src, **kw), tio.RandomSampler(src, **kw)
    for _ in range(3):
        assert list(t) == list(j)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    ds = list(range(23))
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j = jio.DistributedBatchSampler(ds, **kw)
        t = tio.DistributedBatchSampler(ds, **kw)
        for _ in range(2):
            assert list(t) == list(j)
        assert len(t) == len(j)


def test_other_samplers_and_random_split_match_jax():
    src = list(range(12))
    assert list(tio.SequenceSampler(src)) == list(jio.SequenceSampler(src))
    for g in (5, 11):           # None draws fresh entropy in both
        assert list(tio.SubsetRandomSampler([3, 9, 1, 4], generator=g)) == \
            list(jio.SubsetRandomSampler([3, 9, 1, 4], generator=g))
        w = [0.1, 0.5, 0.2, 0.2]
        assert list(tio.WeightedRandomSampler(w, 10, generator=g)) == \
            list(jio.WeightedRandomSampler(w, 10, generator=g))
    tb = tio.BatchSampler(src, shuffle=True, batch_size=5)
    jb = jio.BatchSampler(src, shuffle=True, batch_size=5)
    assert list(tb) == list(jb) and len(tb) == len(jb) == 3
    ts = tio.random_split(tio.TensorDataset([np.arange(10)]), [7, 3],
                          generator=4)
    js = jio.random_split(jio.TensorDataset([np.arange(10)]), [7, 3],
                          generator=4)
    assert [s.indices for s in ts] == [s.indices for s in js]
    cat = tio.ConcatDataset([list(range(3)), list(range(10, 14))])
    assert [cat[i] for i in range(-1, 7)] == [13, 0, 1, 2, 10, 11, 12, 13]


@pytest.mark.parametrize("kind", ["random", "sequence", "distributed"])
def test_sampler_state_mid_epoch_matches_jax_and_resumes(kind):
    """Half an epoch into the second epoch: state_dict equal to the JAX
    sampler's; a fresh port sampler loaded with it continues with the
    JAX sampler's remaining indices."""
    src = list(range(20))

    def make(m):
        if kind == "random":
            return m.RandomSampler(src, generator=7)
        if kind == "sequence":
            return m.SequenceSampler(src)
        return m.DistributedBatchSampler(src, batch_size=2, num_replicas=2,
                                         rank=1, shuffle=True)
    j, t = make(jio), make(tio)
    list(j), list(t)                      # epoch 0
    ji, ti = iter(j), iter(t)
    head = [next(ji) for _ in range(4)]
    assert [next(ti) for _ in range(4)] == head
    assert t.state_dict() == j.state_dict()
    rest = list(ji)
    fresh = make(tio)
    fresh.load_state_dict(t.state_dict())
    assert list(fresh) == rest


def test_dataloader_batches_and_state_match_jax():
    """A shuffled DataLoader over dict samples: the same batches as the
    JAX loader for two epochs; a mid-epoch state restored into a fresh
    port loader continues with the JAX loader's batches."""
    rs = np.random.RandomState(1)
    x, y = rs.randn(14, 3).astype(np.float32), np.arange(14)

    class Pairs:
        def __getitem__(self, i):
            return {"x": x[i], "y": y[i]}

        def __len__(self):
            return 14
    kw = dict(batch_size=4, sampler=None, shuffle=True)
    jl, tl = jio.DataLoader(Pairs(), **kw), tio.DataLoader(Pairs(), **kw)
    for _ in range(2):
        for a, b in zip(tl, jl):
            _same(a, b)
    ji, ti = iter(jl), iter(tl)
    next(ji), next(ti)
    assert tl.state_dict() == jl.state_dict()
    rest = list(ji)
    fresh = tio.DataLoader(Pairs(), **kw)
    fresh.load_state_dict(tl.state_dict())
    got = list(fresh)
    assert len(got) == len(rest) == 3
    for a, b in zip(got, rest):
        _same(a, b)
    td = tio.TensorDataset([x, y])
    _same(list(tio.DataLoader(td, batch_size=5, drop_last=True)),
          list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=5,
                              drop_last=True)))


def test_distributed_sampler_reads_torch_distributed(monkeypatch):
    import torch.distributed as dist
    s = tio.DistributedBatchSampler(list(range(8)), batch_size=2)
    assert (s.nranks, s.local_rank) == (1, 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    s = tio.DistributedBatchSampler(list(range(8)), batch_size=2)
    assert (s.nranks, s.local_rank) == (4, 3)
    assert list(s) == [[3, 7]]


def test_native_loader_is_not_ported():
    with pytest.raises(NotImplementedError, match="A10"):
        tio.DataLoader(list(range(4)), use_native=True)


def test_iterable_dataset_batches_with_a_thread():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype=np.int64))
    got = [np.asarray(b) for b in tio.DataLoader(Stream(), batch_size=4,
                                                 num_workers=1)]
    assert [b.tolist() for b in got] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    with pytest.raises(TypeError):
        len(tio.DataLoader(Stream()))


# --------------------------------------------------------------- workers
def test_worker_pool_keeps_serial_order_across_workers():
    serial = [np.asarray(b) for b in tio.DataLoader(
        WorkerIdDataset(), batch_size=4, num_workers=0)]
    par = [np.asarray(b) for b in tio.DataLoader(
        WorkerIdDataset(), batch_size=4, num_workers=2)]
    assert len(serial) == len(par) == 8
    np.testing.assert_array_equal(np.concatenate(par)[:, 0], np.arange(32))
    assert set(np.concatenate(par)[:, 1]) == {0, 1}
    assert set(np.concatenate(serial)[:, 1]) == {-1}


def test_worker_errors_surface_as_worker_error(monkeypatch):
    with pytest.raises(tio.WorkerError, match="poison sample"):
        list(tio.DataLoader(FailingDataset(), batch_size=8, num_workers=2))
    with pytest.raises(tio.WorkerError, match="died"):
        list(tio.DataLoader(DyingDataset(), batch_size=4, num_workers=2))


def test_worker_crash_fault_site_ends_the_epoch(monkeypatch):
    """The ``worker_crash`` site, armed through the environment the
    spawned workers inherit, kills a worker with a batch outstanding."""
    monkeypatch.setenv(faults.ENV_VAR, "worker_crash@1")
    with pytest.raises(tio.WorkerError, match="died"):
        list(tio.DataLoader(TokenDataset(), batch_size=2, num_workers=2))


def test_persistent_pool_survives_an_abandoned_epoch():
    ds = tio.TensorDataset([np.arange(32, dtype=np.float32)])
    dl = tio.DataLoader(ds, batch_size=4, num_workers=2,
                        persistent_workers=True)
    it = iter(dl)
    next(it), next(it)
    it.close()                                 # abandon the epoch
    pool = dl._pool
    full = [np.asarray(b[0]) for b in dl]      # a fresh, complete epoch
    assert dl._pool is pool
    np.testing.assert_array_equal(np.concatenate(full),
                                  np.arange(32, dtype=np.float32))
    it1 = iter(dl)
    next(it1)
    with pytest.raises(RuntimeError, match="active iterator"):
        next(iter(dl))
    it1.close()
    dl.shutdown()
    assert dl._pool is None


def test_worker_batches_feed_the_trainer(tmp_path):
    """A shuffled DataLoader with two workers feeds the port's Trainer
    (prefetch on, the defaults otherwise): the losses equal those of the
    same loader without workers."""
    import paddle_tpu_torch as ptt
    losses = []
    for workers in (0, 2):
        torch.manual_seed(0)
        model = ptt.LlamaForCausalLM(
            ptt.llama_tiny(), device="cpu",
            generator=ptt.make_generator(0, "cpu"))
        ds = TokenDataset()
        dl = tio.DataLoader(ds, batch_size=4, num_workers=workers,
                            sampler=tio.RandomSampler(ds, generator=3))
        tr = ptt.Trainer(model, ptt.optimizer.AdamW(learning_rate=1e-3),
                         ptt.TrainingArguments(
                             output_dir=str(tmp_path / str(workers)),
                             max_steps=5, logging_steps=1),
                         train_dataloader=dl)
        tr.train()
        losses.append([v for _, v in tr.logger.history["loss"]])
    assert losses[0] == losses[1]
