"""Datasets (the port's copy of ``paddle_tpu/io/dataset.py``, which is
numpy only; reference: python/paddle/io/dataloader/dataset.py)."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not indexable")

    def __len__(self):
        raise TypeError("IterableDataset has no length")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lengths = {len(t) for t in tensors}
        assert len(lengths) == 1, "all tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ConcatDataset(Dataset):
    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative, idx)
        prev = 0 if ds_idx == 0 else self.cumulative[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Iterable[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    total = len(dataset)
    assert sum(lengths) == total
    rng = np.random.default_rng(generator)
    perm = rng.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
