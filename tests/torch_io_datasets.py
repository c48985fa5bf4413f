"""Datasets the DataLoader tests hand to spawned workers. Kept apart from
the test files, which import JAX: a worker imports the module that
defines its dataset, and this one imports only numpy and the port."""
import os

import numpy as np

from paddle_tpu_torch.io import get_worker_info


class WorkerIdDataset:
    def __getitem__(self, i):
        info = get_worker_info()
        return np.array([i, -1 if info is None else info.id])

    def __len__(self):
        return 32


class FailingDataset:
    def __getitem__(self, i):
        if i == 13:
            raise ValueError("poison sample")
        return np.zeros(2)

    def __len__(self):
        return 32


class DyingDataset:
    def __getitem__(self, i):
        if i == 5:
            os._exit(3)          # an OOM kill's stand-in
        return np.zeros(2)

    def __len__(self):
        return 32


class TokenDataset:
    """Seeded token rows, as the trainer's data: row i is the same in
    every process."""

    def __init__(self, n=16, s=16, vocab=256, seed=7):
        self.data = np.random.RandomState(seed).randint(0, vocab, (n, s))

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)
