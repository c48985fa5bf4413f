"""Input pipeline (counterpart of ``paddle_tpu/io``): datasets, samplers
with resumable cursors, the DataLoader and its spawned worker pool, and
the device prefetcher the trainer feeds from."""
from .dataset import (ChainDataset, ConcatDataset, Dataset, IterableDataset,
                      Subset, TensorDataset, random_split)
from .dataloader import DataLoader, default_collate_fn
from .device_prefetch import DevicePrefetcher, default_device_put
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .worker import WorkerError, WorkerInfo, get_worker_info

__all__ = ["ChainDataset", "ConcatDataset", "Dataset", "IterableDataset",
           "Subset", "TensorDataset", "random_split", "DataLoader",
           "default_collate_fn", "DevicePrefetcher", "default_device_put",
           "BatchSampler", "DistributedBatchSampler", "RandomSampler",
           "Sampler", "SequenceSampler", "SubsetRandomSampler",
           "WeightedRandomSampler", "WorkerError", "WorkerInfo",
           "get_worker_info"]
