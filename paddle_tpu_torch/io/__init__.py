"""Input pipeline (counterpart of ``paddle_tpu/io``): the device
prefetcher the trainer feeds from. The DataLoader, samplers and workers
come with a later training slice."""
from .device_prefetch import DevicePrefetcher, default_device_put

__all__ = ["DevicePrefetcher", "default_device_put"]
