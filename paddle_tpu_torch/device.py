"""Device choice for the port's entry points.

Every entry point takes ``device=None``: that means the CUDA card, and
raises when there is none. The CPU is used only when the caller asks for
it (``device="cpu"``), as the tests do. Nothing falls back silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
