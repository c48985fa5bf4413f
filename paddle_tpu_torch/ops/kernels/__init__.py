"""Hand-written Hopper kernels and the one routing rule for them
(counterpart of ``paddle_tpu/ops/pallas/__init__.py``).

The tensor's device decides the route, and nothing else does:

- every tensor on the CPU: the kernel's plain PyTorch version;
- every tensor on a CUDA card of compute capability 9.0 or more: the
  kernel, built from ``paddle_tpu_torch/csrc`` at first use;
- anything else (a mix of devices, an older card): an error.

There is no environment flag that sends CUDA tensors to the plain
version, and no fallback when a kernel fails: the wrapper raises.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

MIN_CAPABILITY = (9, 0)
_capability: Dict[torch.device, Tuple[int, int]] = {}
_sms: Dict[int, int] = {}


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a Hopper card (launch the kernel),
    False when they all lie on the CPU (run the plain version)."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel inputs must all lie on the CPU or all on one CUDA "
            f"card; got {sorted(str(t.device) for t in tensors)}")
    dev = tensors[0].device
    cap = _capability.get(dev)
    if cap is None:
        cap = _capability[dev] = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a; this card has compute "
            f"capability {cap[0]}.{cap[1]}")
    return True


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s card (read once per card):
    kernels that split work across blocks size their grids by it."""
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card, which the
    kernels launch on. Read without building a ``torch.cuda.Stream``: that
    costs the host more per call than the short kernels take to run."""
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def counted_wrappers():
    """Every kernel wrapper, each counting its launches in ``launches``
    and ``launches_by_route``."""
    from .decode_attention import decode_attention_fwd
    from .flash_attention import (flash_attention_bwd_dkv,
                                  flash_attention_bwd_dq,
                                  flash_attention_fwd)
    from .paged_attention import paged_attention
    from .quant_matmul import quant_matmul
    from .ragged_paged_attention import ragged_paged_attention
    return (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, decode_attention_fwd,
            ragged_paged_attention, paged_attention, quant_matmul)


def launch_counts() -> Dict[Any, Tuple[int, Dict[str, int]]]:
    """{wrapper: (launches, launches by route)}, a snapshot."""
    return {fn: (fn.launches, dict(fn.launches_by_route))
            for fn in counted_wrappers()}


def add_launches(counts) -> None:
    """Add {wrapper: (launches, by route)} to the wrappers' counters (a
    CUDA graph's replay launches what its capture counted, without
    calling the wrappers)."""
    for fn, (n, by_route) in counts.items():
        fn.launches += n
        for route, k in by_route.items():
            fn.launches_by_route[route] = \
                fn.launches_by_route.get(route, 0) + k


def live_workspaces():
    """The workspaces the kernels hold now. A CUDA graph that captured
    launches keeps them alive: a workspace grown later replaces the old
    one in its module, whose memory would otherwise go back to the
    allocator while the graph still writes it."""
    from . import decode_attention, quant_matmul, ragged_paged_attention
    return [t for mod in (decode_attention, quant_matmul,
                          ragged_paged_attention)
            for pair in mod._scratch.values() for t in pair]


def check_layout(**tensors: torch.Tensor) -> None:
    """The kernels index dense row-major tensors and load 16 bytes at a
    time: each tensor must be contiguous and 16-byte aligned."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
