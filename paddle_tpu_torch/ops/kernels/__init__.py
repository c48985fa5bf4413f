"""Hand-written Hopper kernels and the one routing rule for them
(counterpart of ``paddle_tpu/ops/pallas/__init__.py``).

The tensor's device decides the route, and nothing else does:

- every tensor on the CPU: the kernel's plain PyTorch version;
- every tensor on a CUDA card of compute capability 9.0 or more: the
  kernel, built from ``paddle_tpu_torch/csrc`` at first use;
- anything else (a mix of devices, an older card): an error.

There is no environment flag that sends CUDA tensors to the plain
version, and no fallback when a kernel fails: the wrapper raises.

Each wrapper counts its launches through :func:`count_launch`. A thread
inside :func:`capturing_launches` (a CUDA-graph capture: the launches do
not run) counts into its own record instead, so a capture on one thread
never takes back or absorbs the launches another thread makes meanwhile.
"""
from __future__ import annotations

import contextlib
import threading
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


_count_lock = threading.Lock()
_capture = threading.local()


def count_launch(fn, route: str) -> None:
    """One launch of wrapper ``fn`` on ``route``: into the wrapper's
    counters, or into this thread's capture record while it captures."""
    rec = getattr(_capture, "record", None)
    if rec is not None:
        n, by_route = rec.get(fn, (0, {}))
        by_route[route] = by_route.get(route, 0) + 1
        rec[fn] = (n + 1, by_route)
        return
    add_launches({fn: (1, {route: 1})})


@contextlib.contextmanager
def capturing_launches():
    """Count this thread's launches into the yielded record
    ({wrapper: (launches, by route)}) instead of the wrappers'
    counters, for the extent of the block."""
    record: Dict[Any, Tuple[int, Dict[str, int]]] = {}
    prev = getattr(_capture, "record", None)
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = prev


def add_launches(counts) -> None:
    """Add {wrapper: (launches, by route)} to the wrappers' counters (a
    CUDA graph's replay launches what its capture counted, without
    calling the wrappers)."""
    with _count_lock:
        for fn, (n, by_route) in counts.items():
            fn.launches += n
            for route, k in by_route.items():
                fn.launches_by_route[route] = \
                    fn.launches_by_route.get(route, 0) + k


_workspaces: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(kernel: str, dev: torch.device, floats: int, counters: int):
    """``kernel``'s fp32 workspace of at least ``floats`` elements and its
    int32 counters (at least ``counters``, all 0; the kernels leave them
    at 0), kept per card. Each grows to the largest size asked of it so
    far: calls whose needs alternate (a layer's seven projections) share
    one pair instead of replacing it at every call. A thread inside
    :func:`keeping_workspaces` (a CUDA-graph capture) records each pair
    it is handed, so the graph keeps alive every workspace it writes: a
    pair replaced later (grown) goes back to the allocator only once no
    graph holds it."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    work, arrivals = _workspaces.get((kernel, idx), (None, None))
    if work is None or work.numel() < floats or arrivals.numel() < counters:
        floats = max(floats, 1, 0 if work is None else work.numel())
        counters = max(counters, 1, 0 if work is None else arrivals.numel())
        work = torch.empty(floats, dtype=torch.float32, device=dev)
        arrivals = torch.zeros(counters, dtype=torch.int32, device=dev)
        _workspaces[(kernel, idx)] = (work, arrivals)
    kept = getattr(_capture, "kept", None)
    if kept is not None:
        kept[id(work)] = (work, arrivals)
    return work, arrivals


@contextlib.contextmanager
def keeping_workspaces():
    """Record, for the extent of the block, every workspace pair this
    thread's kernel calls are handed (:func:`workspace`); yields the
    record, {id: (workspace, counters)}."""
    kept: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    prev = getattr(_capture, "kept", None)
    _capture.kept = kept
    try:
        yield kept
    finally:
        _capture.kept = prev


def check_layout(**tensors: torch.Tensor) -> None:
    """The kernels index dense row-major tensors and load 16 bytes at a
    time: each tensor must be contiguous and 16-byte aligned."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
