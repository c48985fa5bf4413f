"""Distributed environment (counterpart of ``paddle_tpu/distributed/env.py``;
reference: python/paddle/distributed/parallel.py init_parallel_env and
fleet's topology management).

The JAX package installs one global ``jax.sharding.Mesh`` over the
devices of one controller. Here every rank is a process with one device
(a card, or the CPU when the caller asks for it), and the global mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks, with the JAX package's axis names in its order:

    dp    data parallel (parameters replicated, batch split)
    fsdp  sharded data parallel (ZeRO: parameters and moments split too)
    pp    pipeline parallel (the 1F1B and interleaved schedules)
    sp    sequence/context parallel (ring and Ulysses attention)
    ep    expert parallel (E / ep experts a rank)
    tp    tensor parallel, innermost: neighbouring ranks

``DeviceMesh`` makes a sub-group for every dimension, most of degree 1;
``get_world_size(axis)`` answers 1 for those, and the collectives of
:mod:`.collective` are the identity over them without touching the group.

NCCL on the card (the default; no fallback to the CPU), gloo when the
caller asks for the CPU (``device="cpu"``). A process group not yet
initialised is initialised here: from the environment a launcher set
(:func:`.launch.init_distributed`), else as a world of one.
"""
from __future__ import annotations

import datetime
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_lock = threading.Lock()
_global_mesh: Optional["Mesh"] = None

HYBRID_AXES = ("dp", "fsdp", "pp", "sp", "ep", "tp")  # tp innermost
# the batch is split over these axes, dp major (the JAX package's
# PartitionSpec(("dp", "fsdp")))
BATCH_AXES = ("dp", "fsdp")
# the axes of a serving replica's mesh: its ranks hold parts of one
# model (heads and columns over tp, experts over ep) and see the same
# tokens, so every one of them takes every engine call
SERVE_AXES = ("ep", "tp")
# every process-group and collective wait is bounded: a dead rank ends
# the job instead of hanging it
DEFAULT_TIMEOUT_S = 600.0
# set by ``launch --cpu`` for the ranks it starts: the caller asked for
# the CPU
DEVICE_ENV = "PADDLE_TPU_DIST_DEVICE"


class Mesh:
    """The global mesh: a ``DeviceMesh`` (``device_mesh``) named by
    ``HYBRID_AXES``, this rank's device, and the JAX mesh's read-outs:
    ``shape`` {axis: degree}, ``axis_names``, ``size``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names,
                                                device_mesh.mesh.shape)}
        self.size = int(device_mesh.mesh.numel())
        self._coord = device_mesh.get_coordinate()
        self._host_groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis not in the mesh)."""
        if axis not in self.shape:
            return 0
        return int(self._coord[self.axis_names.index(axis)])

    def ranks(self, axes) -> Tuple[int, ...]:
        """The global ranks along ``axes`` (a name or a tuple of names)
        through this rank, ordered by their flattened index, first axis
        major."""
        live = [a for a in _axes(axes) if self.shape.get(a, 1) > 1]
        me = dist.get_rank()
        if not live:
            return (me,)
        return tuple(next(row for row in self._rows(live) if me in row))

    def _rows(self, live):
        """Every group of ranks along the axes ``live`` (each row holds
        the ranks whose other coordinates are equal), as lists."""
        dims = [self.axis_names.index(a) for a in live]
        ranks = self.device_mesh.mesh
        n = int(np.prod([ranks.shape[d] for d in dims]))
        return ranks.movedim(dims, list(range(-len(dims), 0))).reshape(
            -1, n).tolist()

    def group(self, axis: str):
        """The process group of ``axis`` (its degree must exceed 1)."""
        return self.device_mesh.get_group(axis)

    def host_group(self, axes):
        """A gloo process group over the ranks along ``axes`` (a name or
        a tuple of names) through this rank, for checks of host state
        (CPU tensors: no device stream waits for them): one axis's own
        group under gloo, else one made on the first call, which every
        rank of the world makes at the same point of its program
        (``new_group`` is collective). Their degree must exceed 1."""
        live = tuple(a for a in _axes(axes) if self.shape.get(a, 1) > 1)
        g = self._host_groups.get(live)
        if g is not None:
            return g
        if dist.get_backend() == "gloo" and len(live) == 1:
            g = self.group(live[0])
        else:
            me = dist.get_rank()
            for row in self._rows(live):
                made = dist.new_group(row, backend="gloo")
                if me in row:
                    g = made
        self._host_groups[live] = g
        return g


@dataclass(frozen=True)
class NamedSharding:
    """A partition spec on the mesh (the counterpart of
    ``jax.sharding.NamedSharding``): ``spec[d]`` names the axis, or tuple
    of axes, that splits tensor dim d, or None. ``placements`` is the
    ``DTensor`` form: one ``Shard(d)`` or ``Replicate()`` per mesh axis.
    ``fused`` > 1 (a fused projection's weight, ``nn.common.set_fused``)
    makes a tp split of dim 0 cut each of that many blocks apart: a
    strided shard, rank t holding its part of every block."""
    mesh: Mesh
    spec: Tuple
    fused: int = 1

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        out = {a: Replicate() for a in self.mesh.axis_names}
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            for a in (axes,) if isinstance(axes, str) else axes:
                out[a] = Shard(d)
                if a == "tp" and d == 0 and self.fused > 1:
                    from torch.distributed.tensor.placement_types import \
                        _StridedShard
                    out[a] = _StridedShard(0, split_factor=self.fused)
        return [out[a] for a in self.mesh.axis_names]


def _resolve_device(device) -> torch.device:
    if device is None and os.environ.get(DEVICE_ENV):
        device = os.environ[DEVICE_ENV]
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


def _ensure_process_group(dev: torch.device, timeout_s: float):
    if dist.is_initialized():
        return
    from .launch import init_distributed
    info = init_distributed(device=dev, timeout_s=timeout_s)
    if info["process_count"] == 1 and not dist.is_initialized():
        # a world of one: a store in this process, no port
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": dev} if dev.type == "cuda" else {}))


def init_parallel_env(mesh_shape: Optional[Dict[str, int]] = None,
                      device=None,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Create and install the global mesh over the process group's ranks.

    ``mesh_shape`` maps axis name -> degree, e.g. {"dp": 2, "tp": 4};
    missing axes get degree 1, and ``dp``, when not given, absorbs the
    ranks left over. The product must equal the world size. ``device``
    None is the card (rank r on card ``LOCAL_RANK``, NCCL); "cpu" asks
    for the CPU (gloo)."""
    global _global_mesh
    from torch.distributed.device_mesh import init_device_mesh
    dev = _resolve_device(device)
    _ensure_process_group(dev, timeout_s)
    n = dist.get_world_size()
    mesh_shape = dict(mesh_shape or {})
    unknown = set(mesh_shape) - set(HYBRID_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes "
                         f"are {HYBRID_AXES}")
    degrees = [int(mesh_shape.get(a, 1)) for a in HYBRID_AXES]
    specified = int(np.prod([d for d in degrees if d > 0]))
    if "dp" not in mesh_shape and specified < n and n % specified == 0:
        mesh_shape["dp"] = n // specified
        degrees = [int(mesh_shape.get(a, 1)) for a in HYBRID_AXES]
    total = int(np.prod(degrees))
    if total != n:
        raise ValueError(f"mesh {dict(zip(HYBRID_AXES, degrees))} has "
                         f"{total} ranks; the world has {n}")
    dm = init_device_mesh(dev.type, tuple(degrees),
                          mesh_dim_names=HYBRID_AXES)
    with _lock:
        _global_mesh = Mesh(dm, dev)
    return _global_mesh


def clear_mesh():
    """Uninstall the global mesh (the process group stays)."""
    global _global_mesh
    with _lock:
        _global_mesh = None


def set_mesh(mesh: Mesh) -> Mesh:
    global _global_mesh
    with _lock:
        _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The installed mesh; with none, pure data parallel over the world
    (on the card), as the JAX package does."""
    if _global_mesh is None:
        init_parallel_env()
    return _global_mesh


def has_mesh() -> bool:
    return _global_mesh is not None


is_initialized = has_mesh


def get_world_size(axis: Optional[str] = None) -> int:
    """The mesh's size, or the degree of ``axis`` (1 for an axis of
    degree 1 or absent)."""
    mesh = get_mesh()
    if axis is None:
        return mesh.size
    return mesh.shape.get(axis, 1)


def get_rank(axis: Optional[str] = None) -> int:
    """This process's global rank, or its index along ``axis``."""
    if axis is None:
        return dist.get_rank() if dist.is_initialized() else 0
    return get_mesh().coordinate(axis)


def axis_degree(axes) -> int:
    """The product of the degrees of ``axes`` (a name or a tuple of names)
    on the installed mesh; 1 without a mesh."""
    if not has_mesh():
        return 1
    shape = _global_mesh.shape
    return int(np.prod([shape.get(a, 1) for a in _axes(axes)]))


def axis_coordinate(axes) -> int:
    """This rank's index along the flattened ``axes`` (first axis major);
    0 without a mesh."""
    if not has_mesh():
        return 0
    idx = 0
    for a in _axes(axes):
        idx = idx * _global_mesh.shape.get(a, 1) + _global_mesh.coordinate(a)
    return idx


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def sharding(*spec) -> NamedSharding:
    """A :class:`NamedSharding` over the global mesh from a
    PartitionSpec-like tuple."""
    return NamedSharding(get_mesh(), tuple(spec))


def replicated() -> NamedSharding:
    return NamedSharding(get_mesh(), ())


def barrier():
    """Every rank of the world (reference: paddle.distributed.barrier);
    nothing without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def batch_coordinates(axes: Sequence[str] = BATCH_AXES) -> Tuple[int, int]:
    """(degree, index) of this rank along the batch axes."""
    return axis_degree(tuple(axes)), axis_coordinate(tuple(axes))
