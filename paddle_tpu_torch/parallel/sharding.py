"""Parameter sharding on the mesh (counterpart of
``paddle_tpu/parallel/sharding.py``; reference:
paddle/distributed/fleet/base/topology.py and meta_parallel/*).

In the JAX package a parameter stays a logically full-size array with a
``NamedSharding`` resolved from its ``ParamMeta.partition`` (a tuple of
mesh-axis names, e.g. ``("tp", None)``), and GSPMD inserts the
collectives. The torch counterpart of such an array is a ``DTensor``:
``shard_layer`` replaces every parameter by an ``nn.Parameter`` holding
a DTensor with the placements its partition (in the port's layout, see
``nn.common.partition_of``) resolves to, fsdp included. ZeRO stages 1-3
are not separate code paths: sharding the optimizer state, the gradients
or the parameters over ``fsdp`` is stages 1, 2 or 3.

The forward runs on local tensors. A pre-hook on the sharded root module
(:func:`materialize`) makes each parameter's compute tensor: fsdp shards
gathered, tp shards kept (the tp layers of ``parallel.layers`` run on
them with explicit collectives), ep shards kept (``MoEMLP`` multiplies
this rank's experts), everything else replicated; it is
``DTensor.redistribute(...).to_local(grad_placements=...)``, so autograd
returns each parameter's gradient as a DTensor in the parameter's own
placements: the local gradients are declared partial sums over the
batch axes (dp, fsdp, sp) of degree > 1, and the backward sums them (an
all-reduce, or a reduce-scatter onto an fsdp shard). The compute
tensors shadow the parameters as instance attributes until
:func:`release` (or the next forward): a recomputed layer's backward
reads them again.

Serving holds its weights still: :func:`bind_static` makes and binds the
compute tensors once and removes the pre-hook, so no redistribute runs
in a captured decode step or tick (with tp only, each compute tensor is
the parameter's local shard itself, not a copy). A quantized layer's
codes and scales are buffers, not parameters: a module that lists
``buffer_partitions()`` has each such buffer cut to this rank's shard by
:func:`shard_layer` (a plain tensor: the layer reads its shard and
calls its collectives itself).

A model too large for one rank to hold whole (Llama-3-70B is ~141 GB in
bf16) is built inside :func:`sharded_build`: its constructor cuts each
decoder layer to this rank's shards as soon as the layer's weights are
drawn (:func:`shard_built`), and :func:`shard_layer` then cuts the rest.

Also here, as in the JAX package: the partition validator (unknown axes,
non-dividing degrees rejected when the sharding is resolved) and
``constraint``, which becomes a redistribute of an activation: the
identity with no mesh, and axes that do not divide a dimension dropped.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..distributed.env import (BATCH_AXES, Mesh, NamedSharding, get_mesh,
                               has_mesh)
from ..nn.common import partition_of

# the axes a parameter's local gradient is a partial sum over: each rank
# of them sees other data. Not ep: its ranks see the same tokens (the
# JAX package splits activations over dp and fsdp only) and each holds
# the whole loss, so a replicated parameter's gradient is whole there
GRAD_SUM_AXES = BATCH_AXES + ("sp",)


class ShardingError(ValueError):
    """Invalid partition: unknown mesh axis or non-divisible dimension."""


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def validate_partition(shape: Tuple[int, ...], partition, mesh: Mesh,
                       name: str = "<param>") -> None:
    """Reject a partition that names an axis the mesh lacks, has more
    entries than the shape, or splits a dim its degree does not divide."""
    if partition is None:
        return
    if len(partition) > len(shape):
        raise ShardingError(
            f"{name}: partition {partition} has more entries than shape "
            f"{tuple(shape)}")
    for dim, axes in enumerate(partition):
        if axes is None:
            continue
        degree = 1
        for ax in _axes(axes):
            if ax not in mesh.shape:
                raise ShardingError(
                    f"{name}: unknown mesh axis {ax!r}; mesh has "
                    f"{tuple(mesh.shape)}")
            degree *= mesh.shape[ax]
        if shape[dim] % degree != 0:
            raise ShardingError(
                f"{name}: dim {dim} of shape {tuple(shape)} not divisible "
                f"by {_axes(axes)} degree {degree}")


def partition_to_sharding(partition, mesh: Optional[Mesh] = None
                          ) -> NamedSharding:
    mesh = mesh or get_mesh()
    return NamedSharding(mesh, tuple(partition) if partition else ())


def _drop_dead_axes(partition, mesh: Mesh):
    """Drop axes of degree 1 (or absent) so specs stay minimal."""
    if partition is None:
        return None
    out = []
    for axes in partition:
        if axes is None:
            out.append(None)
            continue
        kept = tuple(a for a in _axes(axes) if mesh.shape.get(a, 1) > 1)
        out.append(None if not kept else (kept[0] if len(kept) == 1
                                          else kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_shardings(layer: nn.Module, mesh: Optional[Mesh] = None,
                    fsdp_axis: Optional[str] = "fsdp",
                    fsdp_min_size: int = 2 ** 16
                    ) -> Dict[str, NamedSharding]:
    """Resolve every parameter's partition into a NamedSharding.

    If the mesh has a non-trivial ``fsdp_axis``, parameters of at least
    ``fsdp_min_size`` elements additionally get fsdp on their largest
    still-unsharded divisible dim (the last such dim among equals, as the
    JAX package's ``max`` over (size, dim) pairs picks it)."""
    mesh = mesh or get_mesh()
    out: Dict[str, NamedSharding] = {}
    fsdp_n = mesh.shape.get(fsdp_axis, 1) if fsdp_axis else 1
    for name, value in layer.named_parameters():
        part = _drop_dead_axes(partition_of(value), mesh)
        part = list(part) if part else []
        part += [None] * (value.ndim - len(part))
        if fsdp_n > 1 and value.numel() >= fsdp_min_size:
            cand = [(value.shape[d], d) for d in range(value.ndim)
                    if part[d] is None and value.shape[d] % fsdp_n == 0]
            if cand:
                _, d = max(cand)
                part[d] = fsdp_axis
        part = tuple(part)
        validate_partition(tuple(value.shape), part, mesh, name)
        out[name] = partition_to_sharding(part, mesh)
    return out


def _owner(root: nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return (root.get_submodule(mod_name) if mod_name else root), attr


def _distribute(t: torch.Tensor, sh: NamedSharding):
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = sh.placements
    t = t.detach()
    if sh.mesh.size == 1:
        # a world of one: no collective to make it
        return DTensor.from_local(t, sh.mesh.device_mesh, placements,
                                  run_check=False)
    # the source rank's values everywhere (the JAX device_put of one
    # controller's array)
    return distribute_tensor(t.to(sh.mesh.device), sh.mesh.device_mesh,
                             placements)


def _chunk_of(bounds, dim: int, n: int, c: int) -> None:
    """Narrow ``bounds[dim]`` ([lo, hi]) to ``torch.chunk(n)``'s piece
    ``c`` of it."""
    lo, hi = bounds[dim]
    step = -(-(hi - lo) // n)
    bounds[dim] = [min(lo + c * step, hi), min(lo + (c + 1) * step, hi)]


def buffer_index(shape, partition, mesh: Mesh) -> Tuple[slice, ...]:
    """The index of this rank's shard of a buffer of the full ``shape``
    cut by ``partition`` (axes split a dim first axis major), for any
    array: a tensor, or a numpy view of a checkpoint read only there."""
    bounds = [[0, int(n)] for n in shape]
    for dim, axes in enumerate(partition or ()):
        for a in _axes(axes) if axes is not None else ():
            n = mesh.shape.get(a, 1)
            if n > 1:
                _chunk_of(bounds, dim, n, mesh.coordinate(a))
    return tuple(slice(lo, hi) for lo, hi in bounds)


def _buffer_shard(t: torch.Tensor, partition, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the full buffer ``t`` (every rank holds the
    same values: the same seed or checkpoint), as a tensor of its own so
    the full one can be freed."""
    return t[buffer_index(t.shape, partition, mesh)].clone()


def shard_layer(layer: nn.Module, mesh: Optional[Mesh] = None,
                **kw) -> Dict[str, NamedSharding]:
    """Replace every parameter of ``layer`` by a DTensor parameter
    placed by :func:`param_shardings` (its partition metadata kept), cut
    every buffer a module lists in ``buffer_partitions()`` to this
    rank's shard, and install the forward pre-hook that materializes the
    compute tensors. Returns the sharding dict.

    Each parameter's full tensor is dropped once its shard is made, so
    loading a checkpoint into a model and then sharding it holds at most
    the full model and one parameter's shard a rank (a model built in
    :func:`sharded_build`: its shards, its embedding and head whole, and
    one decoder layer whole while it is drawn). Parameters already
    sharded there keep their shards; they must have the placements these
    arguments give."""
    mesh = mesh or get_mesh()
    shardings = param_shardings(layer, mesh, **kw)
    _shard_tensors(layer, mesh, shardings)
    old = getattr(layer, "_sharding_hook", None)
    if old is not None:
        old.remove()
    layer._sharding_hook = layer.register_forward_pre_hook(_materialize_hook)
    layer._shardings = shardings
    return shardings


def _shard_tensors(layer: nn.Module, mesh: Mesh, shardings) -> None:
    """Replace ``layer``'s parameters by DTensors placed by
    ``shardings`` and cut its ``buffer_partitions()`` buffers."""
    for name, p in list(layer.named_parameters()):
        if is_sharded(p):
            if tuple(p.placements) != tuple(shardings[name].placements):
                raise ShardingError(
                    f"{name}: sharded as {tuple(p.placements)} when built, "
                    f"{tuple(shardings[name].placements)} now")
            continue
        owner, attr = _owner(layer, name)
        new = nn.Parameter(_distribute(p.data, shardings[name]),
                           requires_grad=p.requires_grad)
        if partition_of(p) is not None:
            new.partition = partition_of(p)
        owner._parameters[attr] = new
    for mod in layer.modules():
        parts = getattr(mod, "buffer_partitions", None)
        if parts is None:
            continue
        for attr, part in parts().items():
            buf = mod._buffers.get(attr)
            if buf is None or getattr(mod, "_buffers_sharded", False):
                continue
            validate_partition(tuple(buf.shape), _drop_dead_axes(part, mesh),
                               mesh, attr)
            mod._buffers[attr] = _buffer_shard(buf, part, mesh)
        mod._buffers_sharded = True


# the open sharded_build contexts' (mesh, param_shardings arguments)
_BUILDS = []


@contextlib.contextmanager
def sharded_build(mesh: Optional[Mesh] = None, **kw):
    """Build a model so that no rank holds it whole: inside, a model's
    constructor cuts each decoder layer to this rank's shards as soon as
    its weights are drawn (:func:`shard_built`). Every rank draws the
    same values from the same seeded generator, so the model is the one
    that :func:`shard_layer` makes of the whole built model. Build on
    the mesh's device, then call :func:`shard_layer` on the model with
    the same ``kw`` (it cuts the embedding, the head and whatever the
    constructor did not). At its peak a rank holds its shards, one
    decoder layer whole, and the embedding and head whole."""
    _BUILDS.append((mesh or get_mesh(), kw))
    try:
        yield
    finally:
        _BUILDS.pop()


def open_build():
    """The innermost open :func:`sharded_build`'s (mesh, ``kw``), or
    None."""
    return _BUILDS[-1] if _BUILDS else None


def shard_built(layer: nn.Module) -> nn.Module:
    """Inside :func:`sharded_build`, cut ``layer``'s parameters and
    buffers to this rank's shards; elsewhere return it as it is. Model
    constructors call it on each decoder layer they draw."""
    if _BUILDS:
        mesh, kw = _BUILDS[-1]
        _shard_tensors(layer, mesh, param_shardings(layer, mesh, **kw))
    return layer


def _materialize_hook(module, args):
    materialize(module)      # returns None: the call's arguments stay


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The local tensor of a DTensor (an alias of its storage), else
    ``t``."""
    return t._local_tensor if is_sharded(t) else t


# the axes whose shards a layer computes on as they are: tp (the tp
# layers' collectives) and ep (each rank multiplies its own experts)
LOCAL_AXES = ("tp", "ep")


def _compute_placements(p):
    """(placements of the compute tensor, placements of its gradient):
    tp and ep shards stay, other axes replicate; the gradient is a
    partial sum over the live batch axes."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = p.device_mesh
    names = mesh.mesh_dim_names
    compute, grad = [], []
    for a, pl, n in zip(names, p.placements, mesh.mesh.shape):
        keep = pl if a in LOCAL_AXES else Replicate()
        compute.append(keep)
        grad.append(Partial() if a in GRAD_SUM_AXES and n > 1 else keep)
    return compute, grad


def materialize(root: nn.Module) -> Dict[str, torch.Tensor]:
    """Make every DTensor parameter's compute tensor and install it as
    an instance attribute of its module (shadowing the parameter for
    attribute reads; ``named_parameters`` and ``state_dict`` still see
    the DTensors). Returns {name: compute tensor}."""
    out = {}
    for name, p in root.named_parameters():
        if not is_sharded(p):
            continue
        compute, grad = _compute_placements(p)
        out[name] = p.redistribute(p.device_mesh, compute).to_local(
            grad_placements=grad)
    bind(root, out)
    return out


@torch.no_grad()
def bind_static(root: nn.Module) -> Dict[str, torch.Tensor]:
    """Make every DTensor parameter's compute tensor once, bind it (as
    :func:`materialize` does) and remove the forward pre-hook of
    :func:`shard_layer`: the serving path, whose weights do not change,
    so a captured step or tick replays no redistribute. A tp or ep shard
    is bound as the parameter's local tensor itself (same storage);
    other axes are gathered once. Call it after :func:`shard_layer` and
    after anything that replaces parameters (a cast, quantization,
    fusion: those passes re-bind a bound model themselves), before any
    capture. :func:`release` would undo it. Returns {name: tensor}."""
    hook = getattr(root, "_sharding_hook", None)
    if hook is not None:
        hook.remove()
        root._sharding_hook = None
    out = {}
    for name, p in root.named_parameters():
        if not is_sharded(p):
            continue
        compute, _ = _compute_placements(p)
        if list(compute) == list(p.placements):
            out[name] = p._local_tensor
        else:
            out[name] = p.redistribute(p.device_mesh, compute).to_local()
    bind(root, out)
    root._static_bound = True
    return out


def is_static_bound(root: nn.Module) -> bool:
    """Whether :func:`bind_static` bound ``root``'s compute tensors."""
    return getattr(root, "_static_bound", False)


def require_static(model: nn.Module, where: str) -> None:
    """``ValueError`` when ``model`` is sharded with the per-forward
    pre-hook still on: a serving entry point captures its programs over
    tensors bound once (:func:`bind_static`)."""
    if getattr(model, "_sharding_hook", None) is not None:
        raise ValueError(
            f"{where} serves a sharded model after "
            f"parallel.sharding.bind_static(model): its weights are "
            f"bound once, before any capture")


def bind(root: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Install ``tensors`` ({parameter name: tensor}) as instance
    attributes of their modules: a module's code then reads them in
    place of its parameters until :func:`release`."""
    for name, t in tensors.items():
        owner, attr = _owner(root, name)
        owner.__dict__[attr] = t


def release(root: nn.Module) -> None:
    """Drop the tensors :func:`materialize` and :func:`bind` installed
    (compute tensors hold gathered fsdp shards and the last step's
    graph)."""
    for name, _ in root.named_parameters():
        owner, attr = _owner(root, name)
        owner.__dict__.pop(attr, None)


def map_local(t, fn):
    """``fn`` applied to a DTensor's local tensor, rewrapped with its
    placements (or to ``t`` itself)."""
    if not is_sharded(t):
        return fn(t)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(fn(t._local_tensor), t.device_mesh,
                              t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def full_tensor(t):
    """The logical full tensor of a DTensor (a collective over its
    sharded axes), else ``t``."""
    return t.full_tensor() if is_sharded(t) else t


def local_index(like) -> Tuple[slice, ...]:
    """The index of this rank's shard of DTensor ``like``'s logical
    tensor (the whole of a plain tensor), for any array of that shape: a
    tensor, or a numpy view of a checkpoint read only there. No
    collective."""
    bounds = [[0, int(n)] for n in like.shape]
    if is_sharded(like):
        from torch.distributed.tensor import Shard
        mesh = like.device_mesh
        for pl, n, c in zip(like.placements, mesh.mesh.shape,
                            mesh.get_coordinate()):
            if isinstance(pl, Shard) and n > 1:
                _chunk_of(bounds, pl.dim, int(n), c)
    return tuple(slice(lo, hi) for lo, hi in bounds)


def local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the logical tensor ``full`` in ``like``'s
    placements (``like`` a DTensor; else ``full``). No collective."""
    if not is_sharded(like):
        return full
    return full[local_index(like)]


def _shard_axes(t) -> Tuple[str, ...]:
    """The live mesh axes that split DTensor ``t`` (empty for a plain
    tensor or a replicated DTensor)."""
    if not is_sharded(t):
        return ()
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    return tuple(a for a, pl, n in zip(mesh.mesh_dim_names, t.placements,
                                       mesh.mesh.shape)
                 if isinstance(pl, Shard) and n > 1)


def full_norms(tensors):
    """The fp32 2-norm of each logical tensor, as 0-dim tensors: a
    replicated or plain tensor's from its local values, a sharded one's
    from its shards' squared norms summed over the axes that split it
    (one all-reduce per distinct set of axes), so every logical element
    counts once and no replica twice."""
    from ..distributed.collective import _reduce_
    tensors = list(tensors)
    norms = [torch.linalg.vector_norm(local(t), dtype=torch.float32)
             for t in tensors]
    groups: Dict[Tuple[str, ...], list] = {}
    for i, t in enumerate(tensors):
        axes = _shard_axes(t)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        sq = torch.stack([norms[i] for i in idx]) ** 2
        sq = _reduce_(sq, "sum", axes).sqrt()
        for j, i in enumerate(idx):
            norms[i] = sq[j]
    return norms


def constraint(x, *spec):
    """The counterpart of ``lax.with_sharding_constraint`` on an
    activation. Activations here are local tensors already laid out as
    the spec asks (the model runs on its rank's batch rows and sequence
    block, and the tp layers keep their own layout), so this is the
    identity; for a DTensor it redistributes to the spec, dropping axes
    that do not divide their dim, as the JAX hint does."""
    if not has_mesh() or not is_sharded(x):
        return x
    mesh = get_mesh()
    cleaned = _drop_dead_axes(tuple(spec), mesh)
    if not cleaned:
        return x
    fitted = []
    for dim, axes in enumerate(cleaned):
        degree = 1
        for a in _axes(axes) if axes is not None else ():
            degree *= mesh.shape.get(a, 1)
        fitted.append(axes if axes is not None
                      and x.shape[dim] % degree == 0 else None)
    return x.redistribute(x.device_mesh,
                          NamedSharding(mesh, tuple(fitted)).placements)


def tree_shardings(tree, like: Dict[str, NamedSharding], default=None):
    """Map a flat {name: tensor} tree to its shardings, falling back to
    ``default`` (replicated if None) for names absent from ``like``."""
    default = default or NamedSharding(get_mesh(), ())
    return {k: like.get(k, default) for k in tree}
