"""Collectives over named mesh axes (counterpart of
``paddle_tpu/distributed/collective.py``; reference:
python/paddle/distributed/communication/*.py).

In the JAX package these are ``lax`` collectives inside ``shard_map``,
keyed by mesh axis name, and ``jax.grad`` differentiates through them.
Here every rank runs the same program on its local tensor (the
counterpart of a ``shard_map`` body), and each function runs over the
process group of the named axis (or axes, one after the other) of the
global mesh. Over an axis of degree 1 each is the identity (no group is
touched), so code written for a mesh runs unchanged in a world of one.

The in-region functions carry gradients as their ``lax`` counterparts'
transposes do: ``all_reduce`` (sum) <-> ``all_reduce``, ``all_gather``
<-> ``reduce_scatter``, ``all_to_all`` back with ``split_axis`` and
``concat_axis`` swapped, ``ppermute`` back along the inverse
permutation (``torch.distributed.nn.functional`` has no ppermute). The
permutation's sends and receives go out as one ``batch_isend_irecv``, so
a ring cannot deadlock on the order of its point-to-point calls.

The ``eager_*`` forms take a rank's shard outside any region, as the JAX
package's ``shard_map`` facades do, and retry a transient failure
(``CollectiveError``, the injected ``collective_fail`` fault, or a
backend error) up to ``PADDLE_TPU_COLLECTIVE_RETRIES`` attempts in all.
They synchronize the stream, so a CUDA graph cannot hold one: inside a
capture they raise, and the captured decode steps and ticks reach only
the in-region functions (the tp layers' gather and sum).
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils import faults
from ..utils.faults import retry_with_backoff
from .env import axis_coordinate as axis_index
from .env import axis_degree as axis_size
from .env import get_mesh, has_mesh

AxisName = Union[str, Sequence[str]]


class CollectiveError(RuntimeError):
    """A transient collective failure (a flaky link, a preempted peer, or
    the injected ``collective_fail`` fault). Retryable: the eager
    wrappers re-run the collective under retry_with_backoff."""


def _collective_retries() -> int:
    """Total attempts per eager collective (so '3' = 2 actual retries);
    0/negative clamps to 1 = run once, no retry."""
    return max(1, int(os.environ.get("PADDLE_TPU_COLLECTIVE_RETRIES", "3")))


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN}


def _live(group: AxisName) -> Tuple[str, ...]:
    """The axes of ``group`` whose degree exceeds 1 on the mesh."""
    if not has_mesh():
        return ()
    shape = get_mesh().shape
    axes = (group,) if isinstance(group, str) else tuple(group)
    return tuple(a for a in axes if shape.get(a, 1) > 1)


# ------------------------------------------------------ raw (no autograd)
def _reduce_(t: torch.Tensor, op: str, group: AxisName) -> torch.Tensor:
    """In place over each live axis of ``group``."""
    axes = _live(group)
    if not axes:
        return t
    mesh = get_mesh()
    if op in _DIST_OPS:
        for a in axes:
            dist.all_reduce(t, op=_DIST_OPS[op], group=mesh.group(a))
        return t
    if op == ReduceOp.AVG:
        for a in axes:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(a))
        return t.div_(axis_size(axes))
    raise ValueError(op)


def _gather(t: torch.Tensor, group: AxisName, axis: int) -> torch.Tensor:
    axes = _live(group)
    mesh = get_mesh() if axes else None
    # the last axis is innermost: gather it first so the result is
    # ordered by the flattened index, first axis major
    for a in reversed(axes):
        n = mesh.shape[a]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group(a))
        t = torch.cat(parts, dim=axis)
    return t


def _scatter_sum(t: torch.Tensor, group: AxisName, axis: int) -> torch.Tensor:
    axes = _live(group)
    mesh = get_mesh() if axes else None
    for a in axes:
        n = mesh.shape[a]
        if t.shape[axis] % n:
            raise ValueError(f"dim {axis} of {tuple(t.shape)} does not "
                             f"split over {a!r} ({n})")
        parts = [c.contiguous() for c in t.chunk(n, dim=axis)]
        out = torch.empty_like(parts[0])
        if dist.get_backend(mesh.group(a)) == "gloo":
            # gloo's reduce_scatter takes tensor lists only on some builds;
            # the sum then this rank's chunk is the same function
            full = t.contiguous().clone()
            dist.all_reduce(full, group=mesh.group(a))
            out = full.chunk(n, dim=axis)[mesh.coordinate(a)].contiguous()
        else:
            dist.reduce_scatter(out, parts, group=mesh.group(a))
        t = out
    return t


def _a2a(t: torch.Tensor, group: AxisName, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    axes = _live(group)
    if len(axes) > 1:
        raise ValueError("all_to_all over more than one live axis")
    if not axes:
        return t
    mesh = get_mesh()
    n = mesh.shape[axes[0]]
    if t.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(t.shape)} does not "
                         f"split over {axes[0]!r} ({n})")
    ins = [c.contiguous() for c in t.chunk(n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=mesh.group(axes[0]))
    return torch.cat(outs, dim=concat_axis)


def _permute(ts: Sequence[torch.Tensor], perm, group: AxisName):
    """Send each of ``ts`` from index i to index j for each (i, j) of
    ``perm`` along one axis; an index no pair sends to receives zeros."""
    axes = _live(group)
    if len(axes) > 1:
        raise ValueError("ppermute over more than one live axis")
    if not axes:
        out = [t.clone() if (0, 0) in perm else torch.zeros_like(t)
               for t in ts]
        return out
    mesh = get_mesh()
    a = axes[0]
    ranks = mesh.ranks(a)
    me = mesh.coordinate(a)
    g = mesh.group(a)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    outs = [torch.zeros_like(t) for t in ts]
    ops = []
    for t, o in zip(ts, outs):
        for j in dst:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), ranks[j], g))
        for i in src:
            ops.append(dist.P2POp(dist.irecv, o, ranks[i], g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


# ------------------------------------------------ in-region (autograd)
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_(x.clone(), ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ReduceOp.SUM, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _scatter_sum(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, group, *xs):
        ctx.perm, ctx.group = perm, group
        return tuple(_permute(xs, perm, group))

    @staticmethod
    def backward(ctx, *gs):
        inverse = [(j, i) for i, j in ctx.perm]
        return (None, None) + tuple(_permute(gs, inverse, ctx.group))


def all_reduce(x, op: str = ReduceOp.SUM, group: AxisName = "dp"):
    """The reduction of every rank's ``x`` along ``group``. SUM and AVG
    carry gradients (their transpose is the same reduction of the
    cotangents, as ``lax.psum``'s); MAX, MIN and PROD do not."""
    if op == ReduceOp.SUM:
        return _AllReduceSum.apply(x, group)
    if op == ReduceOp.AVG:
        return _AllReduceSum.apply(x, group) / axis_size(group)
    if op == ReduceOp.PROD:
        with torch.no_grad():
            return torch.exp(_reduce_(torch.log(x), ReduceOp.SUM, group))
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        with torch.no_grad():
            return _reduce_(x.clone(), op, group)
    raise ValueError(op)


def all_gather(x, group: AxisName = "dp", axis: int = 0, tiled: bool = True):
    """Every rank's ``x`` concatenated along ``axis`` in index order
    (``tiled=False`` stacks them on a new leading ``axis``)."""
    if not tiled:
        return _AllGather.apply(x.unsqueeze(axis), group, axis)
    return _AllGather.apply(x, group, axis)


def reduce_scatter(x, group: AxisName = "dp", axis: int = 0):
    """The sum over ``group`` of ``x``, split along ``axis``: this rank's
    chunk (``lax.psum_scatter(..., tiled=True)``)."""
    return _ReduceScatter.apply(x, group, axis)


def all_to_all(x, group: AxisName = "ep", split_axis: int = 0,
               concat_axis: int = 0):
    """Split ``x`` along ``split_axis`` into one chunk per rank, send
    chunk j to rank j, and concatenate what arrives along
    ``concat_axis`` (``lax.all_to_all(..., tiled=True)``)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def ppermute(x, perm, group: AxisName):
    """``lax.ppermute``: for each (i, j) in ``perm``, index i's ``x``
    arrives at index j; an index no pair sends to gets zeros. ``x`` may
    be a tensor or a tuple of tensors (sent in one batch)."""
    perm = [(int(i), int(j)) for i, j in perm]
    if isinstance(x, (tuple, list)):
        return _PPermute.apply(perm, group, *x)
    return _PPermute.apply(perm, group, x)[0]


def broadcast(x, src: int = 0, group: AxisName = "dp"):
    """Index ``src``'s ``x`` on every rank of ``group``: the JAX package's
    mask-to-src then psum, whose transpose sends the summed cotangent to
    src alone."""
    keep = torch.tensor(axis_index(group) == src, device=x.device)
    return all_reduce(torch.where(keep, x, torch.zeros_like(x)),
                      ReduceOp.SUM, group)


# ------------------------------------------------------------ eager facades
def _eager(fn, x, group):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        # a facade retries and synchronizes the stream, which a capture
        # forbids: a captured program calls the in-region collectives
        raise RuntimeError(
            f"eager collective on axis {group!r} inside a CUDA graph "
            f"capture; captured programs call the in-region collectives")

    def attempt():
        # chaos: a transient link failure surfaces BEFORE the collective
        # runs; the retry below is the recovery contract for both the
        # injected and the real case
        if faults.inject("collective_fail", group=str(group)):
            raise CollectiveError(
                f"injected transient collective failure on axis {group!r}")
        with torch.no_grad():
            out = fn(x)
        if out.is_cuda:
            # synchronous, as the JAX facade's block_until_ready: a failure
            # surfaces inside the attempt
            torch.cuda.current_stream(out.device).synchronize()
        return out

    retryable = (CollectiveError, dist.DistBackendError)
    return retry_with_backoff(attempt, max_attempts=_collective_retries(),
                              base_delay=0.05, max_delay=2.0,
                              retryable=retryable)


def eager_all_reduce(x, op: str = ReduceOp.SUM, group: str = "dp"):
    """This rank's shard ``x`` reduced over ``group``: the result is the
    same on every rank of the group."""
    return _eager(lambda v: all_reduce(v, op, group), x, group)


def eager_all_gather(x, group: str = "dp"):
    """The shards of ``group`` concatenated along axis 0."""
    return _eager(lambda v: all_gather(v, group), x, group)


def eager_broadcast(x, src: int = 0, group: str = "dp"):
    """Index ``src``'s shard on every rank of ``group``."""
    return _eager(lambda v: broadcast(v, src, group), x, group)
