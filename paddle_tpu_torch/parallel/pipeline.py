"""Pipeline parallelism (counterpart of ``paddle_tpu/parallel/pipeline.py``;
reference: fleet.meta_parallel.PipelineLayer + pp_utils: the 1F1B
schedule, p2p send/recv between stage ranks, gradient accumulation over
microbatches).

The JAX package runs the pipeline as one SPMD program inside
``shard_map`` manual over ``pp``: stage weights stacked on a leading
[pp] dim, a ``lax.scan`` over the ticks, ``lax.ppermute`` hand-offs.
Here every pp rank is a process that runs its own stage, and the ticks
are a Python loop over the same schedule:

- :func:`spmd_pipeline` / :func:`pipeline_apply`: the GPipe forward
  (at tick t stage s computes microbatch t - s), through the
  differentiable ``collective.ppermute``; the last stage's outputs reach
  every rank of the axis through an all-reduce.
- :func:`pipeline_value_and_grad`: the 1F1B train step. Microbatch m
  runs forward on stage s at tick ``m + s`` and backward at tick
  ``2*pp - 1 + m - s``, ``T = 2*pp + M - 1`` ticks in all. A forward
  keeps no graph, only the stage's input; the backward recomputes the
  stage forward from it and takes ``torch.autograd.grad`` of the
  recompute (the JAX ``jax.vjp`` remat), so stage s holds at most
  ``2*pp - 1 - 2*s`` inputs, whatever M is. The last stage's forward
  only keeps its input: its backward, one tick later, recomputes it
  under the loss head anyway. The loss head runs only on the last
  stage, the embedding's backward only on stage 0, and an MoE stage
  seeds its own aux cotangent at its backward tick. Each tick's
  hand-offs (activations downstream, cotangents upstream) are one
  ``batch_isend_irecv`` of the live pairs only; the JAX ring ships zeros
  from the idle ones.

The other axes (dp, fsdp, tp, ep) run inside the stage functions, in
their layers' collectives, as GSPMD's auto axes do inside the JAX body:
every rank of a stage's dp/tp/ep group is at the same tick of the same
schedule. With ``pp`` of degree 1 the hand-offs stay on the rank.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..distributed import collective as C
from ..distributed.collective import axis_index, axis_size
from ..distributed.env import get_mesh, has_mesh


def spmd_pipeline(stage_fn: Callable, axis_name: str = "pp"):
    """Wrap ``stage_fn(stage_params, x) -> y`` into a pipelined
    ``fn(stage_params, microbatches) -> outputs`` run by every rank of
    ``axis_name`` with its own stage's params and the same microbatches
    [n_micro, mb, ...] (the JAX body sees its stage's slice of the
    stacked params). ``y`` has the microbatches' shape and dtype (a
    transformer block). Differentiable: the hand-offs are
    ``collective.ppermute`` and the broadcast an all-reduce."""

    def pipelined(stage_params, microbatches):
        n_stages = axis_size(axis_name)
        stage = axis_index(axis_name)
        n_micro = microbatches.shape[0]
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        zeros = torch.zeros_like(microbatches[0])
        recv = zeros
        outputs = [zeros] * n_micro
        for t in range(n_micro + n_stages - 1):
            # stage 0 pulls microbatch t from the feed; the others use
            # what their upstream neighbour sent last tick
            m = t - stage
            y = zeros
            if 0 <= m < n_micro:
                x_in = microbatches[m] if stage == 0 else recv
                y = stage_fn(stage_params, x_in).to(zeros.dtype)
                if stage == n_stages - 1:
                    outputs[m] = y
            recv = C.ppermute(y, perm, axis_name)
        # only the last stage wrote outputs: the sum hands them to all
        return C.all_reduce(torch.stack(outputs), C.ReduceOp.SUM,
                            axis_name)

    return pipelined


def pipeline_apply(stage_fn: Callable, stacked_params, microbatches,
                   axis_name: str = "pp", mesh=None):
    """Run the pipelined computation over the global mesh.

    stacked_params: {name: tensor [n_stages, ...]} (logically whole on
    every rank, as the JAX array is; each rank takes its stage's slice).
    microbatches: [n_micro, micro_batch, ...], the same on every rank.
    Requires stage_fn's output shape == its input shape."""
    if mesh is not None or has_mesh():
        validate_pp_mesh(mesh or get_mesh(), axis_name)
    stage = axis_index(axis_name)
    mine = _map(lambda p: p[stage], stacked_params)
    return spmd_pipeline(stage_fn, axis_name)(mine, microbatches)


def stack_stage_params(per_stage_params: list):
    """[{name: tensor}, ...] per stage -> {name: tensor[n_stages, ...]}
    (nested dicts map leaf by leaf)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(per_stage_params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------- 1F1B
def pipeline_value_and_grad(embed_fn: Callable, stage_fn: Callable,
                            head_loss_fn: Callable, n_stages: int,
                            axis_name: str = "pp", dp_axis: str = "dp",
                            mesh=None):
    """True 1F1B pipeline train step (see the module docstring).

    Args:
      embed_fn(embed_params, tokens[mb, s]) -> x [mb, s, h]
      stage_fn(stage_params, x) -> y (same shape; a group of decoder
        layers), or (y, aux) for MoE stages
      head_loss_fn(head_params, y, labels[mb, s]) -> scalar mean loss
      n_stages: the pp degree.

    Returns fn(params, tokens, labels) -> (loss, grads): params =
    {"embed": {...}, "stages": {...this rank's stage...}, "head": {...}}
    dicts of tensors; tokens/labels [n_micro, micro_b, seq]. grads has
    the same structure: this rank's stage's, and the embedding's and
    head's summed over pp (the JAX psum); loss is the mean over
    microbatches of the head loss plus every stage's aux, summed over
    pp. ``dp_axis`` is accepted for the JAX signature: the reductions
    over the data axes belong to the caller, as they are GSPMD's there.
    """

    def run(params, tokens, labels):
        from .pipeline_interleaved import _build_schedule
        _check_stages(n_stages, axis_name, mesh)
        tables, T, _ = _build_schedule(n_stages, 1, tokens.shape[0])
        loss, grads = _run_schedule(
            embed_fn, stage_fn, head_loss_fn, n_stages, 1, axis_name,
            tables, T, dict(params, stages=[params["stages"]]), tokens,
            labels)
        grads["stages"] = grads["stages"][0]
        return loss, grads

    return run


def validate_pp_mesh(mesh, axis_name: str = "pp"):
    """The schedule runs over ``axis_name``; every other axis runs inside
    the stage functions. A mesh without that axis is refused."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.shape}")


def pipeline_grads(model, vag: Callable, tokens, params=None):
    """One pipeline step of ``model`` before its update: ``vag`` (from
    ``model.pipeline_functional``) over the model's compute tensors and
    ``tokens`` [n_micro, b, s], then, on a sharded model, the compute
    tensors' gradients taken back onto the DTensor parameters in one
    backward (which sums them over the data axes). Returns the loss,
    summed over the data axes, and the whole gradient of each of
    ``params`` (default: every named parameter)."""
    from . import sharding
    if params is None:
        params = dict(model.named_parameters())
    compute = sharding.materialize(model)
    loss, g = vag({k: compute.get(k, p) for k, p in params.items()},
                  tokens)
    names = list(compute)
    if names:
        back = torch.autograd.grad([compute[k] for k in names],
                                   [params[k] for k in names],
                                   [g[k] for k in names])
        g.update(zip(names, back))
    sharding.release(model)
    loss = C._reduce_(loss, "sum", sharding.GRAD_SUM_AXES)
    return loss, {k: g[k] for k in params}


def _check_stages(n_stages: int, axis_name: str, mesh):
    if mesh is not None or has_mesh():
        mesh = mesh or get_mesh()
        validate_pp_mesh(mesh, axis_name)
        degree = mesh.shape[axis_name]
    else:
        degree = 1
    if degree != n_stages:
        raise ValueError(f"{n_stages} pipeline stages on a mesh whose "
                         f"{axis_name!r} degree is {degree}")


def _add(acc: dict, names, grads):
    for k, g in zip(names, grads):
        if g is not None:
            acc[k] = g if acc.get(k) is None else acc[k] + g.to(acc[k].dtype)


def _exchange(axis_name, sends, recvs, like):
    """One batch of point-to-point hand-offs along ``axis_name``:
    ``sends`` [(tensor, index, tag)], ``recvs`` [(index, tag)]; returns
    the received tensors (``like``'s shape and dtype) in ``recvs``'
    order. Both ends post their forward hand-off before the backward
    one, and the tags tell them apart on a shared pair."""
    if not sends and not recvs:
        return []
    mesh = get_mesh()
    ranks, group = mesh.ranks(axis_name), mesh.group(axis_name)
    outs = [torch.empty_like(like) for _ in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[j], group, tag)
           for t, j, tag in sends]
    ops += [dist.P2POp(dist.irecv, o, ranks[i], group, tag)
            for o, (i, tag) in zip(outs, recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _run_schedule(embed_fn, chunk_fn, head_loss_fn, pp, v, axis_name,
                  tables, T, params, tokens, labels):
    """The tick loop shared by the 1F1B (v = 1) and interleaved
    schedules: ``tables`` [T, pp] of (forward microbatch, chunk, live,
    backward microbatch, chunk, live) from ``_build_schedule``; global
    stage g = chunk * pp + rank lives on this rank as chunk g // pp.
    ``params["stages"]`` is this rank's list of v chunk dicts."""
    fm, fc, fl, bm, bc, bl = tables
    d = axis_index(axis_name)
    S = v * pp
    M = tokens.shape[0]
    chunks, eparams, hparams = params["stages"], params["embed"], \
        params["head"]
    with torch.no_grad():
        like = embed_fn(eparams, tokens[0])     # the hand-offs' shape
    g_st = [dict.fromkeys(c) for c in chunks]
    g_e, g_h = dict.fromkeys(eparams), dict.fromkeys(hparams)
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    saved = {}          # (chunk, microbatch) -> the stage's input
    recv_f = recv_b = None

    for t in range(T):
        # ---------------------------------------------------- forward
        y = None
        if fl[t, d]:
            m, c = int(fm[t, d]), int(fc[t, d])
            g = c * pp + d
            # stage 0 keeps its tokens: its backward reruns the embedding
            saved[(c, m)] = tokens[m] if g == 0 else recv_f
            if g < S - 1:
                with torch.no_grad():
                    x = embed_fn(eparams, tokens[m]) if g == 0 else recv_f
                    y = chunk_fn(chunks[c], x)
                    if isinstance(y, (tuple, list)):
                        y = y[0]
        # --------------------------------------------------- backward
        dx = None
        if bl[t, d]:
            m, c = int(bm[t, d]), int(bc[t, d])
            g = c * pp + d
            saved_x = saved.pop((c, m))
            with torch.enable_grad():
                if g == 0:
                    x = embed_fn(eparams, saved_x)
                else:
                    x = saved_x.detach().requires_grad_(True)
                out = chunk_fn(chunks[c], x)
                aux = None
                if isinstance(out, (tuple, list)):
                    out, aux = out
                if g == S - 1:
                    loss_m = head_loss_fn(hparams, out, labels[m])
                    roots, cots = [loss_m], [torch.ones_like(loss_m)]
                    loss += loss_m.detach().float()
                else:
                    roots, cots = [out], [recv_b]
                if aux is not None:
                    roots.append(aux)
                    cots.append(torch.ones_like(aux))
                    loss += aux.detach().float()
                ks = list(chunks[c])
                kh = list(hparams) if g == S - 1 else []
                ke = list(eparams) if g == 0 else []
                wrt = [chunks[c][k] for k in ks] + \
                    [hparams[k] for k in kh] + [eparams[k] for k in ke]
                if g > 0:
                    wrt.append(x)
                grads = torch.autograd.grad(roots, wrt, cots,
                                            allow_unused=True)
            n1, n2 = len(ks), len(ks) + len(kh)
            _add(g_st[c], ks, grads[:n1])
            _add(g_h, kh, grads[n1:n2])
            _add(g_e, ke, grads[n2:n2 + len(ke)])
            if g > 0:
                dx = grads[-1]
            del grads, roots, out, x
        # --------------------------------------------------- hand-off
        # what arrives next tick: an activation if the next forward is
        # not global stage 0, a cotangent if the next backward is not
        # the last stage
        nxt = t + 1 < T
        want_f = nxt and fl[t + 1, d] and fc[t + 1, d] * pp + d > 0
        want_b = nxt and bl[t + 1, d] and bc[t + 1, d] * pp + d < S - 1
        if pp == 1:
            recv_f = y if want_f else None
            recv_b = dx if want_b else None
            continue
        sends, recvs = [], []
        if y is not None:
            sends.append((y, (d + 1) % pp, 0))
        if dx is not None:
            sends.append((dx.to(like.dtype), (d - 1) % pp, 1))
        if want_f:
            recvs.append(((d - 1) % pp, 0))
        if want_b:
            recvs.append(((d + 1) % pp, 1))
        got = _exchange(axis_name, sends, recvs, like)
        recv_f = got.pop(0) if want_f else None
        recv_b = got.pop(0) if want_b else None

    def final(acc, like_params, reduce):
        out = {}
        for k, p in like_params.items():
            g = acc[k] if acc[k] is not None else torch.zeros_like(p)
            if reduce:
                g = C._reduce_(g.clone(), C.ReduceOp.SUM, axis_name)
            out[k] = g / M
        return out

    grads = {"stages": [final(a, c, False) for a, c in zip(g_st, chunks)],
             "head": final(g_h, hparams, True),
             "embed": final(g_e, eparams, True)}
    loss = C._reduce_(loss, C.ReduceOp.SUM, axis_name) / M
    return loss, grads
