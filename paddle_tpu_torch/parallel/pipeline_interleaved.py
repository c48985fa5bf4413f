"""Interleaved 1F1B pipeline: virtual pipeline stages (counterpart of
``paddle_tpu/parallel/pipeline_interleaved.py``; reference:
fleet.meta_parallel.PipelineParallel's ``virtual_pp_degree`` schedule,
Megatron-LM's interleaved 1F1B).

Each pp rank holds ``v`` model chunks instead of one stage: global stage
``g`` (of S = v * pp) lives on rank ``g % pp`` as chunk ``g // pp``. A
microbatch visits every rank v times, and the bubble shrinks from
(pp - 1) stage units to (pp - 1) chunk units.

Consecutive global stages sit on consecutive ranks, so every hand-off
goes one rank downstream (activations) or upstream (cotangents), with
the wrap from the last rank to rank 0 between chunks. Who does what at
each tick comes from :func:`_build_schedule`, the JAX package's host
tables copied with their collision asserts; the tick loop is
``pipeline._run_schedule``, which the plain 1F1B step runs with v = 1
(those tables are exactly its schedule).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .pipeline import _check_stages, _run_schedule


def _build_schedule(pp: int, v: int, M: int):
    """Static (tick, device) -> (m, chunk, live) tables for fwd and bwd.

    Returns (fwd_m, fwd_c, fwd_live, bwd_m, bwd_c, bwd_live) as [T, pp]
    int32/bool arrays, plus K, the max activations in flight per chunk.
    """
    S = v * pp

    def fwd_tick(m, g):
        return (m // pp) * S + (m % pp) + g

    def bwd_tick(m, g):
        return S + (m // pp) * S + (m % pp) + (S - 1 - g)

    T = bwd_tick(M - 1, 0) + 1
    shape = (T, pp)
    fwd_m = np.zeros(shape, np.int32)
    fwd_c = np.zeros(shape, np.int32)
    fwd_live = np.zeros(shape, bool)
    bwd_m = np.zeros(shape, np.int32)
    bwd_c = np.zeros(shape, np.int32)
    bwd_live = np.zeros(shape, bool)
    for m in range(M):
        for g in range(S):
            d, c = g % pp, g // pp
            t = fwd_tick(m, g)
            assert not fwd_live[t, d], "fwd schedule collision"
            fwd_m[t, d], fwd_c[t, d], fwd_live[t, d] = m, c, True
            t = bwd_tick(m, g)
            assert not bwd_live[t, d], "bwd schedule collision"
            bwd_m[t, d], bwd_c[t, d], bwd_live[t, d] = m, c, True

    # exact ring size: max, over (device, chunk), of activations whose
    # forward has run but whose backward has not
    K = 1
    for g in range(S):
        events = [(fwd_tick(m, g), 1) for m in range(M)] + \
                 [(bwd_tick(m, g), -1) for m in range(M)]
        live = peak = 0
        for _, delta in sorted(events):
            live += delta
            peak = max(peak, live)
        K = max(K, peak)
    return (fwd_m, fwd_c, fwd_live, bwd_m, bwd_c, bwd_live), T, K


def interleaved_pipeline_value_and_grad(
        embed_fn: Callable, chunk_fn: Callable, head_loss_fn: Callable,
        n_stages: int, v: int, axis_name: str = "pp", mesh=None):
    """Interleaved-1F1B analogue of ``pipeline_value_and_grad``.

    Args:
      embed_fn(embed_params, tokens[mb, s]) -> x [mb, s, h]
      chunk_fn(chunk_params, x) -> y (same shape; one chunk = L/(v*pp)
        decoder layers), or (y, aux) for MoE chunks
      head_loss_fn(head_params, y, labels[mb, s]) -> scalar mean loss
      n_stages: pp degree; v: virtual chunks per rank.

    Returns fn(params, tokens, labels) -> (loss, grads) with params =
    {"embed": {...}, "stages": [v dicts: this rank's chunks, chunk c
    being global stage c * pp + rank], "head": {...}}; tokens/labels
    [n_micro, micro_b, seq]. grads as ``pipeline_value_and_grad``'s.
    """

    def run(params, tokens, labels):
        _check_stages(n_stages, axis_name, mesh)
        if len(params["stages"]) != v:
            raise ValueError(f"{len(params['stages'])} chunks given for "
                             f"v = {v}")
        tables, T, _ = _build_schedule(n_stages, v, tokens.shape[0])
        return _run_schedule(embed_fn, chunk_fn, head_loss_fn, n_stages,
                             v, axis_name, tables, T, params, tokens,
                             labels)

    return run
