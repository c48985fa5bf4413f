"""Sequence/context parallel attention (counterpart of
``paddle_tpu/parallel/ring.py``; reference: fleet's sep/context-parallel
path in paddle/distributed/fleet/meta_parallel/, which shards the
sequence over ranks and exchanges KV with NCCL send/recv).

Each rank of the ``sp`` axis holds one sequence block of Q, K and V,
[b, s_local, h|kvh, d] (the counterpart of the JAX package's
``shard_map`` body over ``sp``):

- ``ring_attention``: K/V blocks (and packed-sequence ``segment_ids``)
  rotate around the ring with ``collective.ppermute`` while each rank
  accumulates its Q block's attention with an online softmax (running
  max and denominator in fp32), masked per block pair at global
  positions (block index * s_local + offset): causal, a sliding
  ``window``, segment equality.
- ``ulysses_attention``: ``all_to_all`` trades the sequence split for a
  head split, full-sequence attention runs on h/n heads, and a second
  ``all_to_all`` trades back; too few kv heads are repeated up to the
  degree first.
- ``ring_flash_attention``: ``flash_attention_with_lse`` (the kernels of
  rows 1-3 on a card) on the diagonal block and on every past block,
  merged by lse (:func:`lse_merge`); the masked variants go to
  ``ring_attention``. The JAX package's ``lax.cond(idx >= step)`` is a
  Python branch on the rank's fixed ``sp`` index.

Everything is differentiable through autograd: ppermute's backward is
the reverse rotation, all_to_all's the swapped one. Every rank rotates
the same number of times, and a block a causal rank skips is tied into
its output (``_Keep``: zero gradient), so each rotation's backward runs
on every rank and the ring's collectives match in both directions.
"""
from __future__ import annotations

import functools
import inspect
import math
from typing import Optional

import torch

from ..distributed import collective as C
from ..distributed.collective import axis_index, axis_size, ppermute

NEG_INF = -1e30


def _block_scores(q, k, scale):
    """q [b,sq,h,d], k [b,sk,kvh,d] -> scores [b,h,sq,sk] fp32, GQA-aware."""
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale


def _block_pv(p, v, h):
    kvh = v.shape[2]
    if kvh != h:
        v = v.repeat_interleave(h // kvh, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class _Keep(torch.autograd.Function):
    """``o`` unchanged, with ``deps`` tied into its graph at zero
    gradient: the rotation that made them runs its backward (a
    collective) on this rank too."""

    @staticmethod
    def forward(ctx, o, *deps):
        ctx.like = [(d.shape, d.dtype, d.device) for d in deps]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=dev)
                            for s, t, dev in ctx.like)


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None, segment_ids=None,
                   window: Optional[int] = None):
    """Blockwise ring attention over this rank's sequence block: q/k/v
    [b, s_local, h|kvh, d]; returns [b, s_local, h, d] (the local Q
    block's attention over the whole sequence). ``segment_ids`` [b,
    s_local] is the local block of the packed-sequence ids (attention
    only within equal ids); ``window`` (causal only) keeps the trailing
    ``window`` keys per query."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention narrows the causal band)")
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    perm = _ring_perm(n)
    has_seg = segment_ids is not None
    seg = segment_ids.to(torch.int32) if has_seg else None
    dev = q.device
    o = torch.zeros(b, s, h, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, s, dtype=torch.float32, device=dev)
    kc, vc, sc = k, v, seg
    for step in range(n):
        kv_idx = (idx - step) % n      # whose block this rank holds now
        scores = _block_scores(q, kc, scale)
        if causal or has_seg:
            keep = torch.ones(s, s, dtype=torch.bool, device=dev)
            if causal:
                qpos = idx * s + torch.arange(s, device=dev)[:, None]
                kpos = kv_idx * s + torch.arange(s, device=dev)[None, :]
                keep = kpos <= qpos
                if window is not None:
                    keep = keep & (qpos - kpos < window)
            keep = keep[None, None]
            if has_seg:
                keep = keep & (seg[:, None, :, None] == sc[:, None, None, :])
            scores = torch.where(keep, scores,
                                 torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = _block_pv(p.to(q.dtype), vc, h)
        o = o * alpha.transpose(1, 2)[..., None] + pv.float()
        m = m_new
        if step < n - 1:
            kc, vc = ppermute((kc, vc), perm, axis_name)
            if has_seg:
                sc = C._permute([sc], perm, axis_name)[0]
    denom = l.transpose(1, 2)[..., None]
    return (o / denom.clamp_min(1e-20)).to(q.dtype)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None, attn_fn=None,
                      segment_ids=None, window: Optional[int] = None):
    """DeepSpeed-Ulysses sequence parallelism (reference: sep_degree
    path): q/k/v [b, s_local, h|kvh, d] -> [b, s_local, h, d]; requires
    num_heads % degree == 0. ``segment_ids`` is the local [b, s_local]
    block (gathered to the whole sequence, which every rank sees after
    the swap); ``window`` narrows the causal band. A custom ``attn_fn``
    must take (q, k, v, *, causal, attn_mask, window) for whichever of
    those the call sets."""
    from ..ops.attention import dense_attention, segment_mask
    n = axis_size(axis_name)

    def swap_in(x):   # [b, s/n, h, d] -> [b, s, h/n, d]
        return C.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    def swap_out(x):  # [b, s, h/n, d] -> [b, s/n, h, d]
        return C.all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    kw = {}
    if segment_ids is not None:
        seg_full = C._gather(segment_ids.to(torch.int32), axis_name, 1)
        kw["attn_mask"] = segment_mask(seg_full)
    if window is not None:
        kw["window"] = window
    if attn_fn is not None and kw:
        # the contract spelled out, instead of a TypeError from deep
        # inside the wrapped function
        try:
            sig = inspect.signature(attn_fn)
            has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                             for p in sig.parameters.values())
            missing = [a for a in kw if a not in sig.parameters] \
                if not has_var_kw else []
        except (TypeError, ValueError):   # builtins/partials w/o signature
            missing = []
        if missing:
            cause = "/".join(
                name for name, set_ in (("segment_ids",
                                         segment_ids is not None),
                                        ("window", window is not None))
                if set_)
            raise TypeError(
                f"ulysses_attention: custom attn_fn {attn_fn!r} does not "
                f"accept {missing} — required because {cause} was set. "
                "attn_fn must take (q, k, v, *, causal, attn_mask, "
                "window) like ops.attention.dense_attention.")
    attn_fn = attn_fn or functools.partial(dense_attention, scale=scale)
    kvh = k.shape[2]
    if kvh < n:  # too few KV heads to split: replicate them up to the degree
        rep = n // math.gcd(n, kvh)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attn_fn(swap_in(q), swap_in(k), swap_in(v), causal=causal, **kw)
    return swap_out(out)


def lse_merge(o, lse, o_i, lse_i):
    """Merge two normalized softmax outputs by their blocks' probability
    mass: o [b, s, h, d] fp32 and lse [b, h, s] so far, o_i / lse_i of one
    more block. Returns (o, lse) of the union, fp32."""
    m = torch.maximum(lse, lse_i)
    w = torch.exp(lse - m)                       # [b, h, s]
    w_i = torch.exp(lse_i - m)
    wq = w.transpose(1, 2)[..., None]            # [b, s, h, 1]
    wq_i = w_i.transpose(1, 2)[..., None]
    o_new = (o * wq + o_i.float() * wq_i) / (wq + wq_i)
    return o_new, m + torch.log(w + w_i)


def ring_flash_step(q, kc, vc, o, lse, step: int, idx: int, causal: bool,
                    scale: float):
    """Ring step ``step`` of the rank at ``sp`` index ``idx``, holding
    the K/V block of index (idx - step) mod n: step 0 is the diagonal
    block (causal when asked) and starts (o fp32, lse); a later step
    takes the whole block and merges it, or, causal, skips a block in the
    rank's future (idx < step). Returns (o, lse, took)."""
    from ..ops.kernels.flash_attention import flash_attention_with_lse
    if step == 0:
        o_i, lse_i = flash_attention_with_lse(q, kc, vc, causal=causal,
                                              scale=scale)
        return o_i.float(), lse_i, True
    if causal and idx < step:
        return o, lse, False
    o_b, lse_b = flash_attention_with_lse(q, kc, vc, causal=False,
                                          scale=scale)
    o, lse = lse_merge(o, lse, o_b, lse_b)
    return o, lse, True


def ring_flash_attention(q, k, v, axis_name: str = "sp",
                         causal: bool = False, scale: Optional[float] = None,
                         segment_ids=None, window: Optional[int] = None):
    """Ring attention with ``flash_attention_with_lse`` on each block pair
    (semantics identical to :func:`ring_attention`; the fast path for
    long sequences). ``segment_ids``/``window`` route to
    :func:`ring_attention`: the flash call has no cross-block position
    offset, so the masked variants use the dense block pairs."""
    if segment_ids is not None or window is not None:
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                              scale=scale, segment_ids=segment_ids,
                              window=window)
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    perm = _ring_perm(n)
    o, lse, _ = ring_flash_step(q, k, v, None, None, 0, idx, causal, scale)
    kc, vc = k, v
    for step in range(1, n):
        kc, vc = ppermute((kc, vc), perm, axis_name)
        o, lse, took = ring_flash_step(q, kc, vc, o, lse, step, idx, causal,
                                       scale)
        if not took:
            o = _Keep.apply(o, kc, vc)
    return o.to(q.dtype)
