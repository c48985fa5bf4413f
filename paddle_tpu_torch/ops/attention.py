"""Attention dispatch (counterpart of ``paddle_tpu/ops/attention.py``).

Public functions keep the JAX package's [b, s, h, d] layout. The gates
(``use_flash``, ``use_decode_kernel``, ``use_paged_kernel``) look at
shapes only; which device the tensors lie on decides, inside the kernel
wrappers, whether the Hopper kernel or its plain version runs. The TPU-only conditions of the
JAX gates (a TPU backend or interpret mode, the d=64 even-kv rule of
Mosaic's tiling) are not inherited.
"""
from __future__ import annotations

import math

import torch

from .kernels.decode_attention import HEAD_DIMS as _DECODE_HEAD_DIMS
from .kernels.decode_attention import MAX_GROUP, decode_attention_fwd
from .kernels.flash_attention import HEAD_DIMS as _FLASH_HEAD_DIMS
from .kernels.flash_attention import FlashAttentionFunction
from .kernels.ragged_paged_attention import HEAD_DIMS as _PAGED_HEAD_DIMS
from .kernels.ragged_paged_attention import MAX_ROWS as _PAGED_MAX_ROWS


def use_flash(query, key, attn_mask, dropout_p) -> bool:
    """The flash kernel's shapes: no explicit mask or dropout, sequences in
    whole 128-row tiles (as the JAX gate asks), head_dim 64, 128 or 256."""
    if attn_mask is not None or dropout_p > 0.0:
        return False
    sq, d = query.shape[1], query.shape[3]
    sk = key.shape[1]
    return sq % 128 == 0 and sk % 128 == 0 and d in _FLASH_HEAD_DIMS


def flash_attention(query, key, value, causal=False, scale=None,
                    segment_ids=None, window=None):
    """[b, s, h, d] flash attention; GQA-aware. ``segment_ids`` [b, s]
    (0 = pad) restricts attention to same-segment pairs. Differentiable on
    both devices through :class:`FlashAttentionFunction`, whose backward
    is the flash backward kernels on the card."""
    return FlashAttentionFunction.apply(query, key, value, causal, scale,
                                        window, segment_ids)


def segment_mask(segment_ids):
    """[b, s] segment ids -> [b, 1, s, s] same-segment boolean mask."""
    seg = torch.as_tensor(segment_ids)
    return (seg[:, :, None] == seg[:, None, :])[:, None]


def dense_attention(query, key, value, attn_mask=None, causal=False,
                    scale=None, window=None):
    """Dense path on [b, s, h, d]: fp32 softmax, GQA by repeating K/V.
    ``window`` (with causal) keeps only the trailing ``window`` keys per
    query; a boolean ``attn_mask`` keeps where True, a float one adds."""
    b, sq, h, d = query.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    if k.shape[1] != h:
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    if causal:
        sk = k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(diagonal=sk - sq)
        if window is not None:
            qpos = torch.arange(sq, device=scores.device)[:, None] + (sk - sq)
            mask = mask & (qpos - torch.arange(sk, device=scores.device)
                           < window)
        scores = torch.where(mask, scores, neg_inf)
    elif window is not None:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is causal)")
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg_inf)
        else:
            scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2)


def use_paged_kernel(q, kp) -> bool:
    """The ragged paged kernel's shapes (q [R, T, h, d], pools [P, B, kvh,
    d]): whole query-head groups of at most the kernel's query rows,
    head_dim 64, 128 or 256, any T (the wrapper splits a window whose T x
    group rows do not fit one launch, as the TPU gate admits any T). The
    TPU gate's interpret-mode switch and its Mosaic rules (B % 8, d % 128
    or kvh == 1) are not inherited."""
    h, d = q.shape[2], q.shape[3]
    kvh = kp.shape[2]
    return (h % kvh == 0 and d in _PAGED_HEAD_DIMS
            and h // kvh <= _PAGED_MAX_ROWS)


def use_decode_kernel(q, k_cache) -> bool:
    """The decode kernel's shapes: one query per row, a whole number of
    query heads (at most 8) per kv head, head_dim 64, 128 or 256."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    kv = k_cache.shape[2]
    return (s == 1 and h % kv == 0 and h // kv <= MAX_GROUP
            and d in _DECODE_HEAD_DIMS)


def decode_attention(q, k_cache, v_cache, cache_index: int, scale=None,
                     window=None):
    """Single-token decode over a static KV cache. q [b, 1, h, d];
    k/v_cache [b, T, kv, d]; positions <= cache_index attend.

    Both paths are GQA-native: neither repeats K/V per query head."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"decode_attention is for q_len=1, got {s}")
    kv, T = k_cache.shape[2], k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    if use_decode_kernel(q, k_cache):
        out = decode_attention_fwd(q[:, 0], k_cache, v_cache, cache_index,
                                   scale, window=window)
        return out[:, None]

    # grouped einsum: contract per kv head without materialising a repeat
    g = h // kv
    qg = q[:, 0].reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                          k_cache.float()) * scale
    kpos = torch.arange(T, device=q.device)
    mask = kpos <= cache_index
    if window is not None:
        mask = mask & (kpos > cache_index - window)
    scores = torch.where(mask, scores,
                         torch.tensor(float("-inf"), device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache)
    return out.reshape(b, 1, h, d)
