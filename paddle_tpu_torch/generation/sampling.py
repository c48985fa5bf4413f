"""Logits processors for autoregressive decoding (the subset of
``paddle_tpu/generation/sampling.py`` that ``generate()`` uses).

Filtering masks to the finite -1e30, as the JAX package does, so a
filtered row never holds a NaN. Sampling draws from an explicit
``torch.Generator``; the JAX package's threefry keys have no torch
counterpart, so sampled streams match the reference in distribution, not
bit for bit.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def apply_temperature(logits, temperature):
    return logits / max(float(temperature), 1e-6)


def top_k_filter(logits, k: int):
    """Keep the k highest logits per row; mask the rest."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                       logits)


def top_p_filter(logits, p: float):
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches p (always keeps the argmax)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # mask sorted positions whose *previous* cumulative already reached p
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def repetition_penalty(logits, generated_mask, penalty: float):
    """Divide positive / multiply negative logits of seen tokens
    (``generated_mask`` [b, vocab], counts or bools)."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(generated_mask > 0, penalized, logits)


def sample_token(logits, generator=None, temperature=1.0, top_k=0,
                 top_p=1.0, do_sample=True):
    """logits [b, vocab] -> token ids [b] (int64)."""
    logits = logits.float()
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = apply_temperature(logits, temperature)
    if top_k and top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def suffix_window_hits(seq, cur: int, g: int):
    """[..., L] bool: window ``seq[..., p : p+g]`` equals the last ``g``
    committed tokens ``seq[..., cur-g : cur]``, restricted to windows
    strictly earlier than that suffix. ``g == 0`` matches every committed
    position. Leading dims are rows."""
    L = seq.shape[-1]
    starts = torch.arange(L, device=seq.device)
    idx = (starts[:, None] + torch.arange(g, device=seq.device)[None, :]
           ).clamp(0, L - 1)                                  # [L, g]
    win = seq[..., idx]                                       # [..., L, g]
    last = seq[..., max(cur - g, 0):max(cur - g, 0) + g]      # [..., g]
    hit = (win == last[..., None, :]).all(dim=-1)
    return hit & (starts <= cur - g - 1) & (cur >= g)
