"""Prompt-lookup drafting for the paged engine's speculative ticks
(counterpart of ``paddle_tpu/generation/prompt_lookup.py``).

The proposer copies the continuation of the most recent earlier
occurrence of a row's last ``ngram`` committed tokens. It only drafts:
the match reads committed positions (< ``n``), and the copied
continuation may run into the stale tail past them, which is harmless
because the verify forward checks every drafted token.

Everything but :func:`token_buffer_row` (host-side mirror packing) takes
tensors, the committed counts included, and runs inside a captured CUDA
graph: no host synchronisation, no data-dependent shape, no Python
branch on a tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .sampling import suffix_window_hits_rows

__all__ = ["propose_ngram", "propose_ngram_rows", "accept_length",
           "mask_drafts", "token_buffer_row"]


def token_buffer_row(seq, length: int, fill: int = 0) -> np.ndarray:
    """One slot's committed-stream buffer row [length] int32 (prompt and
    emitted tokens, ``fill``-padded): the row the full rebuild stacks and
    the transition descriptor carries, so both upload the same bytes."""
    row = np.full((length,), fill, np.int32)
    n = min(len(seq), length)
    row[:n] = np.asarray(seq[:n], np.int64)
    return row


def propose_ngram_rows(seqs, ns, num_draft: int, ngram: int, fill=-1):
    """Per-row drafts: ``seqs`` [R, L] committed streams, ``ns`` [R]
    committed counts -> [R, num_draft]. A row with no earlier match gets
    ``fill`` (-1 by default, which no token id equals, so the verify
    rejects it). The copy starts where the JAX package's
    ``dynamic_slice`` starts: clamped so the window fits in the row."""
    R, L = seqs.shape
    hit = suffix_window_hits_rows(seqs, ns, ngram)             # [R, L]
    any_hit = hit.any(dim=-1)
    # the most recent hit: the first maximum of the flipped mask
    p = L - 1 - torch.argmax(hit.flip(-1).to(torch.int32), dim=-1)
    src = torch.where(any_hit, p + ngram, torch.zeros_like(p))
    start = src.clamp(0, L - num_draft)
    idx = start[:, None] + torch.arange(num_draft, device=seqs.device)
    draft = seqs.gather(1, idx)
    return torch.where(any_hit[:, None], draft,
                       torch.full_like(draft, fill))


def propose_ngram(seq, n, num_draft: int, ngram: int, fill):
    """One row of :func:`propose_ngram_rows`: ``seq`` [L], ``n`` a 0-d
    tensor of committed tokens -> [num_draft]."""
    return propose_ngram_rows(seq[None], torch.as_tensor(n).reshape(1),
                              num_draft, ngram, fill)[0]


def mask_drafts(drafts, kprop, fill=-1):
    """Positions at or past each row's draft cap ``kprop`` [R] become
    ``fill``: drafts [R, k] -> [R, k]."""
    k = drafts.shape[-1]
    keep = torch.arange(k, device=drafts.device)[None, :] < kprop[:, None]
    return torch.where(keep, drafts, torch.full_like(drafts, fill))


def accept_length(draft, target):
    """Longest matched-prefix count of ``draft`` [..., k] against the
    verify targets ``target`` [..., >= k]."""
    k = draft.shape[-1]
    match = torch.cumprod((draft == target[..., :k]).to(torch.int32),
                          dim=-1)
    return match.sum(dim=-1)
