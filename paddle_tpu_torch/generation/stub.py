"""Negligible-compute reference CausalLM for the paged-serving tick
machinery (counterpart of ``paddle_tpu/generation/stub.py``): embed ->
paged KV write -> paged attention -> vocab projection, one layer, one
head. Gateway, request-trace and tick-profile tests that drive it measure
scheduling, dispatch and transport, not model FLOPs.

Its two parameters, ``emb`` [V, d] and ``out`` [d, V], are passed in (the
tests pass the JAX stub's values as numpy, so both packages' stubs
compute the same function); without them they are drawn from a torch
generator seeded with 0.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .paged import (paged_chunk_attention, paged_decode_attention,
                    paged_decode_write, paged_prefill_write)

__all__ = ["TickStubModel"]


class TickStubModel(torch.nn.Module):
    """The minimal model contract ``PagedEngine`` drives: ``config``
    (vocab, layers, kv heads, head_dim, dtype), ``device``, and
    ``forward(tokens, kv_caches, positions, paged_chunk, paged_decode) ->
    (logits, caches)``. The decode tick (including the speculative
    multi-query verify, ``paged_decode=True``) writes each row's K/V at
    its length and attends through ``paged_decode_attention`` (the ragged
    kernel on a card at a head_dim it takes); a (chunk) prefill writes
    row 0's K/V at its global positions and attends over the row's
    blocks."""

    def __init__(self, emb: Optional[np.ndarray] = None,
                 out: Optional[np.ndarray] = None, device="cpu",
                 vocab_size: int = 128, head_dim: int = 8,
                 dtype=torch.float32):
        super().__init__()
        if emb is not None:
            vocab_size, head_dim = np.shape(emb)
        self.config = SimpleNamespace(
            vocab_size=vocab_size, num_hidden_layers=1,
            num_key_value_heads=1, head_dim=head_dim, dtype=dtype)
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(0)
        emb = torch.randn(vocab_size, head_dim, generator=gen) \
            if emb is None else torch.tensor(np.asarray(emb))
        out = torch.randn(head_dim, vocab_size, generator=gen) \
            if out is None else torch.tensor(np.asarray(out))
        self.emb = torch.nn.Parameter(emb.to(self.device, dtype),
                                      requires_grad=False)
        self.out = torch.nn.Parameter(out.to(self.device, dtype),
                                      requires_grad=False)

    def forward(self, tokens, kv_caches=None, positions=None,
                paged_chunk=False, paged_decode=False):
        x = self.emb[tokens]                               # [R, s, d]
        kv = x[:, :, None, :]                              # [R, s, 1, d]
        pk = kv_caches[0]
        if paged_decode or tokens.shape[1] == 1:
            pk = paged_decode_write(pk, kv, kv)
            o = paged_decode_attention(kv, pk)[:, :, 0]
        else:
            # a chunk's K/V lands at its global positions
            pk = paged_prefill_write(pk, kv, kv, positions=positions[0])
            o = paged_chunk_attention(kv[:1], pk, positions)[:, :, 0]
        return o @ self.out, [pk]
