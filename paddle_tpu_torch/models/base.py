"""Shared causal-LM plumbing (counterpart of ``paddle_tpu/models/base.py``):
``generate()`` and the static KV-cache allocator.

On a mesh with ``tp`` of degree T each rank attends its own 1/T of the
query and kv heads (the tp projections' local columns), so each rank's
caches hold ``num_key_value_heads / T`` heads: :func:`local_heads`.
(MLA's latent cache has no heads: every rank holds it whole.)
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layer import Layer
from ..parallel.layers import local_heads


class CausalLMBase(nn.Module):
    """Base for *ForCausalLM heads: generation + KV-cache allocation, and
    ``functional()``, the JAX package's training idiom: ``pure_fn, params
    = model.functional()``, then ``value_and_grad`` over ``pure_fn(params,
    ids)`` (``nn.Layer.functional``)."""

    functional = Layer.functional

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # whether each batch row's outputs depend on that row alone: an MoE
    # layer's experts take a capacity of tokens shared by every row of a
    # call, so rows compete for it (padding a batch changes which tokens
    # are dropped, and a row served alone is routed as a batch of one)
    rows_independent = True

    # whether the forward takes a ``PagedKV`` as a layer's cache (the
    # ``PagedEngine``'s pools); GPT's attention reads a (k, v) pair only
    pages = True

    def generate(self, input_ids, config=None, generator=None, **kwargs):
        from ..generation import generate as _generate
        return _generate(self, input_ids, config=config,
                         generator=generator, **kwargs)

    def init_kv_caches(self, batch_size: int, max_len: int, dtype=None):
        """One (k, v) pair of zeroed [b, max_len, kv_heads, head_dim]
        tensors per layer, on the model's device; ``kv_heads`` is this
        rank's (:func:`local_heads`). Decode steps write them in place."""
        cfg = self.config
        dtype = dtype or cfg.dtype
        shape = (batch_size, max_len, local_heads(cfg)[1], cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.num_hidden_layers)]
