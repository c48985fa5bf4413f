"""Shared causal-LM plumbing (counterpart of ``paddle_tpu/models/base.py``):
``generate()`` and the static KV-cache allocator."""
from __future__ import annotations

import torch
from torch import nn


class CausalLMBase(nn.Module):
    """Base for *ForCausalLM heads: generation + KV-cache allocation."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def generate(self, input_ids, config=None, generator=None, **kwargs):
        from ..generation import generate as _generate
        return _generate(self, input_ids, config=config,
                         generator=generator, **kwargs)

    def init_kv_caches(self, batch_size: int, max_len: int, dtype=None):
        """One (k, v) pair of zeroed [b, max_len, kv_heads, head_dim]
        tensors per layer, on the model's device. Decode steps write them
        in place."""
        cfg = self.config
        dtype = dtype or cfg.dtype
        kv_heads = getattr(cfg, "num_key_value_heads", None) \
            or cfg.num_attention_heads
        shape = (batch_size, max_len, kv_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.num_hidden_layers)]
