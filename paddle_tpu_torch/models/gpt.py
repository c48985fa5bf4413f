"""GPT-2/3 family (counterpart of ``paddle_tpu/models/gpt.py``: ``GPTConfig``,
``gpt_tiny``, ``GPTAttention``, ``GPTMLP``, ``GPTDecoderLayer``,
``GPTModel``, ``GPTForCausalLM``).

A causal LM of pre-LN blocks: one fused, biased qkv projection (split
after as [3, heads, head_dim]), a biased output projection, a tanh-GELU
MLP, and a learned position table added to the token embeddings (read
with the JAX gather's clamp: a position past ``max_position_embeddings``
reads the last row). The LM head is tied to the token table by default.

Attention follows the JAX module's three routes:

- no cache: causal flash attention (the flash kernels through their
  backward on the card) when the shapes admit it and no mask is given;
  dense attention otherwise, under the explicit mask when one is given
  (the packed SFT fallback's block-causal mask);
- with a (k, v) cache: this step's K/V are written into the cache in
  place at ``cache_index`` and the queries attend the whole cache under
  ``kpos <= qpos`` through dense attention, at the prefill too. The JAX
  module computes this outside Pallas, so the port keeps the plain math:
  at a device ``cache_index`` (one index, or one a row) it reads nothing
  on the host, and ``generate()``'s decode step captures it into a CUDA
  graph with no attention kernel in it.

The forward takes no ``attn_start`` (a left-padded ``generate()`` raises
``TypeError``, as the JAX call does) and no paged cache (a
``PagedEngine`` refuses the model: ``pages = False``). On a tp mesh the
fused qkv holds this rank's heads' q, k and v columns with their biases
(``ColumnParallelLinear(fused_parts=3)``: a strided shard of the JAX
layout, so ``state_dict`` and checkpoints keep that layout), the caches
hold this rank's heads, and the tied head is ``parallel_matmul`` over the
vocab-split table.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn import LayerList, LayerNorm
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.recompute import recompute
from ..ops.attention import dense_attention, flash_attention, use_flash
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding, local_heads,
                               parallel_matmul)
from ..parallel.sharding import constraint
from ..utils.rng import make_generator
from .base import CausalLMBase
from .llama import cache_positions


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    recompute: bool = False
    use_flash_attention: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def gpt_tiny(**overrides) -> GPTConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128, dtype=torch.float32)
    base.update(overrides)
    return GPTConfig(**base)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(generator=generator, device=device, dtype=config.dtype,
                  has_bias=True)
        # fused qkv: one column-parallel matmul, split after
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                             fused_parts=3, **kw)
        self.out_proj = RowParallelLinear(h, h, **kw)

    def forward(self, x, kv_cache: Optional[Tuple] = None, cache_index=None,
                attn_mask=None, cache_at=None):
        """With ``kv_cache`` = (k, v) [b, T, heads, head_dim], this step's
        K/V are written into it IN PLACE at ``cache_index`` (a Python int,
        or an integer tensor on the device of one index or one a row,
        whose (rows, positions) index pair the model built as
        ``cache_at``), and (out, (k, v)) is returned."""
        cfg = self.config
        b, s, _ = x.shape
        nh, d = local_heads(cfg)[0], cfg.head_dim
        qkv = self.qkv_proj(x).reshape(b, s, 3, nh, d)
        q, k, v = qkv.unbind(2)
        if kv_cache is not None:
            ck, cv = kv_cache
            kpos = torch.arange(ck.shape[1], device=x.device)[None, None, :]
            if torch.is_tensor(cache_index):
                ck.index_put_(cache_at, k.to(ck.dtype))
                cv.index_put_(cache_at, v.to(cv.dtype))
                qpos = cache_at[1][:, :, None]                  # [b, s, 1]
            else:
                ci = operator.index(cache_index)
                ck[:, ci:ci + s] = k.to(ck.dtype)
                cv[:, ci:ci + s] = v.to(cv.dtype)
                qpos = ci + torch.arange(s, device=x.device)[None, :, None]
            out = dense_attention(q, ck, cv, attn_mask=(kpos <= qpos)[:, None])
            return self.out_proj(out.reshape(b, s, nh * d)), (ck, cv)
        if cfg.use_flash_attention and attn_mask is None \
                and use_flash(q, k, None, 0.0):
            # the kernels read dense tensors, not slices of the qkv product
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
        else:
            out = dense_attention(q, k, v, causal=attn_mask is None,
                                  attn_mask=attn_mask)
        return self.out_proj(out.reshape(b, s, nh * d))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device, generator):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=config.dtype,
                  has_bias=True)
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.intermediate_size,
                                          gather_output=False, **kw)
        self.fc_out = RowParallelLinear(config.intermediate_size,
                                        config.hidden_size, **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config: GPTConfig, *, device, generator):
        super().__init__()
        norm = dict(epsilon=config.layer_norm_epsilon, device=device,
                    dtype=config.dtype)
        self.ln_1 = LayerNorm(config.hidden_size, **norm)
        self.attn = GPTAttention(config, device=device, generator=generator)
        self.ln_2 = LayerNorm(config.hidden_size, **norm)
        self.mlp = GPTMLP(config, device=device, generator=generator)

    def forward(self, x, kv_cache=None, cache_index=None, attn_mask=None,
                cache_at=None):
        attn_out = self.attn(self.ln_1(x), kv_cache=kv_cache,
                             cache_index=cache_index, attn_mask=attn_mask,
                             cache_at=cache_at)
        new_cache = None
        if kv_cache is not None:
            attn_out, new_cache = attn_out
        x = x + attn_out
        x = x + self.mlp(self.ln_2(x))
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        return (x, new_cache) if kv_cache is not None else x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device, generator):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator, **kw)
        pos = torch.empty(config.max_position_embeddings,
                          config.hidden_size, **kw)
        I.Normal(0.0, config.initializer_range)(pos, generator)
        self.embed_positions = nn.Parameter(pos)
        self.layers = LayerList(
            [GPTDecoderLayer(config, device=device, generator=generator)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None):
        positions, cache_at = cache_positions(input_ids, positions,
                                              cache_index)
        x = self.embed_tokens(input_ids) + F.take_rows(self.embed_positions,
                                                       positions)
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, cache = layer(x, kv_cache=kv_caches[i],
                                 cache_index=cache_index,
                                 attn_mask=attn_mask, cache_at=cache_at)
                new_caches.append(cache)
            elif self.config.recompute:
                x = recompute(lambda h, lyr=layer: lyr(h, attn_mask=attn_mask),
                              x)
            else:
                x = layer(x, attn_mask=attn_mask)
        x = self.ln_f(x)
        return (x, new_caches) if kv_caches is not None else x


class GPTForCausalLM(CausalLMBase):
    """GPT causal LM. ``device=None`` means the CUDA card (raises when
    there is none); the weights are drawn from ``generator`` (a fresh
    seed-0 generator on the device when not given)."""

    # the attention reads its cache as a (k, v) pair only
    pages = False

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.model = GPTModel(config, device=device, generator=generator)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                generator=generator, device=device, dtype=config.dtype)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None):
        out = self.model(input_ids, positions, kv_caches, cache_index,
                         attn_mask)
        caches = None
        if kv_caches is not None:
            out, caches = out
        if self.config.tie_word_embeddings:
            logits = parallel_matmul(out, self.model.embed_tokens.weight,
                                     transpose_y=True)
        else:
            logits = self.lm_head(out)
        logits = logits.float()
        return (logits, caches) if kv_caches is not None else logits
