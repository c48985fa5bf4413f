"""Qwen2-MoE / DeepSeek-MoE families (counterpart of
``paddle_tpu/models/qwen2_moe.py``).

The Llama/Qwen2 decoder with its FFN swapped for
:class:`~..parallel.moe.MoEMLP` (GShard capacity dispatch, stacked
[E, h, m] experts, the switch aux loss summed through the forward). The
first ``first_k_dense_replace`` layers keep the dense FFN (DeepSeekMoE).
The attention is the port's ``LlamaAttention`` on RoPE tables computed
once a forward, so prefill, decode and the paged engine's tick reach the
flash, decode and ragged kernels through the Llama code.

The forward keeps the JAX package's signature: it takes neither
``paged_chunk`` nor ``paged_decode`` (so a chunked-prefill or
speculative ``PagedEngine`` fails on it, as the JAX engine does), and
no left-padded batch (``attn_start``: the port's ``generate`` passes
None, which is accepted; anything else raises ``TypeError`` as the JAX
model's missing keyword does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import RMSNorm
from ..nn.recompute import recompute
from ..parallel.layers import (ColumnParallelLinear, VocabParallelEmbedding,
                               parallel_matmul)
from ..parallel.moe import MoEMLP
from ..parallel.sharding import constraint, shard_built
from ..utils.rng import make_generator
from .base import CausalLMBase
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, cache_positions,
                    causal_lm_loss, llama_pipeline_functional, register_rope,
                    rotary_cos_sin)


@dataclass
class Qwen2MoeConfig(LlamaConfig):
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5632          # dense-layer FFN width
    moe_intermediate_size: int = 1408      # per-expert FFN width
    num_experts: int = 60
    num_experts_per_tok: int = 4
    num_shared_experts: int = 1            # always-on shared expert(s)
    shared_expert_intermediate_size: Optional[int] = 5632
    first_k_dense_replace: int = 0         # DeepSeekMoE: first k layers dense
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    # Qwen2-MoE: sigmoid token gate scaling the shared expert's output
    shared_expert_gate: bool = False
    # renormalize the selected top-k gates to sum to 1 (Qwen2-57B-A14B)
    norm_topk_prob: bool = False
    attention_bias: bool = True
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0


def qwen2_moe_tiny(**overrides) -> Qwen2MoeConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=64, num_experts=4,
                num_experts_per_tok=2, num_shared_experts=1,
                shared_expert_intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, dtype=torch.float32)
    base.update(overrides)
    return Qwen2MoeConfig(**base)


def deepseek_moe_tiny(**overrides) -> Qwen2MoeConfig:
    """DeepSeekMoE pattern: first layer dense, fine-grained experts."""
    base = dict(first_k_dense_replace=1, num_experts=8,
                num_experts_per_tok=2, num_shared_experts=2,
                shared_expert_intermediate_size=64, attention_bias=False)
    base.update(overrides)
    return qwen2_moe_tiny(**base)


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, config: Qwen2MoeConfig, layer_idx: int, *, device,
                 generator):
        super().__init__()
        self.config = config
        norm = dict(device=device, dtype=config.dtype)
        kw = dict(device=device, generator=generator)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **norm)
        self.self_attn = LlamaAttention(config, layer_idx, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **norm)
        self.is_dense = layer_idx < config.first_k_dense_replace
        if self.is_dense:
            self.mlp = LlamaMLP(config, **kw)
        else:
            self.mlp = MoEMLP(
                config.hidden_size, config.moe_intermediate_size,
                num_experts=config.num_experts,
                top_k=config.num_experts_per_tok,
                capacity_factor=config.capacity_factor,
                num_shared_experts=config.num_shared_experts,
                shared_intermediate_size=(
                    config.shared_expert_intermediate_size),
                aux_loss_weight=config.aux_loss_weight,
                use_shared_expert_gate=getattr(config, "shared_expert_gate",
                                               False),
                norm_topk_prob=getattr(config, "norm_topk_prob", False),
                dtype=config.dtype, **kw)

    def forward(self, x, rope, kv_cache=None, cache_index=None,
                attn_mask=None, segment_ids=None, cache_at=None):
        attn_out = self.self_attn(self.input_layernorm(x), rope,
                                  kv_cache=kv_cache, cache_index=cache_index,
                                  attn_mask=attn_mask,
                                  segment_ids=segment_ids, cache_at=cache_at)
        new_cache = None
        if kv_cache is not None:
            attn_out, new_cache = attn_out
        x = x + attn_out
        h = self.post_attention_layernorm(x)
        if self.is_dense:
            x = x + self.mlp(h)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            y, aux = self.mlp(h, return_aux=True)
            x = x + y
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        if kv_cache is not None:
            return x, aux, new_cache
        return x, aux


class Qwen2MoeModel(nn.Module):
    def __init__(self, config: Qwen2MoeConfig, *, device, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator,
            device=device, dtype=config.dtype)
        # inside sharded_build each layer is cut to this rank's shards
        # (its heads, its dense columns, its E / ep experts) as drawn
        self.layers = nn.ModuleList(
            [shard_built(Qwen2MoeDecoderLayer(config, i, device=device,
                                              generator=generator))
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=config.dtype)
        register_rope(self, config, device)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, segment_ids=None):
        cfg = self.config
        positions, cache_at = cache_positions(input_ids, positions,
                                              cache_index)
        x = self.embed_tokens(input_ids)
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        rope = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                              x.dtype, inv_freq=self.rope_inv_freq,
                              attention_scaling=self.attn_scaling)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, aux, nc = layer(x, rope, kv_cache=kv_caches[i],
                                   cache_index=cache_index,
                                   attn_mask=attn_mask, cache_at=cache_at)
                new_caches.append(nc)
            elif cfg.recompute:
                x, aux = recompute(
                    lambda h, lyr=layer: lyr(h, rope, attn_mask=attn_mask,
                                             segment_ids=segment_ids),
                    x, policy=cfg.recompute_policy)
            else:
                x, aux = layer(x, rope, attn_mask=attn_mask,
                               segment_ids=segment_ids)
            aux_total = aux_total + aux
        x = self.norm(x)
        if kv_caches is not None:
            return x, aux_total, new_caches
        return x, aux_total


class Qwen2MoeForCausalLM(CausalLMBase):
    """``device=None`` means the CUDA card (raises when there is none);
    the weights are drawn from ``generator`` (seed 0 on the device when
    not given)."""

    rows_independent = False            # MoE capacity is per call

    def __init__(self, config: Qwen2MoeConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.model = Qwen2MoeModel(config, device=device, generator=generator)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                generator=generator, device=device, dtype=config.dtype)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, return_aux: bool = False,
                segment_ids=None, attn_start=None):
        if attn_start is not None:
            raise TypeError(
                f"{type(self).__name__}.forward() takes no attn_start: the "
                f"MoE decoder has no pad-prefix mask for left-padded "
                f"batches (the JAX package's forward has no such argument)")
        out = self.model(input_ids, positions, kv_caches, cache_index,
                         attn_mask, segment_ids=segment_ids)
        caches = None
        if kv_caches is not None:
            h, aux, caches = out
        else:
            h, aux = out
        if self.config.tie_word_embeddings:
            logits = parallel_matmul(h, self.model.embed_tokens.weight,
                                     transpose_y=True)
        else:
            logits = self.lm_head(h)
        logits = logits.float()
        if kv_caches is not None:
            return (logits, aux, caches) if return_aux else (logits, caches)
        return (logits, aux) if return_aux else logits

    def pipeline_functional(self, pp: int, logits_loss=None, vpp: int = 1):
        """1F1B pipeline over ``pp`` stages, composed with expert
        parallelism: the MoE layers' aux loss rides each stage's own
        backward (reference: fleet pp+ep hybrid topology). Requires
        uniform layers (first_k_dense_replace == 0) so every stage holds
        the same parameters."""
        if self.config.first_k_dense_replace:
            raise ValueError(
                "pipeline_functional needs uniform MoE layers "
                "(first_k_dense_replace=0): dense and MoE layer params "
                "cannot stack into one [pp, n_per, ...] tree")
        return llama_pipeline_functional(self, pp, logits_loss=logits_loss,
                                         vpp=vpp)


def moe_lm_loss(logits, aux_loss, labels, ignore_index: int = -100):
    """Next-token CE + router balancing aux loss."""
    return causal_lm_loss(logits, labels, ignore_index) + aux_loss


DeepseekMoeConfig = Qwen2MoeConfig
DeepseekMoeForCausalLM = Qwen2MoeForCausalLM
