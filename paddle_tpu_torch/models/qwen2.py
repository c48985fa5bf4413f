"""Qwen2 family (counterpart of ``paddle_tpu/models/qwen2.py``).

Qwen2 is the Llama backbone with biased q/k/v projections (and tied
embeddings in its small variants), so the port reuses its Llama decoder
whole: the same flash, decode and paged kernels, the same static KV
cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel


@dataclass
class Qwen2Config(LlamaConfig):
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    attention_bias: bool = True        # the Qwen2 signature difference


def qwen2_7b(**overrides) -> Qwen2Config:
    return Qwen2Config(**overrides)


def qwen2_tiny(**overrides) -> Qwen2Config:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, dtype=torch.float32)
    base.update(overrides)
    return Qwen2Config(**base)


class Qwen2Model(LlamaModel):
    pass


class Qwen2ForCausalLM(LlamaForCausalLM):
    pass
