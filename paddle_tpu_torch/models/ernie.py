"""ERNIE-4.5 MoE (counterpart of the ERNIE-4.5 half of
``paddle_tpu/models/ernie.py``: ``Ernie45MoeConfig``,
``ernie45_moe_tiny``, ``Ernie45MoeForCausalLM``).

Baidu's flagship decoder LM is the Qwen2-MoE / DeepSeekMoE decoder shape
(GQA attention, fine-grained experts with always-on shared experts, the
first layers dense), so it is that backbone at ERNIE-4.5's config point.
The module's other half, the BERT-family ERNIE encoder (``ErnieModel``
and its MLM and classification heads), comes with the port's ``bert``.

The dataclass default is kept as the JAX package has it:
``shared_expert_intermediate_size=1536`` with ``num_shared_experts=2``
makes one 1536-wide shared FFN, while ``config_from_hf`` on a checkpoint
without that key gives 2 x 1536.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM


@dataclass
class Ernie45MoeConfig(Qwen2MoeConfig):
    """ERNIE-4.5 text-MoE defaults at the 21B-A3B scale (the open
    release; the 300B-A47B recipe is the same architecture scaled up)."""
    vocab_size: int = 103424
    hidden_size: int = 2560
    intermediate_size: int = 12288         # dense layers' FFN width
    moe_intermediate_size: int = 1536      # per fine-grained expert
    num_hidden_layers: int = 28
    num_attention_heads: int = 20
    num_key_value_heads: int = 4
    num_experts: int = 64
    num_experts_per_tok: int = 6
    num_shared_experts: int = 2
    shared_expert_intermediate_size: Optional[int] = 1536
    first_k_dense_replace: int = 1         # layer 0 stays dense
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False
    tie_word_embeddings: bool = False


def ernie45_moe_tiny(**overrides) -> Ernie45MoeConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=64, num_experts=4,
                num_experts_per_tok=2, num_shared_experts=1,
                shared_expert_intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                first_k_dense_replace=1, rope_theta=10000.0,
                dtype=torch.float32)
    base.update(overrides)
    return Ernie45MoeConfig(**base)


class Ernie45MoeForCausalLM(Qwen2MoeForCausalLM):
    """ERNIE-4.5 CLM = the shared MoE decoder with ERNIE's config point."""

    def __init__(self, config: Optional[Ernie45MoeConfig] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(config or Ernie45MoeConfig(), device=device,
                         generator=generator)
