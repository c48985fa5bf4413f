"""The ERNIE family (counterpart of ``paddle_tpu/models/ernie.py``), both
halves:

- the BERT-family encoder (``ErnieConfig``, ``ernie_tiny``,
  ``ErnieModel``, ``ErnieForMaskedLM``, ``ErnieForSequenceClassification``):
  ``models.bert``'s encoder plus a task-type embedding table, summed into
  the embeddings before their LayerNorm. With ``use_task_id`` on and no
  ``task_type_ids`` given, task 0's embedding is added, as in the
  reference;
- ERNIE-4.5 MoE (``Ernie45MoeConfig``, ``ernie45_moe_tiny``,
  ``Ernie45MoeForCausalLM``). Baidu's flagship decoder LM is the
  Qwen2-MoE / DeepSeekMoE decoder shape (GQA attention, fine-grained
  experts with always-on shared experts, the first layers dense), so it
  is that backbone at ERNIE-4.5's config point.

The dataclass default is kept as the JAX package has it:
``shared_expert_intermediate_size=1536`` with ``num_shared_experts=2``
makes one 1536-wide shared FFN, while ``config_from_hf`` on a checkpoint
without that key gives 2 x 1536.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Dropout, Linear
from ..nn import functional as F
from ..utils.rng import make_generator
from .bert import BertConfig, BertModel, TiedMLMHead, _table
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM


@dataclass
class ErnieConfig(BertConfig):
    vocab_size: int = 40000
    task_type_vocab_size: int = 3
    use_task_id: bool = True


def ernie_tiny(**overrides) -> ErnieConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, dtype=torch.float32)
    base.update(overrides)
    return ErnieConfig(**base)


class ErnieModel(nn.Module):
    """``device=None`` means the CUDA card; the weights are drawn from
    ``generator`` (seed 0 on the device when not given)."""

    def __init__(self, config: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.encoder = BertModel(config, device=device, generator=generator)
        if config.use_task_id:
            self.task_type_embeddings = _table(
                config.task_type_vocab_size, config.hidden_size,
                config.initializer_range, device=device,
                dtype=config.dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, positions=None):
        extra = None
        if self.config.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            extra = F.take_rows(self.task_type_embeddings, task_type_ids)
        return self.encoder(input_ids, token_type_ids, attention_mask,
                            positions, extra_embeds=extra)


class ErnieForMaskedLM(nn.Module):
    def __init__(self, config: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.ernie = ErnieModel(config, device=device, generator=generator)
        self.mlm_head = TiedMLMHead(config, device=device,
                                    generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids, attention_mask,
                            task_type_ids)
        word_w = self.ernie.encoder.embeddings.word_embeddings.weight
        return self.mlm_head(seq, word_w)


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.ernie = ErnieModel(config, device=device, generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 generator=generator, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                               task_type_ids)
        return self.classifier(self.dropout(pooled)).float()


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
