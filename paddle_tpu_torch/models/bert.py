"""BERT family (counterpart of ``paddle_tpu/models/bert.py``: ``BertConfig``,
``bert_tiny``, ``padding_bias``, ``BertEmbeddings``, ``BertSelfAttention``,
``BertLayer``, ``BertPooler``, ``BertModel``, ``TiedMLMHead``,
``BertForPretraining``, ``BertForSequenceClassification``,
``pretraining_loss``).

A bidirectional encoder of post-LN blocks over one fused, biased qkv
projection. The padding mask enters the attention logits as an additive
bias (-1e9 on pads) through dense attention, as in the JAX module. The
MLM decoder is tied to the word table. The position, token-type (and
ERNIE's task-type) tables are read with the JAX gather's clamp
(``functional.take_rows``).

Dtypes are the JAX package's: the encoder and the MLM head's transform
run in ``config.dtype``; ``mlm_bias`` (added after the logits are cast to
fp32), the NSP head and the classifier stay fp32, so a bf16 model's
heads promote to fp32 as ``jnp`` does. Dropout draws its masks from the
generator the model was built with (its stream, not the JAX key's bits:
the tests hold parity at ``hidden_dropout_prob=0`` or in eval mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Dropout, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn import initializer as I
from ..ops.attention import dense_attention
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding, local_heads,
                               parallel_matmul)
from ..parallel.sharding import constraint
from ..utils.rng import make_generator


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def bert_tiny(**overrides) -> BertConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, dtype=torch.float32)
    base.update(overrides)
    return BertConfig(**base)


def padding_bias(attention_mask, dtype):
    """[b, s] 1/0 mask -> additive [b, 1, 1, s] bias (-1e9 on pads)."""
    bias = (1.0 - attention_mask.float()) * -1e9
    return bias[:, None, None, :].to(dtype)


def _table(rows, cols, std, *, device, dtype, generator):
    """A plain parameter table [rows, cols] drawn N(0, std) (kept in the
    JAX layout by ``convert``)."""
    t = torch.empty(rows, cols, device=device, dtype=dtype)
    I.Normal(0.0, std)(t, generator)
    return nn.Parameter(t)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device, generator):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        std = config.initializer_range
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator, **kw)
        self.position_embeddings = _table(
            config.max_position_embeddings, config.hidden_size, std,
            generator=generator, **kw)
        self.token_type_embeddings = _table(
            config.type_vocab_size, config.hidden_size, std,
            generator=generator, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, input_ids, token_type_ids=None, positions=None,
                extra_embeds=None):
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[
                None, :].expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + F.take_rows(self.position_embeddings, positions)
             + F.take_rows(self.token_type_embeddings, token_type_ids))
        if extra_embeds is not None:
            # ERNIE's task-type stream: summed before the LayerNorm
            x = x + extra_embeds
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, *, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(generator=generator, device=device, dtype=config.dtype,
                  has_bias=True)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                             fused_parts=3, **kw)
        self.out_proj = RowParallelLinear(h, h, **kw)

    def forward(self, x, attn_bias=None):
        cfg = self.config
        b, s, _ = x.shape
        nh, d = local_heads(cfg)[0], cfg.head_dim
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, nh, d).unbind(2)
        out = dense_attention(q, k, v, causal=False, attn_mask=attn_bias)
        return self.out_proj(out.reshape(b, s, nh * d))


class BertLayer(nn.Module):
    """Post-LN transformer block (original BERT residual ordering)."""

    def __init__(self, config: BertConfig, *, device, generator):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=config.dtype,
                  has_bias=True)
        norm = dict(epsilon=config.layer_norm_eps, device=device,
                    dtype=config.dtype)
        self.attention = BertSelfAttention(config, device=device,
                                           generator=generator)
        self.attn_norm = LayerNorm(config.hidden_size, **norm)
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.intermediate_size,
                                          gather_output=False, **kw)
        self.fc_out = RowParallelLinear(config.intermediate_size,
                                        config.hidden_size, **kw)
        self.out_norm = LayerNorm(config.hidden_size, **norm)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, x, attn_bias=None):
        x = self.attn_norm(x + self.dropout(self.attention(x, attn_bias)))
        h = self.fc_out(F.gelu(self.fc_in(x)))
        x = self.out_norm(x + self.dropout(h))
        return constraint(x, ("dp", "fsdp"), None, None)


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, *, device, generator):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            generator=generator, device=device,
                            dtype=config.dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """The encoder; returns (hidden states [b, s, h], pooled [b, h] or
    None without the pooler). ``device=None`` means the CUDA card."""

    def __init__(self, config: BertConfig, with_pooler: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self.layers = LayerList([BertLayer(config, **kw)
                                 for _ in range(config.num_hidden_layers)])
        self.pooler = BertPooler(config, **kw) if with_pooler else None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                positions=None, extra_embeds=None):
        x = self.embeddings(input_ids, token_type_ids, positions,
                            extra_embeds=extra_embeds)
        x = constraint(x, ("dp", "fsdp"), None, None)
        bias = (padding_bias(attention_mask, x.dtype)
                if attention_mask is not None else None)
        for layer in self.layers:
            x = layer(x, attn_bias=bias)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled


class TiedMLMHead(nn.Module):
    """Transform + LayerNorm + the decoder tied to the word table, shared
    by the BERT and ERNIE pretraining heads. The transform runs in
    ``config.dtype``; the logits are cast to fp32 and the fp32
    ``mlm_bias`` added."""

    def __init__(self, config: BertConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, dtype=config.dtype)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                generator=generator, **kw)
        self.transform_norm = LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_eps, **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                 device=device))

    def forward(self, seq, word_embedding_weight):
        h = self.transform_norm(F.gelu(self.transform(seq)))
        logits = parallel_matmul(h, word_embedding_weight, transpose_y=True)
        return logits.float() + self.mlm_bias


class BertForPretraining(nn.Module):
    """Masked-LM (tied decoder) + next-sentence-prediction heads."""

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.bert = BertModel(config, device=device, generator=generator)
        self.mlm_head = TiedMLMHead(config, device=device,
                                    generator=generator)
        self.nsp_head = Linear(config.hidden_size, 2, generator=generator,
                               device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_logits = self.mlm_head(
            seq, self.bert.embeddings.word_embeddings.weight)
        nsp_logits = self.nsp_head(pooled).float()
        return mlm_logits, nsp_logits


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.bert = BertModel(config, device=device, generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 generator=generator, device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled)).float()


def pretraining_loss(mlm_logits, mlm_labels, nsp_logits=None,
                     nsp_labels=None, ignore_index: int = -100):
    loss = F.cross_entropy(mlm_logits, mlm_labels, ignore_index=ignore_index,
                           reduction="mean")
    if nsp_logits is not None and nsp_labels is not None:
        loss = loss + F.cross_entropy(nsp_logits, nsp_labels,
                                      reduction="mean")
    return loss
