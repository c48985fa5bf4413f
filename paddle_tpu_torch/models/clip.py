"""CLIP (counterpart of ``paddle_tpu/models/clip.py``: ``CLIPTextConfig``,
``CLIPConfig``, ``clip_tiny``, ``CLIPTextBlock``, ``CLIPTextModel``,
``CLIPModel``, ``clip_contrastive_loss``, ``gather_features``).

Two towers: a causal pre-LN text transformer (a plain [max_pos, h]
``position_embedding`` table) pooled at the end-of-text token, and the
``ViTModel`` image tower pooled at its class token. Each tower is cast to
its own config's dtype; ``text_projection``, ``visual_projection`` (plain
[h, proj] parameters used as ``x @ P``, kept in the JAX layout) and
``logit_scale`` stay fp32, and the features are projected in fp32.

The text pooling follows the JAX rules: with ``eos_token_id`` None or 2
the position of the highest token id (the original OpenAI vocabulary,
where end-of-text is the largest id), otherwise the first occurrence of
``eos_token_id``.

The contrastive loss under data parallelism: ``gather_features`` is an
all-gather over the mesh's dp group (the identity off a mesh), and
``clip_contrastive_loss(..., dp_axis="dp")`` offsets the labels by this
rank's index times its rows, as the JAX functions do inside
``shard_map``. On a tp mesh each tower's fused qkv holds this rank's
heads' q, k and v columns (``ColumnParallelLinear(fused_parts=3)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import collective as C
from ..nn import Embedding, LayerList, LayerNorm
from ..nn import functional as F
from ..nn import initializer as I
from ..ops.attention import dense_attention
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               local_heads)
from ..utils.rng import make_generator
from .vit import ViTConfig, ViTModel, act


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"   # OpenAI default; "gelu" for OpenCLIP
    eos_token_id: Optional[int] = None
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class CLIPConfig:
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    vision: ViTConfig = field(default_factory=lambda: ViTConfig(num_classes=0))
    projection_dim: int = 512
    logit_scale_init: float = math.log(1 / 0.07)
    dtype: torch.dtype = torch.float32


def clip_tiny(**overrides) -> CLIPConfig:
    base = dict(
        text=CLIPTextConfig(vocab_size=128, max_position_embeddings=16,
                            hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2),
        vision=ViTConfig(image_size=16, patch_size=8, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, num_classes=0),
        projection_dim=32)
    base.update(overrides)
    return CLIPConfig(**base)


class CLIPTextBlock(nn.Module):
    def __init__(self, config: CLIPTextConfig, *, device, generator):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(generator=generator, device=device, has_bias=True)
        self.norm1 = LayerNorm(h, epsilon=eps, device=device)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                   fused_parts=3, **kw)
        self.proj = RowParallelLinear(h, h, **kw)
        self.norm2 = LayerNorm(h, epsilon=eps, device=device)
        self.fc1 = ColumnParallelLinear(h, config.intermediate_size,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(config.intermediate_size, h, **kw)

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        nh, d = local_heads(cfg)[0], cfg.head_dim
        q, k, v = self.qkv(self.norm1(x)).reshape(b, s, 3, nh, d).unbind(2)
        attn = dense_attention(q, k, v, causal=True)
        x = x + self.proj(attn.reshape(b, s, nh * d))
        return x + self.fc2(act(cfg.hidden_act, self.fc1(self.norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.token_embedding = Embedding(config.vocab_size,
                                         config.hidden_size,
                                         generator=generator, device=device)
        pos = torch.empty(config.max_position_embeddings, config.hidden_size,
                          device=device)
        I.Normal(0.0, 0.02)(pos, generator)
        self.position_embedding = nn.Parameter(pos)
        self.blocks = LayerList(
            [CLIPTextBlock(config, device=device, generator=generator)
             for _ in range(config.num_hidden_layers)])
        self.final_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, input_ids):
        """(hidden states [b, s, h], the pooled feature [b, h])."""
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids) \
            + self.position_embedding[None, :s].to(self.config.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.final_norm(x)
        eos_id = self.config.eos_token_id
        if eos_id is None or eos_id == 2:
            eot = input_ids.argmax(dim=-1)
        else:
            eot = (input_ids == eos_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x, pooled


class CLIPModel(nn.Module):
    """``forward(input_ids, pixel_values)`` -> (logits_per_image,
    logits_per_text), fp32. ``device=None`` means the CUDA card."""

    def __init__(self, config: CLIPConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.text_model = CLIPTextModel(config.text, device, generator)
        self.vision_model = ViTModel(config.vision, device, generator)

        def proj(rows):
            t = torch.empty(rows, config.projection_dim, device=device)
            I.Normal(0.0, 0.02)(t, generator)
            return nn.Parameter(t)
        self.text_projection = proj(config.text.hidden_size)
        self.visual_projection = proj(config.vision.hidden_size)
        self.logit_scale = nn.Parameter(torch.tensor(
            config.logit_scale_init, dtype=torch.float32, device=device))

    def encode_text(self, input_ids):
        _, pooled = self.text_model(input_ids)
        return pooled.float() @ self.text_projection

    def encode_image(self, pixel_values):
        x = self.vision_model(pixel_values)
        pooled = x[:, 0] if self.config.vision.use_class_token \
            else x.mean(dim=1)
        return pooled.float() @ self.visual_projection

    def forward(self, input_ids, pixel_values):
        t = F.normalize(self.encode_text(input_ids), axis=-1)
        v = F.normalize(self.encode_image(pixel_values), axis=-1)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        logits_per_image = scale * v @ t.T
        return logits_per_image, logits_per_image.T


def clip_contrastive_loss(logits_per_image, logits_per_text,
                          dp_axis: Optional[str] = None):
    """Symmetric InfoNCE. With ``dp_axis`` the labels are offset by this
    rank's index on that mesh axis times its rows: its slot in the
    gathered global batch (``gather_features``)."""
    n = logits_per_image.shape[0]
    labels = torch.arange(n, device=logits_per_image.device)
    if dp_axis is not None:
        labels = labels + C.axis_index(dp_axis) * n
    li = F.cross_entropy(logits_per_image, labels, reduction="mean")
    lt = F.cross_entropy(logits_per_text, labels, reduction="mean")
    return 0.5 * (li + lt)


def gather_features(feats, dp_axis: str):
    """Every rank's ``feats`` over ``dp_axis``, concatenated in rank order
    (the global in-batch negatives; its gradient is the reduce-scatter,
    as ``lax.all_gather``'s transpose). The identity off a mesh."""
    return C.all_gather(feats, dp_axis, axis=0, tiled=True)
