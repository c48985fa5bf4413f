"""Vision Transformer (counterpart of ``paddle_tpu/models/vit.py``:
``ViTConfig``, ``vit_tiny``, ``vit_base_patch16_224``,
``vit_large_patch14_224``, ``PatchEmbed``, ``ViTAttention``, ``ViTBlock``,
``ViTModel``, ``ViTForImageClassification``).

A strided-conv patch embedding, an optional class token (``cls_token``,
a plain [1, 1, h] parameter), learned positions (``pos_embed``, [1, n,
h]), an optional LayerNorm after the embeddings (``pre_norm``, HF CLIP's
pre_layrnorm), and pre-LN blocks over one fused, biased qkv projection
with exact or quick GELU. The head pools the class token or, with
``global_pool`` or no class token, the mean of the tokens. The encoder is
built in fp32 and cast to ``config.dtype``; the classifier's head stays
fp32 and its logits are fp32, as in the JAX package. The attention is
dense (the JAX module calls ``dense_attention``: XLA math, no kernel).
On a tp mesh the fused qkv holds this rank's heads' q, k and v columns
(``ColumnParallelLinear(fused_parts=3)``), and ``proj`` / ``fc2`` sum the
ranks' parts before their bias, as GSPMD does with the JAX layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Conv2D, Dropout, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn import initializer as I
from ..ops.attention import dense_attention
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               local_heads)
from ..parallel.sharding import constraint
from ..utils.rng import make_generator


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_classes: int = 1000
    dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-6
    use_class_token: bool = True
    global_pool: bool = False      # mean-pool instead of CLS for the head
    pre_norm: bool = False         # HF CLIP's pre_layrnorm
    hidden_act: str = "gelu"       # "gelu" (erf) | "quick_gelu"
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_tiny(**overrides) -> ViTConfig:
    base = dict(image_size=32, patch_size=8, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_classes=10)
    base.update(overrides)
    return ViTConfig(**base)


def vit_base_patch16_224(**overrides) -> ViTConfig:
    return ViTConfig(**overrides)


def vit_large_patch14_224(**overrides) -> ViTConfig:
    base = dict(patch_size=14, hidden_size=1024, intermediate_size=4096,
                num_hidden_layers=24, num_attention_heads=16)
    base.update(overrides)
    return ViTConfig(**base)


def act(name, x):
    """The MLP activation of a ViT or CLIP block by its config name."""
    return F.quick_gelu(x) if name == "quick_gelu" else F.gelu(x)


class PatchEmbed(nn.Module):
    def __init__(self, config: ViTConfig, *, device, generator):
        super().__init__()
        self.proj = Conv2D(config.in_channels, config.hidden_size,
                           config.patch_size, stride=config.patch_size,
                           generator=generator, device=device)

    def forward(self, x):
        x = self.proj(x)                                # [b, h, gh, gw]
        b, c = x.shape[:2]
        return x.reshape(b, c, -1).transpose(1, 2)      # [b, n, h]


class ViTAttention(nn.Module):
    def __init__(self, config: ViTConfig, *, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(generator=generator, device=device, has_bias=True)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                   fused_parts=3, **kw)
        self.proj = RowParallelLinear(h, h, **kw)

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        nh, d = local_heads(cfg)[0], cfg.head_dim
        q, k, v = self.qkv(x).reshape(b, s, 3, nh, d).unbind(2)
        out = dense_attention(q, k, v, causal=False)
        return self.proj(out.reshape(b, s, nh * d))


class ViTBlock(nn.Module):
    """Pre-LN encoder block."""

    def __init__(self, config: ViTConfig, *, device, generator):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(generator=generator, device=device, has_bias=True)
        self.norm1 = LayerNorm(h, epsilon=eps, device=device)
        self.attn = ViTAttention(config, device=device, generator=generator)
        self.norm2 = LayerNorm(h, epsilon=eps, device=device)
        self.fc1 = ColumnParallelLinear(h, config.intermediate_size,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(config.intermediate_size, h, **kw)
        self.dropout = Dropout(config.dropout_prob, generator=generator)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.norm1(x)))
        h = act(self.config.hidden_act, self.fc1(self.norm2(x)))
        x = x + self.dropout(self.fc2(h))
        return constraint(x, ("dp", "fsdp"), None, None)


class ViTModel(nn.Module):
    """The encoder: [b, 3, H, W] -> [b, n (+1), h]. ``device=None`` means
    the CUDA card; the weights are drawn from ``generator`` (a seed-0
    generator on the device when not given)."""

    def __init__(self, config: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        h = config.hidden_size
        self.patch_embed = PatchEmbed(config, **kw)
        n_tokens = config.num_patches + int(config.use_class_token)
        pos = torch.empty(1, n_tokens, h, device=device)
        I.TruncatedNormal(std=0.02)(pos, generator)
        self.pos_embed = nn.Parameter(pos)
        if config.use_class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, h,
                                                      device=device))
        if config.pre_norm:
            self.pre_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                      device=device)
        self.blocks = LayerList([ViTBlock(config, **kw)
                                 for _ in range(config.num_hidden_layers)])
        self.norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                              device=device)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, pixel_values):
        cfg = self.config
        x = self.patch_embed(pixel_values)
        if cfg.use_class_token:
            cls = self.cls_token.expand(x.shape[0], 1, x.shape[2])
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if cfg.pre_norm:
            x = self.pre_norm(x)
        x = constraint(x, ("dp", "fsdp"), None, None)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class ViTForImageClassification(nn.Module):
    def __init__(self, config: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.vit = ViTModel(config, device, generator)
        self.head = Linear(config.hidden_size, config.num_classes,
                           generator=generator, device=device)

    def forward(self, pixel_values):
        x = self.vit(pixel_values)
        if self.config.global_pool or not self.config.use_class_token:
            pooled = x.mean(dim=1)
        else:
            pooled = x[:, 0]
        return self.head(pooled).float()
