"""DiT and SD3's MMDiT (counterpart of ``paddle_tpu/models/dit.py``:
``timestep_embedding``, ``sincos_pos_embed_2d``, ``TimestepEmbedder``,
``LabelEmbedder``, ``modulate``, ``DiTConfig``, ``dit_tiny``, ``dit_xl_2``,
``DiTBlock``, ``DiT``, ``MMDiTConfig``, ``mmdit_tiny``, ``_StreamParams``,
``MMDiTBlock``, ``MMDiT``).

DiT: a strided-conv patch embedding plus a frozen 2-D sin-cos table
(``pos_embed``, a parameter that does not train), blocks modulated by
adaLN-Zero (six signals a block from the timestep and class embedding;
the modulation and output projections start at zero, so each block starts
as the identity), a class table with a null class for classifier-free
guidance, and ``unpatchify`` back to [b, c, H, W] (``learn_sigma``
doubles the channels). MMDiT: the image and text streams project their
own q, k, v and run ONE attention over [text; image]; the last block's
text stream is attention-only (SD3's ``context_pre_only``).

Dtypes are the JAX package's: the timestep features are fp32 and
``pos_embed`` is cast to the latents' dtype, so a bf16 model fed fp32
latents outside ``amp.auto_cast`` raises in its patch conv, as
``lax.conv`` does; under ``auto_cast`` it runs. The attention is dense
(XLA math in the JAX module). On a tp mesh DiT's fused qkv holds this
rank's heads' q, k and v columns (``ColumnParallelLinear(fused_parts=3)``),
its projection and MLP are the Megatron pair; MMDiT's stream projections
are plain layers, replicated, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Conv2D, Embedding, LayerList, LayerNorm, Linear, SiLU
from ..nn import Sequential
from ..nn import functional as F
from ..ops.attention import dense_attention
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               local_heads)
from ..utils.rng import make_generator


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep features [b, dim], fp32: cos, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_pos_embed_2d(grid: int, dim: int):
    """The fixed 2-D sin-cos table [1, grid * grid, dim]: half the channels
    encode the row, half the column, each half sin then cos."""
    if dim % 4:
        raise ValueError("sincos embed needs dim divisible by 4")
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=torch.float32)
                               / quarter))
    coords = torch.arange(grid, dtype=torch.float32)
    ys, xs = torch.meshgrid(coords, coords, indexing="ij")

    def encode(pos):
        args = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return torch.cat([encode(ys), encode(xs)], dim=-1)[None]


@torch.no_grad()
def _zero_linear(din, dout, *, device, generator):
    """A Linear whose weight and bias start at zero (adaLN-Zero)."""
    lin = Linear(din, dout, generator=generator, device=device)
    lin.weight.zero_()
    lin.bias.zero_()
    return lin


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_dim: int = 256, *, device,
                 generator):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.freq_dim = freq_dim
        self.fc1 = Linear(freq_dim, hidden_size, **kw)
        self.fc2 = Linear(hidden_size, hidden_size, **kw)

    def forward(self, t):
        h = timestep_embedding(t, self.freq_dim)
        return self.fc2(F.silu(self.fc1(h)))


class LabelEmbedder(nn.Module):
    """Class conditioning with a learned null class (index
    ``num_classes``) for classifier-free guidance."""

    def __init__(self, num_classes: int, hidden_size: int, *, device,
                 generator):
        super().__init__()
        self.num_classes = num_classes
        self.table = Embedding(num_classes + 1, hidden_size,
                               generator=generator, device=device)

    def forward(self, labels, drop_mask=None):
        if drop_mask is not None:      # True -> the null class
            labels = torch.where(drop_mask, self.num_classes, labels)
        return self.table(labels)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


@dataclass
class DiTConfig:
    input_size: int = 32          # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)


def dit_tiny(**overrides) -> DiTConfig:
    base = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_classes=10)
    base.update(overrides)
    return DiTConfig(**base)


def dit_xl_2(**overrides) -> DiTConfig:
    return DiTConfig(**overrides)


def _norm(h, device):
    return LayerNorm(h, epsilon=1e-6, weight_attr=False, bias_attr=False,
                     device=device)


class DiTBlock(nn.Module):
    """adaLN-Zero block: six modulation signals from the conditioning
    vector, its gates starting at zero."""

    def __init__(self, config: DiTConfig, *, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        mlp = int(h * config.mlp_ratio)
        kw = dict(generator=generator, device=device, has_bias=True)
        self.norm1 = _norm(h, device)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                   fused_parts=3, **kw)
        self.proj = RowParallelLinear(h, h, **kw)
        self.norm2 = _norm(h, device)
        self.fc1 = ColumnParallelLinear(h, mlp, gather_output=False, **kw)
        self.fc2 = RowParallelLinear(mlp, h, **kw)
        self.ada = _zero_linear(h, 6 * h, device=device, generator=generator)

    def _attn(self, x):
        cfg = self.config
        b, s, _ = x.shape
        nh, d = local_heads(cfg)[0], cfg.head_dim
        q, k, v = self.qkv(x).reshape(b, s, 3, nh, d).unbind(2)
        out = dense_attention(q, k, v, causal=False)
        return self.proj(out.reshape(b, s, nh * d))

    def forward(self, x, cond):
        sh1, sc1, g1, sh2, sc2, g2 = self.ada(F.silu(cond)).chunk(6, dim=-1)
        x = x + g1[:, None] * self._attn(modulate(self.norm1(x), sh1, sc1))
        h = modulate(self.norm2(x), sh2, sc2)
        return x + g2[:, None] * self.fc2(F.gelu(self.fc1(h),
                                                 approximate=True))


def unpatchify(x, p, c, g):
    """[b, g * g, p * p * c] tokens -> [b, c, g * p, g * p]."""
    b = x.shape[0]
    x = x.reshape(b, g, g, p, p, c)
    return torch.einsum("bhwpqc->bchpwq", x).reshape(b, c, g * p, g * p)


def _embed_patches(conv, pos_embed, latents):
    x = conv(latents)
    b, c = x.shape[:2]
    return x.reshape(b, c, -1).transpose(1, 2) + pos_embed.to(latents.dtype)


class DiT(nn.Module):
    """``forward(latents, timesteps, labels, drop_mask=None)`` -> [b,
    out_channels, H, W]. ``device=None`` means the CUDA card; the weights
    are drawn from ``generator`` (a seed-0 generator on the device when
    not given)."""

    def __init__(self, config: DiTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        p, h = config.patch_size, config.hidden_size
        self.patch_embed = Conv2D(config.in_channels, h, p, stride=p, **kw)
        # the table in fp32 on the CPU, as ``from_pretrained`` computes it
        self.pos_embed = nn.Parameter(
            sincos_pos_embed_2d(config.input_size // p, h).to(device),
            requires_grad=False)
        self.t_embedder = TimestepEmbedder(h, **kw)
        self.y_embedder = LabelEmbedder(config.num_classes, h, **kw)
        self.blocks = LayerList([DiTBlock(config, **kw)
                                 for _ in range(config.num_hidden_layers)])
        self.final_norm = _norm(h, device)
        self.final_ada = _zero_linear(h, 2 * h, **kw)
        self.final_proj = _zero_linear(h, p * p * config.out_channels,
                                       **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def unpatchify(self, x):
        cfg = self.config
        return unpatchify(x, cfg.patch_size, cfg.out_channels,
                          cfg.input_size // cfg.patch_size)

    def forward(self, latents, timesteps, labels, drop_mask=None):
        x = _embed_patches(self.patch_embed, self.pos_embed, latents)
        cond = self.t_embedder(timesteps) + self.y_embedder(labels,
                                                            drop_mask)
        cond = cond.to(x.dtype)
        for block in self.blocks:
            x = block(x, cond)
        sh, sc = self.final_ada(F.silu(cond)).chunk(2, dim=-1)
        x = self.final_proj(modulate(self.final_norm(x), sh, sc))
        return self.unpatchify(x)


# --------------------------------------------------------------- SD3 MMDiT

@dataclass
class MMDiTConfig:
    input_size: int = 64
    patch_size: int = 2
    in_channels: int = 16
    hidden_size: int = 1536
    num_hidden_layers: int = 24
    num_attention_heads: int = 24
    context_dim: int = 4096        # T5/CLIP joint text embedding width
    pooled_dim: int = 2048         # pooled CLIP vector width
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def out_channels(self) -> int:
        return self.in_channels


def mmdit_tiny(**overrides) -> MMDiTConfig:
    base = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=4, context_dim=48,
                pooled_dim=32)
    base.update(overrides)
    return MMDiTConfig(**base)


class _StreamParams(nn.Module):
    """One stream's (image or text) weights in an MMDiT block;
    ``attn_only`` (SD3's context_pre_only) leaves out what the last text
    stream never uses after the attention."""

    def __init__(self, h: int, n_mod: int, attn_only: bool = False, *,
                 device, generator):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = _norm(h, device)
        self.qkv = Linear(h, 3 * h, **kw)
        if not attn_only:
            self.proj = Linear(h, h, **kw)
            self.norm2 = _norm(h, device)
            self.fc1 = Linear(h, 4 * h, **kw)
            self.fc2 = Linear(4 * h, h, **kw)
        self.ada = _zero_linear(h, n_mod * h, **kw)


class MMDiTBlock(nn.Module):
    """The joint block: both streams project q, k and v with their own
    weights, and one attention runs over [text; image]."""

    def __init__(self, config: MMDiTConfig, context_last: bool = False, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.config = config
        self.context_last = context_last
        h = config.hidden_size
        self.img = _StreamParams(h, 6, **kw)
        self.txt = _StreamParams(h, 2 if context_last else 6,
                                 attn_only=context_last, **kw)

    def _qkv(self, stream, x, sh, sc):
        cfg = self.config
        b, s, _ = x.shape
        h = modulate(stream.norm1(x), sh, sc)
        return stream.qkv(h).reshape(b, s, 3, cfg.num_attention_heads,
                                     cfg.head_dim).unbind(2)

    @staticmethod
    def _mlp(stream, x, gate1, attn, sh2, sc2, gate2):
        x = x + gate1[:, None] * stream.proj(attn)
        h = modulate(stream.norm2(x), sh2, sc2)
        return x + gate2[:, None] * stream.fc2(
            F.gelu(stream.fc1(h), approximate=True))

    def forward(self, x_img, x_txt, cond):
        s_txt = x_txt.shape[1]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = \
            self.img.ada(F.silu(cond)).chunk(6, dim=-1)
        mt = self.txt.ada(F.silu(cond))
        if self.context_last:
            t_sh1, t_sc1 = mt.chunk(2, dim=-1)
        else:
            t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = mt.chunk(6, dim=-1)
        qi, ki, vi = self._qkv(self.img, x_img, i_sh1, i_sc1)
        qt, kt, vt = self._qkv(self.txt, x_txt, t_sh1, t_sc1)
        out = dense_attention(torch.cat([qt, qi], dim=1),
                              torch.cat([kt, ki], dim=1),
                              torch.cat([vt, vi], dim=1), causal=False)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        a_txt, a_img = out[:, :s_txt], out[:, s_txt:]
        x_img = self._mlp(self.img, x_img, i_g1, a_img, i_sh2, i_sc2, i_g2)
        if self.context_last:
            return x_img, x_txt
        x_txt = self._mlp(self.txt, x_txt, t_g1, a_txt, t_sh2, t_sc2, t_g2)
        return x_img, x_txt


class MMDiT(nn.Module):
    """SD3's core: conditioned on the timestep and the pooled text vector,
    with the sequence text embedding as the second stream.
    ``forward(latents, timesteps, context, pooled)`` -> [b, c, H, W]."""

    def __init__(self, config: MMDiTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        p, h = config.patch_size, config.hidden_size
        self.patch_embed = Conv2D(config.in_channels, h, p, stride=p, **kw)
        # the table in fp32 on the CPU, as ``from_pretrained`` computes it
        self.pos_embed = nn.Parameter(
            sincos_pos_embed_2d(config.input_size // p, h).to(device),
            requires_grad=False)
        self.t_embedder = TimestepEmbedder(h, **kw)
        self.pooled_proj = Sequential(Linear(config.pooled_dim, h, **kw),
                                      SiLU(), Linear(h, h, **kw))
        self.context_proj = Linear(config.context_dim, h, **kw)
        self.blocks = LayerList(
            [MMDiTBlock(config, i == config.num_hidden_layers - 1, **kw)
             for i in range(config.num_hidden_layers)])
        self.final_norm = _norm(h, device)
        self.final_ada = _zero_linear(h, 2 * h, **kw)
        self.final_proj = _zero_linear(h, p * p * config.out_channels,
                                       **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, latents, timesteps, context, pooled):
        cfg = self.config
        x = _embed_patches(self.patch_embed, self.pos_embed, latents)
        cond = self.t_embedder(timesteps) + self.pooled_proj(pooled.float())
        cond = cond.to(x.dtype)
        txt = self.context_proj(context).to(x.dtype)
        for block in self.blocks:
            x, txt = block(x, txt, cond)
        sh, sc = self.final_ada(F.silu(cond)).chunk(2, dim=-1)
        x = self.final_proj(modulate(self.final_norm(x), sh, sc))
        return unpatchify(x, cfg.patch_size, cfg.out_channels,
                          cfg.input_size // cfg.patch_size)
