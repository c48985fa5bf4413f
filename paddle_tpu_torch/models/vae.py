"""AutoencoderKL, the SD latent VAE (counterpart of
``paddle_tpu/models/vae.py``: ``VAEConfig``, ``vae_tiny``, ``ResnetBlock``,
``AttnBlock``, ``Downsample``, ``Upsample``, ``Encoder``, ``Decoder``,
``DiagonalGaussian``, ``AutoencoderKL``, ``vae_loss``).

GroupNorm + SiLU resnet stacks, a mid-block attention of one head over the
H x W tokens (head_dim = the channels; dense, as the JAX module's), 2x
nearest upsampling (the JAX resize's half-pixel nearest, which at an
integer scale repeats each pixel), a diagonal-Gaussian posterior, and the
quant convs of the SD1/2 layout. ``DiagonalGaussian.sample`` draws from a
``torch.Generator`` where the JAX one takes a key. Built in fp32 and cast
whole to ``config.dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import Conv2D, GroupNorm, Linear, Sequential
from ..nn import functional as F
from ..ops.attention import dense_attention
from ..utils.rng import make_generator


@dataclass
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_multipliers: List[int] = field(
        default_factory=lambda: [1, 2, 4, 4])
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215   # SD1/2 latent scale
    dtype: torch.dtype = torch.float32


def vae_tiny(**overrides) -> VAEConfig:
    base = dict(base_channels=16, channel_multipliers=[1, 2],
                layers_per_block=1, norm_groups=4, latent_channels=4)
    base.update(overrides)
    return VAEConfig(**base)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = GroupNorm(groups, in_ch, device=device)
        self.conv1 = Conv2D(in_ch, out_ch, 3, padding=1, **kw)
        self.norm2 = GroupNorm(groups, out_ch, device=device)
        self.conv2 = Conv2D(out_ch, out_ch, 3, padding=1, **kw)
        self.short = Conv2D(in_ch, out_ch, 1, **kw) if in_ch != out_ch \
            else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        s = self.short(x) if self.short is not None else x
        return s + h


class AttnBlock(nn.Module):
    """One-head spatial self-attention over the H x W tokens."""

    def __init__(self, channels: int, groups: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm = GroupNorm(groups, channels, device=device)
        self.qkv = Linear(channels, 3 * channels, **kw)
        self.proj = Linear(channels, channels, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.qkv(t).reshape(b, h * w, 3, 1, c).unbind(2)
        out = self.proj(dense_attention(q, k, v, causal=False)
                        .reshape(b, h * w, c))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int, *, device, generator):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1,
                           device=device, generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, *, device, generator):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, padding=1, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _mid(ch, g, kw):
    return Sequential(ResnetBlock(ch, ch, g, **kw), AttnBlock(ch, g, **kw),
                      ResnetBlock(ch, ch, g, **kw))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        g, ch = cfg.norm_groups, cfg.base_channels
        self.conv_in = Conv2D(cfg.in_channels, ch, 3, padding=1, **kw)
        downs = []
        in_ch = ch
        for i, mult in enumerate(cfg.channel_multipliers):
            out_ch = ch * mult
            for _ in range(cfg.layers_per_block):
                downs.append(ResnetBlock(in_ch, out_ch, g, **kw))
                in_ch = out_ch
            if i != len(cfg.channel_multipliers) - 1:
                downs.append(Downsample(in_ch, **kw))
        self.down = Sequential(*downs)
        self.mid = _mid(in_ch, g, kw)
        self.norm_out = GroupNorm(g, in_ch, device=device)
        self.conv_out = Conv2D(in_ch, 2 * cfg.latent_channels, 3, padding=1,
                               **kw)

    def forward(self, x):
        h = self.mid(self.down(self.conv_in(x)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        g, ch = cfg.norm_groups, cfg.base_channels
        in_ch = ch * cfg.channel_multipliers[-1]
        self.conv_in = Conv2D(cfg.latent_channels, in_ch, 3, padding=1, **kw)
        self.mid = _mid(in_ch, g, kw)
        ups = []
        for i, mult in enumerate(reversed(cfg.channel_multipliers)):
            out_ch = ch * mult
            for _ in range(cfg.layers_per_block + 1):
                ups.append(ResnetBlock(in_ch, out_ch, g, **kw))
                in_ch = out_ch
            if i != len(cfg.channel_multipliers) - 1:
                ups.append(Upsample(in_ch, **kw))
        self.up = Sequential(*ups)
        self.norm_out = GroupNorm(g, in_ch, device=device)
        self.conv_out = Conv2D(in_ch, cfg.in_channels, 3, padding=1, **kw)

    def forward(self, z):
        h = self.up(self.mid(self.conv_in(z)))
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """The posterior q(z | x), its moments split from the encoder's
    output."""

    def __init__(self, moments):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator):
        return self.mean + self.std * torch.randn(
            self.mean.shape, generator=generator, dtype=self.mean.dtype,
            device=self.mean.device)

    def kl(self):
        return 0.5 * (self.mean.square() + torch.exp(self.logvar) - 1.0
                      - self.logvar).sum(dim=(1, 2, 3))

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    """``encode(x)`` -> ``DiagonalGaussian``; ``decode(z)`` -> images;
    ``forward(x, generator=None)`` -> (reconstruction, posterior), a
    sample of the posterior with ``generator``, its mode without.
    ``device=None`` means the CUDA card."""

    def __init__(self, config: VAEConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        self.encoder = Encoder(config, **kw)
        self.decoder = Decoder(config, **kw)
        zc = config.latent_channels
        self.quant_conv = Conv2D(2 * zc, 2 * zc, 1, **kw)
        self.post_quant_conv = Conv2D(zc, zc, 1, **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def encode(self, x) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        posterior = self.encode(x)
        z = posterior.sample(generator) if generator is not None \
            else posterior.mode()
        return self.decode(z), posterior


def vae_loss(recon, x, posterior: DiagonalGaussian, kl_weight: float = 1e-6):
    rec = (recon.float() - x.float()).abs().mean()
    return rec + kl_weight * posterior.kl().mean()
