"""PP-OCR (counterpart of ``paddle_tpu/models/ppocr.py``: ``DBNetConfig``,
``dbnet_tiny``, ``DBFPN``, ``DBHead``, ``DBNet``, ``db_loss``,
``SVTRConfig``, ``svtr_tiny``, ``SVTRMixingBlock``, ``SVTRNet``,
``ctc_rec_loss``, ``ctc_greedy_decode``).

DBNet: a ``ResNet`` backbone's four stages, a top-down FPN (1x1 laterals,
nearest 2x upsample-adds, 3x3 smooths to C/4, all upsampled to 1/4 scale
and concatenated), and two heads (conv-BN-relu, two 2x transposed convs,
a sigmoid) for the probability and threshold maps, binarised
differentiably. ``db_loss``: BCE with hard negatives mined by a
descending sort (the JAX static-shape OHEM), dice on the binary map, L1
on the threshold map. SVTR: a two-conv stem, mixing blocks (Local: a
static additive band mask, a non-persistent buffer; Global: full
attention), height collapsed by a mean, a CTC head. Built in fp32 and
cast whole to ``config.dtype``; the logits are fp32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import (BatchNorm2D, Conv2D, Conv2DTranspose, GELU, LayerList,
                  LayerNorm, Linear, Sequential)
from ..nn import functional as F
from ..nn import initializer as I
from ..ops.attention import dense_attention
from ..utils.rng import make_generator
from .resnet import ResNet, ResNetConfig


# ------------------------------------------------------------------- DBNet

@dataclass
class DBNetConfig:
    backbone: ResNetConfig = field(
        default_factory=lambda: ResNetConfig(depth=18))
    fpn_channels: int = 256
    head_channels: int = 64
    k: float = 50.0               # differentiable-binarization steepness
    dtype: torch.dtype = torch.float32


def dbnet_tiny(**overrides) -> DBNetConfig:
    base = dict(backbone=ResNetConfig(depth=18, stem_width=8,
                                      layers=[1, 1, 1, 1]),
                fpn_channels=16, head_channels=8)
    base.update(overrides)
    return DBNetConfig(**base)


class DBFPN(nn.Module):
    def __init__(self, in_channels: List[int], out_ch: int, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator, bias_attr=False)
        self.lateral = LayerList([Conv2D(c, out_ch, 1, **kw)
                                  for c in in_channels])
        self.smooth = LayerList([Conv2D(out_ch, out_ch // 4, 3, padding=1,
                                        **kw) for _ in in_channels])

    def forward(self, feats):
        lat = [conv(f) for conv, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2,
                                            mode="nearest")
        outs = []
        for i, (conv, f) in enumerate(zip(self.smooth, lat)):
            o = conv(f)
            if i > 0:
                o = F.interpolate(o, scale_factor=2 ** i, mode="nearest")
            outs.append(o)
        return torch.cat(outs, dim=1)


class DBHead(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = Conv2D(in_ch, mid_ch, 3, padding=1, bias_attr=False,
                           **kw)
        self.bn = BatchNorm2D(mid_ch, device=device)
        self.up1 = Conv2DTranspose(mid_ch, mid_ch, 2, stride=2, **kw)
        self.bn1 = BatchNorm2D(mid_ch, device=device)
        self.up2 = Conv2DTranspose(mid_ch, 1, 2, stride=2, **kw)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        x = F.relu(self.bn1(self.up1(x)))
        return F.sigmoid(self.up2(x))


class DBNet(nn.Module):
    """``forward(images)`` -> {"maps": [b, 3, H, W]} (probability,
    threshold, binary). ``device=None`` means the CUDA card."""

    def __init__(self, config: DBNetConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        self.backbone = ResNet(config.backbone, device, generator)
        self.fpn = DBFPN(self.backbone.out_channels, config.fpn_channels,
                         **kw)
        self.prob_head = DBHead(config.fpn_channels, config.head_channels,
                                **kw)
        self.thresh_head = DBHead(config.fpn_channels, config.head_channels,
                                  **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, images):
        fused = self.fpn(self.backbone(images, return_feats=True))
        prob = self.prob_head(fused)
        thresh = self.thresh_head(fused)
        binary = F.sigmoid(self.config.k * (prob - thresh))
        return {"maps": torch.cat([prob, thresh, binary], dim=1)}


def db_loss(pred, shrink_map, shrink_mask, thresh_map, thresh_mask,
            alpha: float = 5.0, beta: float = 10.0, ohem_ratio: float = 3.0):
    """BCE on the shrink map with OHEM (the positives and the hardest
    ``ohem_ratio`` x as many negatives, ranked by a descending sort) +
    ``alpha`` x dice on the binary map + ``beta`` x masked L1 on the
    threshold map; the mean over the batch."""
    maps = pred["maps"].float()
    prob, thresh, binary = maps[:, 0], maps[:, 1], maps[:, 2]
    eps = 1e-6
    bce = -(shrink_map * torch.log(prob + eps)
            + (1 - shrink_map) * torch.log(1 - prob + eps))
    pos = shrink_map * shrink_mask
    neg = (1 - shrink_map) * shrink_mask
    n_pos = pos.sum(dim=(1, 2))
    n_neg_keep = torch.minimum(neg.sum(dim=(1, 2)),
                               n_pos * ohem_ratio).to(torch.int32)
    neg_loss = (bce * neg).reshape(bce.shape[0], -1)
    ranked = torch.sort(neg_loss, dim=1, descending=True).values
    idx = torch.arange(ranked.shape[1], device=ranked.device)[None, :]
    kept = torch.where(idx < n_neg_keep[:, None], ranked,
                       torch.zeros_like(ranked))
    balance_bce = ((bce * pos).sum(dim=(1, 2)) + kept.sum(dim=1)) \
        / (n_pos + n_neg_keep + eps)
    inter = (binary * shrink_map * shrink_mask).sum(dim=(1, 2))
    union = (binary * shrink_mask).sum(dim=(1, 2)) \
        + (shrink_map * shrink_mask).sum(dim=(1, 2))
    dice = 1.0 - 2.0 * inter / (union + eps)
    l1 = ((thresh - thresh_map).abs() * thresh_mask).sum(dim=(1, 2)) \
        / (thresh_mask.sum(dim=(1, 2)) + eps)
    return (balance_bce + alpha * dice + beta * l1).mean()


# -------------------------------------------------------------------- SVTR

@dataclass
class SVTRConfig:
    img_height: int = 32
    img_width: int = 128
    in_channels: int = 3
    hidden_size: int = 96
    num_hidden_layers: int = 6
    num_attention_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 6625       # charset + blank at index 0
    local_window: int = 7
    mixer: List[str] = field(default_factory=list)  # per layer Local/Global
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def svtr_tiny(**overrides) -> SVTRConfig:
    base = dict(img_height=16, img_width=32, hidden_size=24,
                num_hidden_layers=2, num_attention_heads=2, num_classes=40)
    base.update(overrides)
    return SVTRConfig(**base)


class SVTRMixingBlock(nn.Module):
    """Pre-LN block; ``Local`` mixing keeps the keys within
    ``local_window // 2`` tokens (a static additive mask), ``Global``
    attends all."""

    def __init__(self, cfg: SVTRConfig, mixer: str, seq_len: int, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cfg, self.mixer = cfg, mixer
        h = cfg.hidden_size
        mlp = int(h * cfg.mlp_ratio)
        self.norm1 = LayerNorm(h, epsilon=1e-6, device=device)
        self.qkv = Linear(h, 3 * h, **kw)
        self.proj = Linear(h, h, **kw)
        self.norm2 = LayerNorm(h, epsilon=1e-6, device=device)
        self.fc1 = Linear(h, mlp, **kw)
        self.fc2 = Linear(mlp, h, **kw)
        if mixer == "Local":
            idx = torch.arange(seq_len, device=device)
            band = (idx[:, None] - idx[None, :]).abs() <= \
                cfg.local_window // 2
            bias = torch.where(band, 0.0, -1e9)[None, None].float()
            self.register_buffer("local_bias", bias, persistent=False)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        nh, d = cfg.num_attention_heads, cfg.head_dim
        q, k, v = self.qkv(self.norm1(x)).reshape(b, s, 3, nh, d).unbind(2)
        mask = self.local_bias if self.mixer == "Local" else None
        out = dense_attention(q, k, v, causal=False, attn_mask=mask)
        x = x + self.proj(out.reshape(b, s, nh * d))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class SVTRNet(nn.Module):
    """The recognition backbone and CTC head: [b, 3, H, W] -> [b, W / 4,
    num_classes] fp32 logits. ``device=None`` means the CUDA card."""

    def __init__(self, config: SVTRConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        h = config.hidden_size
        self.stem = Sequential(
            Conv2D(config.in_channels, h // 2, 3, stride=2, padding=1, **kw),
            GELU(),
            Conv2D(h // 2, h, 3, stride=2, padding=1, **kw),
            GELU())
        gh, gw = config.img_height // 4, config.img_width // 4
        self.grid = (gh, gw)
        pos = torch.empty(1, gh * gw, h, device=device)
        I.TruncatedNormal(std=0.02)(pos, generator)
        self.pos_embed = nn.Parameter(pos)
        n = config.num_hidden_layers
        mixers = config.mixer or (["Local"] * (n // 2)
                                  + ["Global"] * (n - n // 2))
        self.blocks = LayerList([SVTRMixingBlock(config, m, gh * gw, **kw)
                                 for m in mixers])
        self.norm = LayerNorm(h, epsilon=1e-6, device=device)
        self.head = Linear(h, config.num_classes, **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, images):
        x = self.stem(images)                        # [b, h, gh, gw]
        b, c, gh, gw = x.shape
        x = x.reshape(b, c, gh * gw).transpose(1, 2) \
            + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x).reshape(b, gh, gw, c).mean(dim=1)
        return self.head(x).float()


def ctc_rec_loss(logits, labels, label_lengths=None):
    """The recognition loss: CTC with blank 0."""
    return F.ctc_loss(logits, labels, label_lengths=label_lengths, blank=0)


def ctc_greedy_decode(logits):
    """Best path: argmax, repeats collapsed, blanks dropped. Returns (ids,
    keep), static shapes; ``keep`` marks the surviving positions."""
    ids = logits.argmax(dim=-1)
    prev = torch.nn.functional.pad(ids, (1, 0), value=-1)[:, :-1]
    return ids, (ids != 0) & (ids != prev)
