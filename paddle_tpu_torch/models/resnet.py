"""ResNet family (counterpart of ``paddle_tpu/models/resnet.py``:
``ConvBNLayer``, ``BasicBlock``, ``BottleneckBlock``, ``ResNetConfig``,
``ResNet``, ``resnet18``, ``resnet34``, ``resnet50``, ``resnet50_vd``,
``resnet_tiny``).

PaddleClas's ResNet vB (the stride on the 3x3) and vD (a deep stem of
three 3x3 convs, and an average pool before the 1x1 of a strided
projection shortcut). Every conv is followed by ``BatchNorm2D``, whose
running statistics move in an eager train-mode forward and stay under the
``Trainer``, as in the JAX package (``nn/norm.py``). ``forward(x,
return_feats=True)`` gives the four stages' feature maps (DBNet's FPN
reads them). The model is built in fp32 and cast whole to
``config.dtype``, head included, as the JAX model is; its logits are fp32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import (AvgPool2D, BatchNorm2D, Conv2D, LayerList, Linear,
                  MaxPool2D, Sequential)
from ..nn import functional as F
from ..utils.rng import make_generator


class ConvBNLayer(nn.Module):
    """conv -> BN -> optional relu; with ``avg_first`` (the vD shortcut) a
    2x2 average pool takes the stride before an unstrided conv."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, groups=1,
                 act=None, avg_first=False, *, device, generator):
        super().__init__()
        self.avg_first = avg_first
        if avg_first:
            self.pool = AvgPool2D(2, stride=2, padding=0)
            stride = 1
        self.conv = Conv2D(in_ch, out_ch, kernel_size, stride=stride,
                           padding=(kernel_size - 1) // 2, groups=groups,
                           bias_attr=False, generator=generator,
                           device=device)
        self.bn = BatchNorm2D(out_ch, device=device)
        self.act = act

    def forward(self, x):
        if self.avg_first:
            x = self.pool(x)
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act == "relu" else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, out_ch, stride=1, shortcut=True, variant="b",
                 *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv0 = ConvBNLayer(in_ch, out_ch, 3, stride=stride, act="relu",
                                 **kw)
        self.conv1 = ConvBNLayer(out_ch, out_ch, 3, act=None, **kw)
        self.shortcut = shortcut
        if not shortcut:
            self.short = ConvBNLayer(
                in_ch, out_ch, 1, stride=stride,
                avg_first=(variant == "d" and stride > 1), **kw)

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        s = x if self.shortcut else self.short(x)
        return F.relu(y + s)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, out_ch, stride=1, shortcut=True, variant="b",
                 *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv0 = ConvBNLayer(in_ch, out_ch, 1, act="relu", **kw)
        self.conv1 = ConvBNLayer(out_ch, out_ch, 3, stride=stride,
                                 act="relu", **kw)
        self.conv2 = ConvBNLayer(out_ch, out_ch * 4, 1, act=None, **kw)
        self.shortcut = shortcut
        if not shortcut:
            self.short = ConvBNLayer(
                in_ch, out_ch * 4, 1, stride=stride,
                avg_first=(variant == "d" and stride > 1), **kw)

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        s = x if self.shortcut else self.short(x)
        return F.relu(y + s)


_DEPTH_CFG = {18: ([2, 2, 2, 2], BasicBlock),
              34: ([3, 4, 6, 3], BasicBlock),
              50: ([3, 4, 6, 3], BottleneckBlock),
              101: ([3, 4, 23, 3], BottleneckBlock),
              152: ([3, 8, 36, 3], BottleneckBlock)}


@dataclass
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    variant: str = "b"           # "b" classic, "d" PP-ResNet-vD
    in_channels: int = 3
    stem_width: int = 64
    dtype: torch.dtype = torch.float32
    layers: List[int] = field(default_factory=list)

    def block_plan(self):
        blocks, cls = _DEPTH_CFG[self.depth]
        return (self.layers or blocks), cls


class ResNet(nn.Module):
    """Backbone and classifier head. ``device=None`` means the CUDA card;
    the weights are drawn from ``generator`` (a seed-0 generator on the
    device when not given)."""

    def __init__(self, config: ResNetConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.config = config
        blocks, block_cls = config.block_plan()
        w = config.stem_width
        if config.variant == "d":   # the deep stem: three 3x3s
            self.stem = Sequential(
                ConvBNLayer(config.in_channels, w // 2, 3, stride=2,
                            act="relu", **kw),
                ConvBNLayer(w // 2, w // 2, 3, act="relu", **kw),
                ConvBNLayer(w // 2, w, 3, act="relu", **kw))
        else:
            self.stem = ConvBNLayer(config.in_channels, w, 7, stride=2,
                                    act="relu", **kw)
        self.pool = MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_ch = w
        for stage_idx, num_blocks in enumerate(blocks):
            out_ch = w * (2 ** stage_idx)
            stage = []
            for i in range(num_blocks):
                stride = 2 if stage_idx > 0 and i == 0 else 1
                # an identity shortcut iff the shapes already line up
                shortcut = (in_ch == out_ch * block_cls.expansion
                            and stride == 1)
                stage.append(block_cls(in_ch, out_ch, stride=stride,
                                       shortcut=shortcut,
                                       variant=config.variant, **kw))
                in_ch = out_ch * block_cls.expansion
            stages.append(Sequential(*stage))
        self.stages = LayerList(stages)
        self.out_channels = [w * (2 ** i) * block_cls.expansion
                             for i in range(len(blocks))]
        self.head = Linear(in_ch, config.num_classes, **kw)
        if config.dtype != torch.float32:
            self.to(dtype=config.dtype)

    def forward(self, x, return_feats: bool = False):
        x = self.pool(self.stem(x))
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        if return_feats:
            return feats
        x = F.global_avg_pool2d(x).reshape(x.shape[0], -1)
        return self.head(x).float()


def resnet18(device=None, generator=None, **kw) -> ResNet:
    return ResNet(ResNetConfig(depth=18, **kw), device, generator)


def resnet34(device=None, generator=None, **kw) -> ResNet:
    return ResNet(ResNetConfig(depth=34, **kw), device, generator)


def resnet50(device=None, generator=None, **kw) -> ResNet:
    return ResNet(ResNetConfig(depth=50, **kw), device, generator)


def resnet50_vd(device=None, generator=None, **kw) -> ResNet:
    return ResNet(ResNetConfig(depth=50, variant="d", **kw), device,
                  generator)


def resnet_tiny(**overrides) -> ResNetConfig:
    base = dict(depth=18, num_classes=10, stem_width=16,
                layers=[1, 1, 1, 1], dtype=torch.float32)
    base.update(overrides)
    return ResNetConfig(**base)
