"""Transformer layers (counterpart of ``paddle_tpu/nn/transformer.py``;
reference: python/paddle/nn/layer/transformer.py).

``MultiHeadAttention`` keeps Paddle's [batch, seq, heads, head_dim]
layout and attends through ``functional.scaled_dot_product_attention``:
without a mask or dropout and at whole 128-row tiles, the flash kernels
(their plain version on CPU tensors), else the dense path with attention
dropout. Each layer takes the port's ``device``, ``dtype`` and
``generator`` keywords: the weights are drawn from the generator, and so
are the layer's dropout masks (one stream for the whole layer, as the
JAX layers share the global ``next_key()``).
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..utils import rng
from . import functional as F
from .layer import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _kw(generator, device, dtype):
    """The build keywords of one layer: its device, dtype and generator
    (the ambient stream's next one on the device when none is given)."""
    device = resolve_device(device)
    return dict(generator=generator or rng.next_generator(device),
                device=device, dtype=dtype)


def _clones(layer: nn.Module, n: int):
    """``layer`` and n - 1 deep copies of it, all drawing their dropout
    masks from ``layer``'s generators (a plain deep copy would copy each
    generator's state, and every copy would draw the same masks)."""
    memo = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}
    return [layer] + [copy.deepcopy(layer, dict(memo))
                      for _ in range(n - 1)]


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        self.generator = kw["generator"]
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """With ``cache`` = (k, v) [b, t, heads, head_dim], this call's K/V
        are appended to it and (out, (k, v)) is returned."""
        key = query if key is None else key
        value = query if value is None else value
        b, sq, _ = query.shape
        nh, d = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(b, sq, nh, d)
        k = self.k_proj(key).reshape(b, key.shape[1], nh, d)
        v = self.v_proj(value).reshape(b, value.shape[1], nh, d)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        p = self.dropout if self.training else 0.0
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=p,
            generator=self.generator if p > 0 else None)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        gen, norm = kw["generator"], dict(device=kw["device"], dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout if attn_dropout is not None
            else dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **norm)
        self.norm2 = LayerNorm(d_model, **norm)
        self.dropout1 = Dropout(dropout, generator=gen)
        self.dropout2 = Dropout(dropout, generator=gen)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout,
            generator=gen)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        x = self.self_attn(x, attn_mask=src_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.act_dropout(self.activation(self.linear1(y))))
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return y


class TransformerEncoder(Layer):
    """``encoder_layer_fn`` is a layer (it and deep copies of it make the
    stack) or a function building one."""

    def __init__(self, encoder_layer_fn, num_layers, norm=None):
        super().__init__()
        if isinstance(encoder_layer_fn, nn.Module):
            layers = _clones(encoder_layer_fn, num_layers)
        else:
            layers = [encoder_layer_fn() for _ in range(num_layers)]
        self.layers = LayerList(layers)
        self.norm = norm

    def forward(self, src, src_mask=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=src_mask)
        if self.norm is not None:
            x = self.norm(x)
        return x


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", normalize_before=False, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        gen, norm = kw["generator"], dict(device=kw["device"], dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **norm)
        self.norm2 = LayerNorm(d_model, **norm)
        self.norm3 = LayerNorm(d_model, **norm)
        self.dropout1 = Dropout(dropout, generator=gen)
        self.dropout2 = Dropout(dropout, generator=gen)
        self.dropout3 = Dropout(dropout, generator=gen)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        x = residual + self.dropout1(self.self_attn(x, attn_mask=tgt_mask))
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = residual + self.dropout2(self.cross_attn(
            y, memory, memory, attn_mask=memory_mask))
        if not self.normalize_before:
            y = self.norm2(y)
        residual = y
        z = self.norm3(y) if self.normalize_before else y
        z = residual + self.dropout3(
            self.linear2(self.activation(self.linear1(z))))
        if not self.normalize_before:
            z = self.norm3(z)
        return z


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer_fn, num_layers, norm=None):
        super().__init__()
        if isinstance(decoder_layer_fn, nn.Module):
            layers = _clones(decoder_layer_fn, num_layers)
        else:
            layers = [decoder_layer_fn() for _ in range(num_layers)]
        self.layers = LayerList(layers)
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        x = tgt
        for layer in self.layers:
            x = layer(x, memory, tgt_mask=tgt_mask, memory_mask=memory_mask)
        if self.norm is not None:
            x = self.norm(x)
        return x


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", normalize_before=False, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        norm = dict(device=kw["device"], dtype=dtype)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before=normalize_before, **kw),
            num_encoder_layers,
            LayerNorm(d_model, **norm) if normalize_before else None)
        self.decoder = TransformerDecoder(
            lambda: TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before, **kw),
            num_decoder_layers,
            LayerNorm(d_model, **norm) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
