"""Llama-3 family (counterpart of ``paddle_tpu/models/llama.py``).

The serving paths of the JAX package, in PyTorch: the static-KV-cache
attention that ``generate()`` drives, the paged KV cache that
``PagedEngine`` drives, and the no-cache forward, which the trainer
differentiates (flash attention through its backward kernels, per-layer
recompute when ``config.recompute`` is on). The branches that belong to
the multi-device slice raise ``NotImplementedError``: ring attention over
a sequence-parallel mesh and the pipeline-parallel train step.

PyTorch idiom inside: ``nn.Module``s with an explicit device and
generator, the RoPE tables computed once per forward in ``LlamaModel``
(the JAX package computes the same tables in every layer), and the KV
caches (static and paged) written in place.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..generation.paged import (PagedKV, paged_chunk_attention,
                                paged_decode_attention, paged_decode_write,
                                paged_prefill_write)
from ..nn import RMSNorm
from ..nn import functional as F
from ..nn.recompute import recompute
from ..ops.attention import (decode_attention, dense_attention,
                             flash_attention, segment_mask, use_flash)
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding, parallel_matmul)
from ..parallel.sharding import constraint
from ..utils.rng import make_generator
from .base import CausalLMBase


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False       # Qwen2 uses biased q/k/v projections
    initializer_range: float = 0.02
    recompute: bool = False
    # recompute policy name (see nn.recompute.POLICIES): "full"
    # rematerializes everything, "dots_saveable" keeps matmul outputs
    recompute_policy: str = "full"
    use_flash_attention: bool = True
    # sliding-window attention (Qwen2/Mistral): each query attends only the
    # trailing `sliding_window` keys; only layers with index >=
    # max_window_layers slide (None = every layer slides)
    sliding_window: Optional[int] = None
    max_window_layers: Optional[int] = None
    # Llama-3.1+ rope_scaling (HF types llama3 / yarn / linear / default)
    rope_scaling: Optional[Dict[str, Any]] = None
    sequence_parallel: bool = False    # ring attention: multi-device slice
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama3_8b(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def llama_tiny(**overrides) -> LlamaConfig:
    """Test-scale config (same code paths as 8B)."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, dtype=torch.float32)
    base.update(overrides)
    return LlamaConfig(**base)


# ------------------------------------------------------------------- RoPE
def _plain_inv_freq(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                         dtype=torch.float32) / head_dim))


def llama3_inv_freq(head_dim: int, theta: float,
                    rope_scaling: Dict[str, Any]) -> torch.Tensor:
    """Llama-3.1 frequency remap: low-frequency bands divide by `factor`,
    high-frequency bands stay, the middle band interpolates smoothly."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    factor = rope_scaling["factor"]
    low_f = rope_scaling["low_freq_factor"]
    high_f = rope_scaling["high_freq_factor"]
    old_ctx = rope_scaling["original_max_position_embeddings"]
    wavelen = 2 * math.pi / inv
    out = np.where(wavelen > old_ctx / low_f, inv / factor, inv)
    smooth = (old_ctx / wavelen - low_f) / (high_f - low_f)
    smoothed = (1 - smooth) * out / factor + smooth * out
    medium = (wavelen >= old_ctx / high_f) & (wavelen <= old_ctx / low_f)
    return torch.from_numpy(np.where(medium, smoothed, out))


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention magnitude factor."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_params(dim: int, theta: float, rope_scaling: Dict[str, Any],
                max_position_embeddings: int):
    """YaRN context extension: per-frequency blend of interpolated and
    extrapolated frequencies over a linear ramp, plus the attention factor
    that scales the cos/sin magnitudes. Returns (inv_freq, factor)."""
    factor = rope_scaling["factor"]
    attention_factor = rope_scaling.get("attention_factor")
    mscale = rope_scaling.get("mscale")
    mscale_all_dim = rope_scaling.get("mscale_all_dim")
    orig = (rope_scaling.get("original_max_position_embeddings")
            or max_position_embeddings)
    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(yarn_get_mscale(factor, mscale)
                                     / yarn_get_mscale(factor,
                                                       mscale_all_dim))
        else:
            attention_factor = yarn_get_mscale(factor)
    beta_fast = rope_scaling.get("beta_fast") or 32
    beta_slow = rope_scaling.get("beta_slow") or 1

    def correction_dim(num_rot):
        return (dim * math.log(orig / (num_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if rope_scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low)
                   / (high - low), 0, 1)
    pos_freqs = theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (factor * pos_freqs)
    extra_factor = 1.0 - ramp
    inv_freq = inv_inter * (1 - extra_factor) + inv_extra * extra_factor
    return torch.from_numpy(np.asarray(inv_freq, np.float32)), \
        float(attention_factor)


ROPE_SCALING_TYPES = ("llama3", "yarn", "linear", "default")


def rope_params_from_scaling(head_dim: int, theta: float,
                             rope_scaling: Optional[Dict[str, Any]],
                             max_position_embeddings: int):
    """HF ``rope_scaling`` dict -> (inv_freq override or None,
    attention_scaling)."""
    if not rope_scaling:
        return None, 1.0
    rtype = rope_scaling.get("rope_type", rope_scaling.get("type",
                                                           "default"))
    if rtype == "default":
        return None, 1.0
    if rtype == "llama3":
        return llama3_inv_freq(head_dim, theta, rope_scaling), 1.0
    if rtype == "yarn":
        return yarn_params(head_dim, theta, rope_scaling,
                           max_position_embeddings)
    if rtype == "linear":
        return _plain_inv_freq(head_dim, theta) / rope_scaling["factor"], 1.0
    raise ValueError(f"rope_scaling type {rtype!r} not supported "
                     f"({'/'.join(ROPE_SCALING_TYPES)} are)")


def rotary_cos_sin(positions, head_dim: int, theta: float, dtype,
                   inv_freq=None, attention_scaling: float = 1.0):
    """positions [b, s] -> (cos, sin) [b, s, 1, head_dim/2]: fp32 angles,
    cast to the activation dtype before rotating (the JAX package's
    rounding point)."""
    if inv_freq is None:
        inv_freq = _plain_inv_freq(head_dim, theta)
    inv_freq = inv_freq.to(positions.device)
    angles = positions.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if attention_scaling != 1.0:
        cos, sin = cos * attention_scaling, sin * attention_scaling
    return cos[:, :, None, :].to(dtype), sin[:, :, None, :].to(dtype)


def apply_rotary(x, cos, sin):
    """x [b, s, h, d]; rotate-half convention (Llama/GPT-NeoX style)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def register_rope(module: nn.Module, config, device):
    """The model's RoPE schedule: ``module.rope_inv_freq`` (an fp32
    buffer, not persistent and never cast with the weights) and
    ``module.attn_scaling``, from the config's ``rope_scaling``."""
    inv_freq, module.attn_scaling = rope_params_from_scaling(
        config.head_dim, config.rope_theta, config.rope_scaling,
        config.max_position_embeddings)
    if inv_freq is None:
        inv_freq = _plain_inv_freq(config.head_dim, config.rope_theta)
    module.register_buffer("rope_inv_freq",
                           inv_freq.to(device=device, dtype=torch.float32),
                           persistent=False)


def cache_positions(input_ids, positions=None, cache_index=None,
                    attn_start=None):
    """(positions [b, s], cache_at) of a forward over ``input_ids`` [b,
    s]: the positions given, or ``cache_index + arange(s)`` (left-padded
    rows start at their first real token); ``cache_at`` is None, or for
    a device ``cache_index`` (one index or one a row) the (rows [b, 1],
    positions [b, s]) index pair this step's K/V land at, built once for
    every layer."""
    b, s = input_ids.shape
    cache_at = None
    if torch.is_tensor(cache_index):
        dev = input_ids.device
        at = (cache_index.reshape(-1, 1).long()
              + torch.arange(s, device=dev)[None, :]).expand(b, s)
        cache_at = (torch.arange(b, device=dev)[:, None], at)
    if positions is None:
        if cache_at is not None:
            positions = cache_at[1]
        else:
            start = cache_index if cache_index is not None else 0
            positions = start + torch.arange(
                s, device=input_ids.device)[None, :].expand(b, s)
        if attn_start is not None:
            # left-padded rows: RoPE position 0 sits at each row's first
            # real token, not at the pad prefix
            positions = (positions - attn_start[:, None]).clamp_min(0)
    return positions, cache_at


# -------------------------------------------------------------- components
class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, layer_idx: int = 0, *,
                 device, generator):
        super().__init__()
        if config.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel (ring attention over the sp mesh axis) "
                "comes with the multi-device slice of the port")
        self.config = config
        mwl = config.max_window_layers
        # HF-Qwen2 semantics: the window applies from max_window_layers on
        self.window = (config.sliding_window
                       if config.sliding_window is not None
                       and (mwl is None or layer_idx >= mwl) else None)
        h, kv, d = (config.num_attention_heads,
                    config.num_key_value_heads, config.head_dim)
        kw = dict(generator=generator, device=device, dtype=config.dtype)
        bias = config.attention_bias
        self.q_proj = ColumnParallelLinear(config.hidden_size, h * d,
                                           has_bias=bias, **kw)
        self.k_proj = ColumnParallelLinear(config.hidden_size, kv * d,
                                           has_bias=bias, **kw)
        self.v_proj = ColumnParallelLinear(config.hidden_size, kv * d,
                                           has_bias=bias, **kw)
        self.o_proj = RowParallelLinear(h * d, config.hidden_size,
                                        has_bias=False, **kw)

    def forward(self, x, rope, kv_cache=None, cache_index=None,
                attn_mask=None, attn_start=None, segment_ids=None,
                positions=None, paged_chunk: bool = False,
                paged_decode: bool = False, cache_at=None):
        """``rope`` is the (cos, sin) pair of :func:`rotary_cos_sin`.

        With ``kv_cache`` a :class:`PagedKV` (the paged engine), this
        step's K/V are written into the pools in place and (out, cache) is
        returned. s == 1 (or ``paged_decode`` at any s, multi-query rows)
        attends each row's blocks through the ragged paged kernel; a
        chunk (``paged_chunk``, ``positions`` [1, s] global) attends over
        its row's earlier chunks too; a whole prompt is causal attention
        over itself (its pad tail lands in the garbage block).

        With ``kv_cache`` = (k, v) [b, T, kv, d] tensors, this step's K/V
        are written into the cache IN PLACE at ``cache_index`` (the JAX
        package returns an updated copy through ``dynamic_update_slice``),
        and (out, (k, v)) is returned. ``cache_index`` is a Python int, or
        an integer tensor on the device of one index or one a row, read
        nowhere on the host (a captured decode step replays at whatever
        index it holds); then ``cache_at`` is the (rows [b, 1], positions
        [b, s]) index pair the model built from it, where the K/V land."""
        cfg = self.config
        b, s, _ = x.shape
        nh, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        q = self.q_proj(x).reshape(b, s, nh, d)
        k = self.k_proj(x).reshape(b, s, kvh, d)
        v = self.v_proj(x).reshape(b, s, kvh, d)
        cos, sin = rope
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)

        if isinstance(kv_cache, PagedKV):
            if s == 1 or paged_decode:
                cache = paged_decode_write(kv_cache, k, v)
                out = paged_decode_attention(q, cache, window=self.window)
            elif paged_chunk:
                cache = paged_prefill_write(kv_cache, k, v,
                                            positions=positions[0])
                out = paged_chunk_attention(q, cache, positions,
                                            window=self.window)
            else:
                cache = paged_prefill_write(kv_cache, k, v)
                out = dense_attention(q, k, v, causal=True,
                                      window=self.window)
            return self.o_proj(out.reshape(b, s, nh * d)), cache

        if kv_cache is not None:
            ck, cv = kv_cache
            on_device = torch.is_tensor(cache_index)
            if on_device:
                ck.index_put_(cache_at, k.to(ck.dtype))
                cv.index_put_(cache_at, v.to(cv.dtype))
            else:
                cache_index = operator.index(cache_index)
                ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
                cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
            if s == 1 and attn_start is None:
                # single-token decode: GQA-native decode kernel (at a
                # device index, the kernel reads it on the device)
                out = decode_attention(q, ck, cv, cache_index,
                                       window=self.window)
            elif not on_device and cache_index == 0 and attn_start is None \
                    and cfg.use_flash_attention \
                    and use_flash(q, k, None, 0.0):
                # prefill at cache start: nothing earlier in the cache can
                # be attended, so this is causal attention over the prompt.
                # K/V go through the cache dtype so prefill numerics match
                # what decode steps read back
                out = flash_attention(q, k.to(ck.dtype), v.to(cv.dtype),
                                      causal=True, window=self.window)
            else:
                # prefill-with-cache, left-padded batches and multi-token
                # steps at a device index (the speculative verify): mask
                # positions beyond each query's own; with attn_start, also
                # mask each row's pad prefix out of the cache
                total = ck.shape[1]
                kpos = torch.arange(total, device=x.device)[None, None, :]
                if on_device:
                    qpos = cache_at[1][:, :, None]              # [b, s, 1]
                else:
                    qpos = cache_index + torch.arange(
                        s, device=x.device)[None, :, None]      # [1, s, 1]
                mask = kpos <= qpos
                if self.window is not None:
                    mask = mask & (qpos - kpos < self.window)
                if attn_start is not None:
                    pad_ok = kpos >= attn_start[:, None, None]
                    # pad-prefix queries keep their own position: an
                    # all-masked softmax row is NaN, and the NaN would
                    # re-enter real rows in the next layer as 0 * NaN
                    mask = mask & (pad_ok | (kpos == qpos))
                out = dense_attention(q, ck, cv, attn_mask=mask[:, None])
            out = self.o_proj(out.reshape(b, s, nh * d))
            return out, (ck, cv)

        if cfg.use_flash_attention and attn_mask is None \
                and use_flash(q, k, None, 0.0):
            out = flash_attention(q, k, v, causal=True,
                                  segment_ids=segment_ids,
                                  window=self.window)
        elif segment_ids is not None and attn_mask is None:
            out = dense_attention(q, k, v, causal=True,
                                  attn_mask=segment_mask(segment_ids),
                                  window=self.window)
        elif self.window is not None:
            # an explicit mask combines with the window band
            out = dense_attention(q, k, v, causal=True,
                                  attn_mask=attn_mask, window=self.window)
        else:
            out = dense_attention(q, k, v, causal=attn_mask is None,
                                  attn_mask=attn_mask)
        return self.o_proj(out.reshape(b, s, nh * d))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, generator):
        super().__init__()
        kw = dict(has_bias=False, generator=generator, device=device,
                  dtype=config.dtype)
        self.gate_proj = ColumnParallelLinear(config.hidden_size,
                                              config.intermediate_size, **kw)
        self.up_proj = ColumnParallelLinear(config.hidden_size,
                                            config.intermediate_size, **kw)
        self.down_proj = RowParallelLinear(config.intermediate_size,
                                           config.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, layer_idx: int = 0, *,
                 device, generator):
        super().__init__()
        self.config = config
        norm = dict(device=device, dtype=config.dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **norm)
        self.self_attn = LlamaAttention(config, layer_idx, device=device,
                                        generator=generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **norm)
        self.mlp = LlamaMLP(config, device=device, generator=generator)

    def forward(self, x, rope, kv_cache=None, cache_index=None,
                attn_mask=None, attn_start=None, segment_ids=None,
                positions=None, paged_chunk: bool = False,
                paged_decode: bool = False, cache_at=None):
        attn_out = self.self_attn(self.input_layernorm(x), rope,
                                  kv_cache=kv_cache, cache_index=cache_index,
                                  attn_mask=attn_mask, attn_start=attn_start,
                                  segment_ids=segment_ids,
                                  positions=positions,
                                  paged_chunk=paged_chunk,
                                  paged_decode=paged_decode,
                                  cache_at=cache_at)
        new_cache = None
        if kv_cache is not None:
            attn_out, new_cache = attn_out
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        return (x, new_cache) if kv_cache is not None else x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator,
            device=device, dtype=config.dtype)
        with torch.no_grad():
            self.embed_tokens.weight.mul_(config.initializer_range / 0.02)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, i, device=device, generator=generator)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=config.dtype)
        register_rope(self, config, device)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, attn_start=None,
                segment_ids=None, paged_chunk: bool = False,
                paged_decode: bool = False):
        cfg = self.config
        positions, cache_at = cache_positions(input_ids, positions,
                                              cache_index, attn_start)
        x = self.embed_tokens(input_ids)
        rope = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                              x.dtype, inv_freq=self.rope_inv_freq,
                              attention_scaling=self.attn_scaling)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if cfg.recompute and kv_caches is None:
                # per-layer activation recompute: the backward replays
                # the layer's forward instead of keeping its activations
                x = recompute(
                    lambda h, lyr=layer: lyr(h, rope, attn_mask=attn_mask,
                                             segment_ids=segment_ids),
                    x, policy=cfg.recompute_policy)
                continue
            out = layer(x, rope,
                        kv_cache=kv_caches[i] if kv_caches is not None
                        else None,
                        cache_index=cache_index, attn_mask=attn_mask,
                        attn_start=attn_start, segment_ids=segment_ids,
                        positions=positions, paged_chunk=paged_chunk,
                        paged_decode=paged_decode, cache_at=cache_at)
            if kv_caches is not None:
                x, cache = out
                new_caches.append(cache)
            else:
                x = out
        x = self.norm(x)
        return (x, new_caches) if kv_caches is not None else x


class LlamaForCausalLM(CausalLMBase):
    """Llama causal LM. ``device=None`` means the CUDA card (raises when
    there is none); the weights are drawn from ``generator`` (a fresh
    seed-0 generator on the device when not given)."""

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        self.model = LlamaModel(config, device=device, generator=generator)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                generator=generator, device=device, dtype=config.dtype)

    def pipeline_functional(self, pp: int, logits_loss=None, vpp: int = 1):
        raise NotImplementedError(
            "the pipeline-parallel train step (llama_pipeline_functional) "
            "comes with the multi-device training slice of the port")

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, attn_start=None,
                segment_ids=None, paged_chunk: bool = False,
                paged_decode: bool = False):
        out = self.model(input_ids, positions, kv_caches, cache_index,
                         attn_mask, attn_start, segment_ids=segment_ids,
                         paged_chunk=paged_chunk, paged_decode=paged_decode)
        caches = None
        if kv_caches is not None:
            out, caches = out
        if self.config.tie_word_embeddings:
            logits = parallel_matmul(out, self.model.embed_tokens.weight,
                                     transpose_y=True)
        else:
            logits = self.lm_head(out)
        logits = logits.float()
        return (logits, caches) if kv_caches is not None else logits


def causal_lm_loss(logits, labels, ignore_index: int = -100):
    """Shifted next-token cross entropy: logits [b, s, v], labels [b, s]
    (the token ids themselves in the default recipe)."""
    return F.cross_entropy(logits[:, :-1], labels[:, 1:],
                           ignore_index=ignore_index, reduction="mean")
