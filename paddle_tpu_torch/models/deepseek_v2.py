"""DeepSeek-V2/V3 with Multi-head Latent Attention (counterpart of
``paddle_tpu/models/deepseek_v2.py``).

MLA as the JAX package computes it:

- without a cache (training, a plain forward), the latents expand to
  per-head keys and values and the dense attention runs at q/k head_dim
  ``qk_nope + qk_rope`` (192 at V2-Lite) and v head_dim 128;
- with a cache (``generate``'s prefill and decode steps), the ABSORBED
  form: ``W_uk`` folds into the query, so attention runs against the
  cached latents directly (scores = (q_nope W_uk) . c_kv + q_pe . k_pe,
  out = (probs . c_kv) W_uv). A token costs ``kv_lora_rank +
  qk_rope_head_dim`` cache entries instead of ``2 * heads * head_dim``.
  ``kv_b_proj`` is a ``Linear`` stored [out, in] here, so its weight is
  transposed to the JAX package's [r, h, nope + v] before the split.
- RoPE is DeepSeek's interleaved (complex-pair) convention on the
  decoupled q_pe / single-head k_pe dims, from tables computed once a
  forward; yarn comes from ``llama.yarn_params``.

The latent cache ([b, T, r], [b, T, rope_d] a layer) is written in
place. At a device ``cache_index`` (the graphed decode step, the
speculative cursors) the writes go through ``index_put_`` and the masks
compare key positions with the step's positions on the device, so the
step is captured into a CUDA graph as the Llama step is. The paged
engine's pools hold per-head K/V, not an MLA cache: a ``PagedEngine`` on
this model raises, as the JAX engine does.

The V3 multi-token-prediction depth modules (``DeepseekV3MTP``) serve
``generation.speculative.mtp_speculative_generate`` and the training
objective ``deepseek_mtp_loss``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import RMSNorm
from ..nn import functional as F
from ..nn.common import Linear
from ..ops.attention import dense_attention
from ..distributed.collective import axis_size
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding, copy_to)
from ..parallel.moe import MoEMLP
from ..parallel.sharding import constraint, shard_built
from ..utils.rng import make_generator
from .base import CausalLMBase
from .llama import (LlamaConfig, LlamaMLP, _plain_inv_freq, cache_positions,
                    causal_lm_loss, yarn_get_mscale, yarn_params)


@dataclass
class DeepseekV2Config(LlamaConfig):
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944         # dense layers' FFN width
    # ---- MLA
    q_lora_rank: Optional[int] = None      # None = full q proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # ---- MoE (DeepSeek fine-grained + shared)
    num_experts: int = 64                  # n_routed_experts
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    num_shared_experts: int = 2            # n_shared_experts
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    # group-limited greedy routing (n_group=1: plain greedy)
    n_group: int = 1
    topk_group: int = 1
    # V3 router: sigmoid expert scores + top-2-sum group scores
    scoring: str = "softmax"
    group_score_mode: str = "max"
    # V3 yarn: get_mscale(factor, mscale_all_dim)^2 multiplies the
    # softmax scale (on top of the cos/sin attention factor)
    yarn_mscale_all_in_scale: bool = False
    # yarn context extension (HF rope_scaling dict); None = plain RoPE
    rope_scaling: Optional[Dict[str, Any]] = None
    norm_topk_prob: bool = False           # normalize selected gates to 1
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    # ---- V3 multi-token prediction: D extra depth modules, each
    # predicting one token further ahead (the loss weight is a training
    # hyperparameter of deepseek_mtp_loss)
    num_nextn_predict_layers: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def deepseek_v2_tiny(**overrides) -> DeepseekV2Config:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
                num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=32, num_shared_experts=1,
                first_k_dense_replace=1, max_position_embeddings=128,
                dtype=torch.float32)
    base.update(overrides)
    return DeepseekV2Config(**base)


def interleaved_tables(positions, dim: int, theta: float, inv_freq=None,
                       attention_scaling: float = 1.0):
    """positions [b, s] -> fp32 (cos, sin) [b, s, 1, dim/2] of the
    interleaved RoPE (``inv_freq``/``attention_scaling`` override the
    plain schedule: yarn)."""
    if inv_freq is None:
        inv_freq = _plain_inv_freq(dim, theta)
    ang = positions.float()[..., None] * inv_freq.to(positions.device)
    cos = torch.cos(ang)[:, :, None, :] * attention_scaling
    sin = torch.sin(ang)[:, :, None, :] * attention_scaling
    return cos, sin


def apply_interleaved(x, cos, sin):
    """Rotate pairs (x[2i], x[2i+1]) by the tables, in fp32."""
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def rope_interleaved(x, positions, theta: float, inv_freq=None,
                     attention_scaling: float = 1.0):
    """DeepSeek's complex-pair RoPE: pairs are (x[2i], x[2i+1]) and
    frequencies index i (torch's view_as_complex convention, not
    rotate-half). x [b, s, h, d]; positions [b, s]."""
    return apply_interleaved(x, *interleaved_tables(
        positions, x.shape[-1], theta, inv_freq, attention_scaling))


def _mla_rope(cfg: DeepseekV2Config):
    """(inv_freq fp32 [rope_d / 2], attention factor) of the decoupled
    RoPE dims: yarn when the config has rope_scaling, else plain."""
    if getattr(cfg, "rope_scaling", None):
        return yarn_params(cfg.qk_rope_head_dim, cfg.rope_theta,
                           cfg.rope_scaling, cfg.max_position_embeddings)
    return _plain_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta), 1.0


class _RopeTables(nn.Module):
    """The interleaved RoPE schedule of the decoupled dims, held as an
    fp32 buffer (never cast with the weights, not persistent)."""

    def __init__(self, cfg, device):
        super().__init__()
        inv_freq, self.attn_scaling = _mla_rope(cfg)
        self.theta = cfg.rope_theta
        self.register_buffer("inv_freq",
                             inv_freq.to(device=device, dtype=torch.float32),
                             persistent=False)

    def forward(self, positions):
        return interleaved_tables(positions, 2 * self.inv_freq.numel(),
                                  self.theta, self.inv_freq,
                                  self.attn_scaling)


class MLAttention(nn.Module):
    """Multi-head Latent Attention (reference: DeepseekV2Attention)."""

    def __init__(self, config: DeepseekV2Config, *, device, generator):
        super().__init__()
        self.config = cfg = config
        h = cfg.num_attention_heads
        kw = dict(generator=generator, device=device, dtype=cfg.dtype)
        bias = bool(cfg.attention_bias)
        # the per-head projections stay split over tp (this rank's heads,
        # as o_proj's split input expects); the JAX layer gathers them
        # and lets GSPMD split the heads again
        col = dict(kw, gather_output=False)
        if cfg.q_lora_rank is None:
            self.q_proj = ColumnParallelLinear(
                cfg.hidden_size, h * cfg.qk_head_dim, has_bias=bias, **col)
        else:
            self.q_a_proj = Linear(cfg.hidden_size, cfg.q_lora_rank,
                                   has_bias=bias, **kw)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps,
                                         device=device, dtype=cfg.dtype)
            self.q_b_proj = ColumnParallelLinear(
                cfg.q_lora_rank, h * cfg.qk_head_dim, has_bias=False, **col)
        # the latent and the single decoupled key
        self.kv_a_proj_with_mqa = Linear(
            cfg.hidden_size, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
            has_bias=bias, **kw)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      device=device, dtype=cfg.dtype)
        self.kv_b_proj = ColumnParallelLinear(
            cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            has_bias=False, **col)
        self.o_proj = RowParallelLinear(h * cfg.v_head_dim, cfg.hidden_size,
                                        has_bias=bias, **kw)
        self.scale = cfg.qk_head_dim ** -0.5
        msall = (cfg.rope_scaling or {}).get("mscale_all_dim", 0)
        if cfg.rope_scaling and cfg.yarn_mscale_all_in_scale and msall:
            ms = yarn_get_mscale(cfg.rope_scaling["factor"], msall)
            self.scale = self.scale * ms * ms  # V3 semantics

    def _queries(self, x, rope):
        cfg = self.config
        b, s, _ = x.shape
        if cfg.q_lora_rank is None:
            q = self.q_proj(x)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        q = q.reshape(b, s, -1, cfg.qk_head_dim)      # this rank's heads
        return (q[..., :cfg.qk_nope_head_dim],
                apply_interleaved(q[..., cfg.qk_nope_head_dim:], *rope))

    def _latents(self, x, rope):
        """x -> (c_kv normed [b, s, r], k_pe roped [b, s, rope_d])."""
        r = self.config.kv_lora_rank
        ckv = self.kv_a_proj_with_mqa(x)
        c = self.kv_a_layernorm(ckv[..., :r])
        k_pe = apply_interleaved(ckv[..., r:][:, :, None, :], *rope)[:, :, 0]
        if axis_size("tp") > 1:
            # the one decoupled key serves every head, and a tp rank
            # attends with its own: its gradient sums over tp (the
            # latent's sum is kv_b_proj's)
            k_pe = copy_to(k_pe, "tp")
        return c, k_pe

    def _expand(self, c):
        """latent [b, s, r] -> (k_nope [b, s, h, nope], v [b, s, h, v])."""
        cfg = self.config
        kv = self.kv_b_proj(c).reshape(
            c.shape[0], c.shape[1], -1,
            cfg.qk_nope_head_dim + cfg.v_head_dim)
        return kv[..., :cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]

    def forward(self, x, rope, kv_cache=None, cache_index=None,
                attn_mask=None, attn_start=None, cache_at=None):
        """``rope`` is the (cos, sin) pair of the step's positions. With
        ``kv_cache`` = (latents, k_pe) this step's entries are written in
        place at ``cache_index`` (a Python int, or a device index whose
        ``cache_at`` the model built) and (out, cache) is returned."""
        cfg = self.config
        b, s, _ = x.shape
        nope = cfg.qk_nope_head_dim
        q_nope, q_pe = self._queries(x, rope)
        h = q_nope.shape[2]           # this rank's heads (all, or 1/tp)
        c, k_pe = self._latents(x, rope)

        if kv_cache is not None:
            cc, cpe = kv_cache                   # [b, T, r], [b, T, rope_d]
            if torch.is_tensor(cache_index):
                cc.index_put_(cache_at, c.to(cc.dtype))
                cpe.index_put_(cache_at, k_pe.to(cpe.dtype))
                qpos = cache_at[1][:, None, :, None]          # [b, 1, s, 1]
            else:
                cc[:, cache_index:cache_index + s] = c.to(cc.dtype)
                cpe[:, cache_index:cache_index + s] = k_pe.to(cpe.dtype)
                qpos = cache_index + torch.arange(
                    s, device=x.device)[None, None, :, None]
            T = cc.shape[1]
            # kv_b_proj's weight [h*(nope+v), r] -> the JAX [r, h, nope+v]
            wkv = self.kv_b_proj.weight.t().reshape(
                cfg.kv_lora_rank, h, nope + cfg.v_head_dim)
            w_uk, w_uv = wkv[..., :nope], wkv[..., nope:]
            # ABSORBED: queries project into latent space once, and
            # attention runs over the compressed cache directly
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
            scores = (torch.einsum("bshr,btr->bhst", q_lat, cc)
                      + torch.einsum("bshd,btd->bhst", q_pe, cpe)
                      ).float() * self.scale
            kpos = torch.arange(T, device=x.device)[None, None, None, :]
            keep = kpos <= qpos
            if attn_start is not None:
                # left-padded rows: each row's pad prefix is masked out;
                # pad-prefix queries keep themselves (no all-masked row)
                pad_ok = kpos >= attn_start[:, None, None, None]
                keep = keep & (pad_ok | (kpos == qpos))
            scores = torch.where(keep, scores, torch.full(
                (), float("-inf"), device=x.device))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhst,btr->bshr", probs, cc)
            out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
            out = self.o_proj(out.reshape(b, s, h * cfg.v_head_dim))
            return out, (cc, cpe)
        k_nope, v = self._expand(c)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            b, s, h, cfg.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        out = dense_attention(q, k, v, causal=attn_mask is None,
                              attn_mask=attn_mask, scale=self.scale)
        return self.o_proj(out.reshape(b, s, h * cfg.v_head_dim))


class DeepseekV2DecoderLayer(nn.Module):
    def __init__(self, config: DeepseekV2Config, layer_idx: int, *, device,
                 generator):
        super().__init__()
        self.config = config
        norm = dict(device=device, dtype=config.dtype)
        kw = dict(device=device, generator=generator)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **norm)
        self.self_attn = MLAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **norm)
        self.is_dense = layer_idx < config.first_k_dense_replace
        if self.is_dense:
            self.mlp = LlamaMLP(config, **kw)
        else:
            self.mlp = MoEMLP(
                config.hidden_size, config.moe_intermediate_size,
                num_experts=config.num_experts,
                top_k=config.num_experts_per_tok,
                capacity_factor=config.capacity_factor,
                num_shared_experts=config.num_shared_experts,
                shared_intermediate_size=(config.moe_intermediate_size
                                          * config.num_shared_experts),
                aux_loss_weight=config.aux_loss_weight,
                routed_scaling_factor=config.routed_scaling_factor,
                norm_topk_prob=config.norm_topk_prob,
                n_group=config.n_group, topk_group=config.topk_group,
                scoring=config.scoring,
                group_score_mode=config.group_score_mode,
                dtype=config.dtype, **kw)

    def forward(self, x, rope, kv_cache=None, cache_index=None,
                attn_mask=None, attn_start=None, cache_at=None):
        attn = self.self_attn(self.input_layernorm(x), rope,
                              kv_cache=kv_cache, cache_index=cache_index,
                              attn_mask=attn_mask, attn_start=attn_start,
                              cache_at=cache_at)
        new_cache = None
        if kv_cache is not None:
            attn, new_cache = attn
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        return (x, new_cache) if kv_cache is not None else x


class DeepseekV3MTP(nn.Module):
    """One V3 multi-token-prediction depth module: RMSNorm the previous
    depth's hidden and the (k+1)-shifted token embedding, concatenate,
    project 2h -> h, run one full (MoE) decoder block. The final norm
    lives here; the LM head is the main model's."""

    def __init__(self, config: DeepseekV2Config, *, device, generator):
        super().__init__()
        h = config.hidden_size
        norm = dict(device=device, dtype=config.dtype)
        self.enorm = RMSNorm(h, config.rms_norm_eps, **norm)
        self.hnorm = RMSNorm(h, config.rms_norm_eps, **norm)
        self.eh_proj = Linear(2 * h, h, has_bias=False, generator=generator,
                              device=device, dtype=config.dtype)
        # MTP blocks are MoE in V3 (they sit past first_k_dense_replace)
        self.block = DeepseekV2DecoderLayer(config, config.num_hidden_layers,
                                            device=device,
                                            generator=generator)
        self.norm = RMSNorm(h, config.rms_norm_eps, **norm)
        self.rope = _RopeTables(config, device)

    def forward(self, h_prev, emb_next, positions, attn_mask=None,
                kv_cache=None, cache_index=None):
        """Training path (no cache): the final-normed hidden for the
        shared lm_head. Decode path (``kv_cache`` given, the MTP-as-draft
        speculative decode): ``(normed, pre, new_cache)``, the PRE-norm
        block output being the next chained step's ``h_prev``."""
        x = self.eh_proj(torch.cat([self.hnorm(h_prev),
                                    self.enorm(emb_next)], dim=-1))
        _, cache_at = cache_positions(x[..., 0], positions, cache_index)
        rope = self.rope(positions)
        if kv_cache is not None:
            x, new_cache = self.block(x, rope, kv_cache=kv_cache,
                                      cache_index=cache_index,
                                      attn_mask=attn_mask, cache_at=cache_at)
            return self.norm(x), x, new_cache
        x = self.block(x, rope, attn_mask=attn_mask)
        return self.norm(x)


class DeepseekV2Model(nn.Module):
    def __init__(self, config: DeepseekV2Config, *, device, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, generator=generator,
            device=device, dtype=config.dtype)
        # inside sharded_build each layer is cut to this rank's shards
        # (its heads of the MLA projections, its E / ep experts) as drawn
        self.layers = nn.ModuleList(
            [shard_built(DeepseekV2DecoderLayer(config, i, device=device,
                                                generator=generator))
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=config.dtype)
        self.rope = _RopeTables(config, device)

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, attn_start=None,
                return_prenorm: bool = False):
        positions, cache_at = cache_positions(input_ids, positions,
                                              cache_index, attn_start)
        x = self.embed_tokens(input_ids)
        x = constraint(x, ("dp", "fsdp"), "sp", None)
        rope = self.rope(positions)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, nc = layer(x, rope, kv_cache=kv_caches[i],
                              cache_index=cache_index, attn_mask=attn_mask,
                              attn_start=attn_start, cache_at=cache_at)
                new_caches.append(nc)
            else:
                x = layer(x, rope, attn_mask=attn_mask)
        pre = x  # the MTP modules consume the PRE-final-norm hidden
        x = self.norm(x)
        if return_prenorm:
            return (x, pre, new_caches) if kv_caches is not None \
                else (x, pre)
        return (x, new_caches) if kv_caches is not None else x


class DeepseekV2ForCausalLM(CausalLMBase):
    """``device=None`` means the CUDA card (raises when there is none);
    the weights are drawn from ``generator`` (seed 0 on the device when
    not given)."""

    rows_independent = False            # MoE capacity is per call

    def __init__(self, config: Optional[DeepseekV2Config] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        config = config or DeepseekV2Config()
        device = resolve_device(device)
        generator = generator or make_generator(0, device)
        self.config = config
        kw = dict(device=device, generator=generator)
        self.model = DeepseekV2Model(config, **kw)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            dtype=config.dtype, **kw)
        if config.num_nextn_predict_layers > 0:
            self.mtp = nn.ModuleList(
                [shard_built(DeepseekV3MTP(config, **kw))
                 for _ in range(config.num_nextn_predict_layers)])

    def init_kv_caches(self, batch_size: int, max_len: int, dtype=None):
        """MLA cache: (latents [b, T, kv_lora_rank], k_pe [b, T, rope_d])
        a layer, zeroed on the model's device."""
        return [self.init_mtp_cache(batch_size, max_len, dtype)
                for _ in range(self.config.num_hidden_layers)]

    def init_mtp_cache(self, batch_size: int, max_len: int, dtype=None):
        """One MLA cache (the depth-0 MTP block's, MTP-as-draft)."""
        cfg = self.config
        kw = dict(dtype=dtype or cfg.dtype, device=self.device)
        return (torch.zeros(batch_size, max_len, cfg.kv_lora_rank, **kw),
                torch.zeros(batch_size, max_len, cfg.qk_rope_head_dim, **kw))

    def forward(self, input_ids, positions=None, kv_caches=None,
                cache_index=None, attn_mask=None, attn_start=None,
                return_mtp: bool = False, return_prenorm: bool = False):
        """``return_mtp`` (training-time, no cache): also the list of MTP
        depth logits (depth k's logits[:, i] predict token i+2+k).
        ``return_prenorm`` (with or without caches): also the
        pre-final-norm hidden, which the MTP-as-draft decode feeds to the
        depth modules."""
        if return_mtp:
            if kv_caches is not None:
                raise ValueError("return_mtp is a training-time path "
                                 "(no kv cache)")
            if self.config.num_nextn_predict_layers == 0:
                raise ValueError("config.num_nextn_predict_layers == 0")
            out, pre = self.model(input_ids, positions, attn_mask=attn_mask,
                                  attn_start=attn_start,
                                  return_prenorm=True)
            logits = self.lm_head(out).float()
            b, s = input_ids.shape
            # the MTP blocks see the main stack's positions (left padding
            # shifted) and mask, cut to each depth's length
            if positions is None:
                positions_full = torch.arange(
                    s, device=input_ids.device)[None, :].expand(b, s)
                if attn_start is not None:
                    positions_full = (positions_full
                                      - attn_start[:, None]).clamp_min(0)
            else:
                positions_full = positions
            mtp_logits = []
            h = pre
            for k, mod in enumerate(self.mtp):
                sl = s - 1 - k
                emb = self.model.embed_tokens(input_ids[:, k + 1:])
                am = None if attn_mask is None \
                    else attn_mask[:, :, :sl, :sl]
                h = mod(h[:, :sl], emb, positions_full[:, :sl],
                        attn_mask=am)
                mtp_logits.append(self.lm_head(h).float())
            return logits, mtp_logits
        out = self.model(input_ids, positions, kv_caches, cache_index,
                         attn_mask, attn_start=attn_start,
                         return_prenorm=return_prenorm)
        caches = pre = None
        if kv_caches is not None:
            if return_prenorm:
                out, pre, caches = out
            else:
                out, caches = out
        elif return_prenorm:
            out, pre = out
        logits = self.lm_head(out).float()
        if return_prenorm:
            return (logits, pre, caches) if kv_caches is not None \
                else (logits, pre)
        return (logits, caches) if kv_caches is not None else logits


def deepseek_mtp_loss(logits, mtp_logits, labels, weight: float = 0.1,
                      ignore_index: int = -100):
    """V3 training objective: main next-token CE plus ``weight`` times the
    mean over MTP depths of each depth's CE (depth k's logits[:, i]
    predict token i+2+k)."""
    loss = causal_lm_loss(logits, labels, ignore_index)
    if not mtp_logits:
        return loss
    mtp = torch.zeros((), dtype=torch.float32, device=logits.device)
    for k, ml in enumerate(mtp_logits):
        sl = labels.shape[1] - 2 - k
        mtp = mtp + F.cross_entropy(ml[:, :sl], labels[:, 2 + k:],
                                    ignore_index=ignore_index,
                                    reduction="mean")
    return loss + weight * mtp / len(mtp_logits)
