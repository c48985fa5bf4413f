"""Pretrained-weight interop: HF safetensors checkpoints into the port
(counterpart of ``paddle_tpu/models/hf_interop.py``'s decoder LMs:
``iter_hf_checkpoint_shards``, ``load_hf_checkpoint``,
``_convert_llama``, ``_revert_llama``, ``_convert_qwen2_moe``,
``_convert_deepseek_v2``, ``convert_hf_state_dict``,
``to_hf_state_dict``, ``config_from_hf`` and ``from_pretrained``).

Model types: ``llama``, ``qwen2``, ``ernie4_5``, ``qwen2_moe``,
``ernie4_5_moe``, ``deepseek_v2`` and ``deepseek_v3``. The converters
work on numpy arrays in the JAX package's layout (every 2-D linear
weight [in, out], HF's transposed; the experts stacked [E, in, out]), so
a checkpoint converts to exactly what the JAX package converts it to;
``from_pretrained`` then copies it into the port's modules as
``load_jax_state_dict`` does (the port's ``Linear`` keeps HF's [out,
in]), one shard at a time, experts included.

The safetensors layout is read here, without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}`` and the raw little-endian
tensors. BF16 tensors come back as float32 numpy arrays (numpy has no
bf16 type; the JAX package's reader gives ml_dtypes' bf16, or float32
through torch, by the ``safetensors`` version), every other dtype as
itself, with the JAX reader's values. ``from_pretrained`` reads each
file through a memory map, one tensor (on a tp mesh, one rank's slice
of it: a column shard is contiguous rows, a row shard strided) at a
time.

The encoder and vision families' converters come with their models.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["load_hf_checkpoint", "iter_hf_checkpoint_shards",
           "convert_hf_state_dict", "to_hf_state_dict", "from_pretrained",
           "config_from_hf"]

_NUMPY_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                 "I64": np.int64, "I32": np.int32, "I16": np.int16,
                 "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


class _FileArray:
    """One tensor of a ``.safetensors`` file, read only where indexed:
    ``a[idx]`` (basic indexing) reads those elements from the file's
    memory map and returns a numpy array of its own (BF16 widened to
    float32, bit for bit); ``a.T`` is a 2-D tensor's transposed view;
    ``np.asarray(a)`` reads it whole."""

    def __init__(self, raw: np.ndarray, bf16: bool, transposed=False):
        self._raw, self._bf16, self._t = raw, bf16, transposed
        self.shape = tuple(reversed(raw.shape)) if transposed \
            else tuple(raw.shape)
        self.ndim = len(self.shape)
        self.dtype = np.dtype(np.float32) if bf16 else raw.dtype

    @property
    def T(self) -> "_FileArray":
        if self.ndim != 2:
            raise ValueError(f"transposed view of a {self.ndim}-D tensor")
        return _FileArray(self._raw, self._bf16, not self._t)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if self._t:
            idx = tuple(reversed(idx + (slice(None),) * (2 - len(idx))))
        out = np.array(self._raw[idx])
        if self._bf16:
            out = (out.astype(np.uint32) << 16).view(np.float32)
        return out.T if self._t else out

    def __array__(self, dtype=None, copy=None):
        out = self[tuple(slice(None) for _ in self.shape)]
        return out if dtype is None else out.astype(dtype)

    def reshape(self, *shape):
        return np.asarray(self).reshape(*shape)


def _open_safetensors_file(path: str) -> Dict[str, "_FileArray"]:
    """{name: :class:`_FileArray`} over one ``.safetensors`` file's
    memory map (nothing read yet)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    size = os.path.getsize(path) - 8 - n
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n,
                     shape=(size,)) if size else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        bf16 = info["dtype"] == "BF16"
        if bf16:
            dt = np.dtype("<u2")
        elif info["dtype"] in _NUMPY_DTYPES:
            dt = np.dtype(_NUMPY_DTYPES[info["dtype"]]).newbyteorder("<")
        else:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which is not read here")
        out[name] = _FileArray(data[lo:hi].view(dt).reshape(shape), bf16)
    return out


def _load_safetensors_file(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of one ``.safetensors`` file (BF16 as float32)."""
    return {k: np.asarray(v) for k, v in
            _open_safetensors_file(path).items()}


def _checkpoint_files(model_dir: str):
    """The checkpoint's files in load order: safetensors shards by the
    index, a single ``model.safetensors``, or ``pytorch_model.bin``."""
    idx = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(model_dir, shard)
                for shard in sorted(set(weight_map.values()))]
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return [path]
    raise FileNotFoundError(f"no safetensors/bin checkpoint in {model_dir}")


def _iter_checkpoint(model_dir: str, read) -> Iterator[Dict[str, Any]]:
    """Each file's tensors: ``read(path)`` of a safetensors file, every
    tensor of a ``.bin`` as float32 numpy."""
    for path in _checkpoint_files(model_dir):
        if path.endswith(".bin"):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            yield {k: v.float().numpy() for k, v in sd.items()}
        else:
            yield read(path)


def iter_hf_checkpoint_shards(
        model_dir: str) -> Iterator[Dict[str, np.ndarray]]:
    """Yield tensors shard by shard, so the caller converts and places
    each and lets it go before the next loads (host peak: one shard)."""
    return _iter_checkpoint(model_dir, _load_safetensors_file)


def load_hf_checkpoint(model_dir: str) -> Dict[str, np.ndarray]:
    """Every tensor of the checkpoint in one dict."""
    out: Dict[str, np.ndarray] = {}
    for shard in iter_hf_checkpoint_shards(model_dir):
        out.update(shard)
    return out


_LLAMA_LINEAR = re.compile(
    r"(self_attn\.(q|k|v|o)_proj|mlp\.(gate|up|down)_proj)\.weight$")


def _convert_llama(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """Llama / Qwen2 / ERNIE-4.5: the names already match, only the
    linear layout differs ([out, in] -> [in, out]). Per key, so it works
    one shard at a time."""
    out = {}
    for k, v in hf.items():
        if k.endswith("rotary_emb.inv_freq"):
            continue  # RoPE is computed from the config
        if k == "lm_head.weight" or _LLAMA_LINEAR.search(k):
            v = v.T
        if k == "lm_head.weight" and getattr(cfg, "tie_word_embeddings",
                                             False):
            continue
        out[k] = v
    return out


def _revert_llama(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k == "lm_head.weight" or _LLAMA_LINEAR.search(k):
            v = v.T
        out[k] = np.asarray(v)
    return out


_MOE_EXPERT = re.compile(
    r"^(model\.layers\.\d+\.mlp)\.experts\.(\d+)\."
    r"(gate_proj|up_proj|down_proj)\.weight$")
_MOE_SHARED = re.compile(
    r"^(model\.layers\.\d+\.mlp)\.shared_experts?\."
    r"(gate_proj|up_proj|down_proj)\.weight$")
_EXPERT_STACK = {"gate_proj": "w_gate", "up_proj": "w_up",
                 "down_proj": "w_down"}


def _moe_parts(hf: Dict[str, np.ndarray], cfg):
    """Qwen2-MoE / ERNIE-4.5-MoE, one shard: (converted tensors, experts
    ``{stacked name: {expert id: [in, out] array}}``). The Llama rules
    for attention and norms; each expert's projections transposed for
    the stacked [E, in, out] tensors; the router [E, h] and the shared
    expert's gate [1, h] transposed; ERNIE-4.5's / DeepSeek-V3's
    ``e_score_correction_bias`` is the selection-only ``expert_bias``."""
    out = {}
    experts: Dict[str, Dict[int, np.ndarray]] = {}
    for k, v in hf.items():
        m = _MOE_EXPERT.match(k)
        if m:
            name = f"{m.group(1)}.{_EXPERT_STACK[m.group(3)]}"
            experts.setdefault(name, {})[int(m.group(2))] = v.T
            continue
        m = _MOE_SHARED.match(k)
        if m:
            out[f"{m.group(1)}.shared_{m.group(2)}"] = v.T
            continue
        if k.endswith(".mlp.gate.weight") or \
                k.endswith(".mlp.shared_expert_gate.weight"):
            out[k[:-len(".weight")]] = v.T
            continue
        if k.endswith(".mlp.moe_statics.e_score_correction_bias") or \
                k.endswith(".mlp.gate.e_score_correction_bias"):
            out[k.rsplit(".mlp.", 1)[0] + ".mlp.expert_bias"] = \
                v.reshape(-1)
            continue
        out.update(_convert_llama({k: v}, cfg))
    return out, experts


def _stack_experts(out, experts):
    for name, by_id in experts.items():
        E = len(by_id)
        if sorted(by_id) != list(range(E)):
            raise KeyError(f"missing experts in {name}: have "
                           f"{sorted(by_id)}")
        out[name] = np.stack([by_id[e] for e in range(E)])
    return out


def _convert_qwen2_moe(hf: Dict[str, np.ndarray],
                       cfg) -> Dict[str, np.ndarray]:
    """Qwen2-MoE / ERNIE-4.5-MoE over a whole checkpoint: the experts
    stacked into [E, ...] tensors (``from_pretrained`` fills them shard
    by shard instead)."""
    return _stack_experts(*_moe_parts(hf, cfg))


_DSV2_LINEAR = re.compile(
    r"self_attn\.(q_a_proj|q_b_proj|kv_a_proj_with_mqa|kv_b_proj)"
    r"\.weight$")


def _deepseek_parts(hf: Dict[str, np.ndarray], cfg):
    """DeepSeek-V2/V3, one shard: the MLA projections (q_a, q_b, kv_a,
    kv_b) transposed, then the Qwen2-MoE rules (q_proj and o_proj ride
    the Llama rule)."""
    return _moe_parts({k: (v.T if _DSV2_LINEAR.search(k) else v)
                       for k, v in hf.items()}, cfg)


def _convert_deepseek_v2(hf: Dict[str, np.ndarray],
                         cfg) -> Dict[str, np.ndarray]:
    return _stack_experts(*_deepseek_parts(hf, cfg))


_CONVERTERS = {"llama": _convert_llama, "qwen2": _convert_llama,
               "ernie4_5": _convert_llama,
               "qwen2_moe": _convert_qwen2_moe,
               "ernie4_5_moe": _convert_qwen2_moe,
               "deepseek_v2": _convert_deepseek_v2,
               "deepseek_v3": _convert_deepseek_v2}
# the per-shard halves of the MoE converters: experts may span shards
_MOE_PARTS = {"qwen2_moe": _moe_parts, "ernie4_5_moe": _moe_parts,
              "deepseek_v2": _deepseek_parts,
              "deepseek_v3": _deepseek_parts}


def convert_hf_state_dict(hf_sd: Dict[str, np.ndarray], cfg,
                          model_type: str) -> Dict[str, np.ndarray]:
    """HF names and layout -> the JAX package's (the port's checkpoint
    layout; ``load_jax_state_dict`` takes it)."""
    if model_type not in _CONVERTERS:
        raise ValueError(f"no converter for model_type={model_type!r}; "
                         f"have {sorted(_CONVERTERS)} (the other families "
                         f"come with their models)")
    return _CONVERTERS[model_type](hf_sd, cfg)


def to_hf_state_dict(model) -> Dict[str, np.ndarray]:
    """Export a Llama-family model to HF names and layout ([out, in], the
    port's own ``Linear`` layout), as float32 numpy arrays for floating
    tensors (numpy has no bf16)."""
    from ..convert import jax_state_dict
    sd = {k: (v.float() if v.is_floating_point() else v).numpy()
          for k, v in jax_state_dict(model).items()}
    return _revert_llama(sd, model.config)


def _torch_dtype(hf: Dict[str, Any]):
    # transformers >= 4.56 writes "dtype"; older wrote "torch_dtype"
    dt = hf.get("dtype", hf.get("torch_dtype"))
    if dt == "float32":
        return torch.float32
    if dt == "float16":
        # every kernel of the port takes fp16, so it stays fp16 (the JAX
        # package maps it to bf16: fp16 has no TPU fast path)
        return torch.float16
    return torch.bfloat16


def _rope_scaling_cfg(hf, mt):
    """Validate and normalize HF ``rope_scaling`` for the Llama family;
    the model dispatches it through ``llama.rope_params_from_scaling``."""
    rs_cfg = hf.get("rope_scaling")
    if not rs_cfg:
        return None
    from .llama import ROPE_SCALING_TYPES
    rtype = rs_cfg.get("rope_type", rs_cfg.get("type"))
    if rtype not in ROPE_SCALING_TYPES:
        raise ValueError(f"rope_scaling type {rtype!r} not supported "
                         f"for {mt} ({'/'.join(ROPE_SCALING_TYPES)} are)")
    return None if rtype == "default" else rs_cfg


def config_from_hf(model_dir: str):
    """An HF ``config.json`` -> (model class, config, model type): the
    Llama family (``llama``, ``ernie4_5``; ``qwen2``, the Llama backbone
    with biased q/k/v), ``qwen2_moe`` / ``ernie4_5_moe`` and
    ``deepseek_v2`` / ``deepseek_v3``, with the JAX package's fields and
    its ``ValueError`` for each variant it does not build."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "")
    if mt not in _CONVERTERS:
        raise ValueError(f"unsupported model_type {mt!r} in {model_dir} "
                         f"(the port loads {sorted(_CONVERTERS)})")
    common = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        num_key_value_heads=hf.get("num_key_value_heads",
                                   hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        dtype=_torch_dtype(hf))
    if mt in ("llama", "qwen2", "ernie4_5"):
        from .llama import LlamaConfig, LlamaForCausalLM
        from .qwen2 import Qwen2Config, Qwen2ForCausalLM
        cls, ccls = ((Qwen2ForCausalLM, Qwen2Config) if mt == "qwen2"
                     else (LlamaForCausalLM, LlamaConfig))
        cfg = ccls(
            **common,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", mt == "qwen2"),
            sliding_window=(hf.get("sliding_window")
                            if hf.get("use_sliding_window") else None),
            max_window_layers=(hf.get("max_window_layers")
                               if hf.get("use_sliding_window") else None),
            rope_scaling=_rope_scaling_cfg(hf, mt))
        return cls, cfg, mt
    if mt in ("qwen2_moe", "ernie4_5_moe"):
        from .ernie import Ernie45MoeConfig, Ernie45MoeForCausalLM
        from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
        qwen = mt == "qwen2_moe"
        ccls, cls = ((Qwen2MoeConfig, Qwen2MoeForCausalLM) if qwen
                     else (Ernie45MoeConfig, Ernie45MoeForCausalLM))
        if hf.get("decoder_sparse_step", 1) not in (0, 1) or \
                hf.get("mlp_only_layers"):
            raise ValueError(
                "decoder_sparse_step > 1 / mlp_only_layers are not "
                "supported (this build places MoE on every layer past "
                "first_k_dense_replace)")
        n_shared = hf.get("shared_expert_intermediate_size") or 0
        cfg = ccls(
            **common,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1000000.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", qwen),
            num_experts=hf.get("num_experts") or hf.get("moe_num_experts"),
            num_experts_per_tok=hf.get("num_experts_per_tok")
            or hf.get("moe_k", 2),
            moe_intermediate_size=hf.get("moe_intermediate_size", 1408),
            num_shared_experts=(1 if n_shared else
                                hf.get("moe_num_shared_experts", 0)),
            shared_expert_intermediate_size=n_shared or None,
            first_k_dense_replace=hf.get("first_k_dense_replace",
                                         hf.get("moe_layer_start_index", 0)),
            shared_expert_gate=qwen,
            norm_topk_prob=hf.get("norm_topk_prob", False),
            rope_scaling=_rope_scaling_cfg(hf, mt))
        return cls, cfg, mt
    from .deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM
    v3 = mt == "deepseek_v3"
    if v3 and hf.get("rope_interleave", True) is False:
        raise ValueError("rope_interleave=False (rotate-half pairing) "
                         "not supported; DeepSeek ships interleaved")
    if not v3 and hf.get("topk_method", "greedy") not in (
            "greedy", "group_limited_greedy"):
        raise ValueError(
            f"topk_method {hf.get('topk_method')!r} not supported")
    if hf.get("moe_layer_freq", 1) != 1:
        raise ValueError("moe_layer_freq != 1 not supported")
    rs_cfg = hf.get("rope_scaling")
    if rs_cfg and rs_cfg.get("rope_type", rs_cfg.get("type")) not in (
            "yarn",):
        raise ValueError(
            f"rope_scaling type {rs_cfg!r} not supported (yarn is)")
    grouped = v3 or hf.get("topk_method") == "group_limited_greedy"
    cfg = DeepseekV2Config(
        **common,
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        attention_bias=hf.get("attention_bias", False),
        q_lora_rank=hf.get("q_lora_rank"),
        kv_lora_rank=hf.get("kv_lora_rank", 512),
        qk_nope_head_dim=hf.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=hf.get("qk_rope_head_dim", 64),
        v_head_dim=hf.get("v_head_dim", 128),
        num_experts=hf.get("n_routed_experts", 64),
        num_experts_per_tok=hf.get("num_experts_per_tok", 6),
        moe_intermediate_size=hf.get("moe_intermediate_size", 1408),
        num_shared_experts=hf.get("n_shared_experts") or 0,
        first_k_dense_replace=hf.get("first_k_dense_replace", 1),
        routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
        n_group=hf.get("n_group", 1) if grouped else 1,
        topk_group=hf.get("topk_group", 1) if grouped else 1,
        rope_scaling=rs_cfg,
        # V3's sigmoid router applies norm_topk_prob; transformers' V2
        # gate reads it but never applies it on the greedy path
        norm_topk_prob=hf.get("norm_topk_prob", True) if v3 else False,
        scoring="sigmoid" if v3 else "softmax",
        group_score_mode="top2_sum" if v3 else "max",
        yarn_mscale_all_in_scale=v3,
        aux_loss_weight=0.0 if v3 else 0.001)
    return DeepseekV2ForCausalLM, cfg, mt


@torch.no_grad()
def from_pretrained(model_dir: str, dtype: Optional[torch.dtype] = None,
                    device=None, model_cls=None, strict: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Build a model from an HF checkpoint directory on ``device`` (the
    card unless the caller passes ``"cpu"``), its weights copied in shard
    by shard. The MoE families' experts may span shards: each expert's
    projections are copied into their row of the stacked [E, ...] tensor
    as its shard arrives, and a layer left without one of its experts
    raises ``KeyError``. A converted key the model lacks always raises
    (converter drift); a model key the checkpoint lacks raises when
    ``strict``, and otherwise stays at its random init with a warning.
    ``expert_bias`` (a checkpoint without ``e_score_correction_bias``
    balances otherwise) stays at zero, as the JAX package leaves it.

    Each file is read through a memory map, one tensor at a time. On a
    mesh, call it inside ``parallel.sharding.sharded_build`` on every
    rank: the model is built there (each decoder layer cut to this
    rank's shards as it is drawn), ``shard_layer`` cuts the rest with
    the build's arguments, and each rank then reads only its own slice
    of each tensor into its shard, so no rank holds a decoder layer
    whole but the one being drawn. Call ``bind_static`` on the returned
    model to serve it. The MoE families (which serve at tp 1) load whole
    only: ``ValueError`` inside ``sharded_build``; load them outside it
    and shard the model with ``shard_layer``."""
    import warnings

    from ..convert import copy_jax_params
    from ..parallel import sharding
    cls, cfg, mt = config_from_hf(model_dir)
    if dtype is not None:
        cfg.dtype = dtype
    build = sharding.open_build()
    if build is not None and mt in _MOE_PARTS:
        raise ValueError(f"{mt} loads whole: call from_pretrained outside "
                         f"sharded_build, then shard_layer")
    model = (model_cls or cls)(cfg, device=device, generator=generator)
    if build is not None:
        mesh, kw = build
        sharding.shard_layer(model, mesh, **kw)
    own = model.state_dict(keep_vars=True)
    loaded = set()
    experts: Dict[str, set] = {}
    for shard in _iter_checkpoint(model_dir, _open_safetensors_file):
        if mt in _MOE_PARTS:
            sd, parts = _MOE_PARTS[mt](shard, cfg)
        else:
            sd, parts = convert_hf_state_dict(shard, cfg, mt), {}
        unexpected = [k for k in [*sd, *parts] if k not in own]
        if unexpected:
            raise KeyError(f"converted keys not in model: {unexpected[:8]}")
        copy_jax_params(model, sd, own)
        loaded.update(sd)
        for name, by_id in parts.items():
            dst = own[name]
            for e, v in by_id.items():
                if not 0 <= e < dst.shape[0] or \
                        tuple(v.shape) != tuple(dst.shape[1:]):
                    raise ValueError(f"{name}: expert {e} of shape "
                                     f"{tuple(v.shape)} does not fit "
                                     f"{tuple(dst.shape)}")
                dst[e].copy_(torch.from_numpy(np.asarray(v, np.float32)))
            experts.setdefault(name, set()).update(by_id)
        del shard, sd, parts
    for name, ids in experts.items():
        if ids != set(range(own[name].shape[0])):
            raise KeyError(f"missing experts in {name}: have "
                           f"{sorted(ids)}")
    loaded.update(experts)
    missing = [k for k in own
               if k not in loaded and not k.endswith(".expert_bias")]
    if missing and strict:
        raise KeyError(f"checkpoint missing model keys: {missing[:8]}")
    if missing:
        warnings.warn(f"{len(missing)} keys left at random init "
                      f"(e.g. {missing[:4]})", stacklevel=2)
    return model
