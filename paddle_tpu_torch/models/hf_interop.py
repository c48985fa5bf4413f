"""Pretrained-weight interop: HF safetensors checkpoints into the port
(counterpart of ``paddle_tpu/models/hf_interop.py``'s decoder LMs:
``iter_hf_checkpoint_shards``, ``load_hf_checkpoint``,
``_convert_llama``, ``_revert_llama``, ``_convert_qwen2_moe``,
``_convert_deepseek_v2``, ``_convert_bert_encoder``, ``_convert_mlm_head``,
``_convert_bert``, ``_convert_ernie``, ``_convert_gpt2``, ``_fuse_qkv``,
``convert_hf_state_dict``, ``to_hf_state_dict``, ``config_from_hf`` and
``from_pretrained``).

Model types: ``llama``, ``qwen2``, ``ernie4_5``, ``qwen2_moe``,
``ernie4_5_moe``, ``deepseek_v2``, ``deepseek_v3``, ``gpt2``, ``bert``
and ``ernie``; ``vit``, ``clip``, ``resnet`` and the diffusers
``autoencoder_kl``, ``dit`` and ``sd3_transformer``, whose converters and
config branches are in ``hf_vision``. The converters work on numpy
arrays in the JAX package's layout (every 2-D linear weight [in, out], HF's transposed; the experts
stacked [E, in, out]; the BERT family's q, k and v fused into one [h,
3h] ``qkv_proj``; GPT-2's ``Conv1D`` weights, already [in, out], kept as
they are), so a checkpoint converts to exactly what the JAX package
converts it to; ``from_pretrained`` then copies it into the port's
modules as ``load_jax_state_dict`` does (the port's ``Linear`` keeps
HF's [out, in]), one shard at a time, experts included. The BERT family
is converted over the whole checkpoint at once (a layer's q, k and v
may lie in different shards).

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
    for name in ("model.safetensors",
                 "diffusion_pytorch_model.safetensors",   # diffusers
                 "pytorch_model.bin"):
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


def _src_prefix(hf: Dict[str, Any]) -> str:
    for p in ("bert.", "ernie."):
        if any(k.startswith(p) for k in hf):
            return p
    return ""


def _fuse_qkv(hf: Dict[str, Any], q: str, k: str, v: str):
    """Three torch [out, in] projections -> one fused [in, 3*out] weight
    and [3*out] bias (the qkv reshape order is [3, heads, head_dim])."""
    w = np.concatenate([np.asarray(hf[n + ".weight"]).T for n in (q, k, v)],
                       axis=1)
    b = np.concatenate([np.asarray(hf[n + ".bias"]) for n in (q, k, v)])
    return w, b


def _convert_bert_encoder(hf: Dict[str, Any], cfg,
                          dst_prefix: str) -> Dict[str, Any]:
    """An HF BERT-family encoder -> ``models/bert.py``'s layout: a layer's
    three [h, h] q/k/v projections fuse into one [h, 3h] ``qkv_proj``;
    the position and token-type tables become plain parameters."""
    out: Dict[str, Any] = {}
    g = hf.__getitem__
    p = _src_prefix(hf)
    emb = f"{p}embeddings."
    dp = dst_prefix
    out[dp + "embeddings.word_embeddings.weight"] = \
        g(emb + "word_embeddings.weight")
    out[dp + "embeddings.position_embeddings"] = \
        g(emb + "position_embeddings.weight")
    out[dp + "embeddings.token_type_embeddings"] = \
        g(emb + "token_type_embeddings.weight")
    out[dp + "embeddings.layer_norm.weight"] = g(emb + "LayerNorm.weight")
    out[dp + "embeddings.layer_norm.bias"] = g(emb + "LayerNorm.bias")
    for i in range(cfg.num_hidden_layers):
        src = f"{p}encoder.layer.{i}."
        dst = f"{dp}layers.{i}."
        w, b = _fuse_qkv(hf, *(src + f"attention.self.{n}"
                               for n in ("query", "key", "value")))
        out[dst + "attention.qkv_proj.weight"] = w
        out[dst + "attention.qkv_proj.bias"] = b
        for name, hf_name in (("attention.out_proj", "attention.output.dense"),
                              ("fc_in", "intermediate.dense"),
                              ("fc_out", "output.dense")):
            out[dst + name + ".weight"] = g(src + hf_name + ".weight").T
            out[dst + name + ".bias"] = g(src + hf_name + ".bias")
        for name, hf_name in (("attn_norm", "attention.output.LayerNorm"),
                              ("out_norm", "output.LayerNorm")):
            out[dst + name + ".weight"] = g(src + hf_name + ".weight")
            out[dst + name + ".bias"] = g(src + hf_name + ".bias")
    if p + "pooler.dense.weight" in hf:
        out[dp + "pooler.dense.weight"] = g(p + "pooler.dense.weight").T
        out[dp + "pooler.dense.bias"] = g(p + "pooler.dense.bias")
    return out


def _convert_mlm_head(hf: Dict[str, Any]) -> Dict[str, Any]:
    """HF ``cls.predictions.*`` / ``cls.seq_relationship.*`` -> the
    ``TiedMLMHead`` and the NSP head (the decoder weight is the word table
    on both sides, so only the transform and the biases transfer)."""
    out: Dict[str, Any] = {}
    cp = "cls.predictions."
    if cp + "transform.dense.weight" in hf:
        out["mlm_head.transform.weight"] = \
            hf[cp + "transform.dense.weight"].T
        out["mlm_head.transform.bias"] = hf[cp + "transform.dense.bias"]
        out["mlm_head.transform_norm.weight"] = \
            hf[cp + "transform.LayerNorm.weight"]
        out["mlm_head.transform_norm.bias"] = \
            hf[cp + "transform.LayerNorm.bias"]
        out["mlm_head.mlm_bias"] = hf[cp + "bias"]
    if "cls.seq_relationship.weight" in hf:
        out["nsp_head.weight"] = hf["cls.seq_relationship.weight"].T
        out["nsp_head.bias"] = hf["cls.seq_relationship.bias"]
    return out


def _convert_bert(hf: Dict[str, Any], cfg) -> Dict[str, Any]:
    out = _convert_bert_encoder(hf, cfg, "bert.")
    out.update(_convert_mlm_head(hf))
    return out


def _convert_ernie(hf: Dict[str, Any], cfg) -> Dict[str, Any]:
    """HF model_type ``ernie`` (a BERT-family encoder with task-type
    embeddings) -> ``ErnieForMaskedLM``; it has no NSP head."""
    out = _convert_bert_encoder(hf, cfg, "ernie.encoder.")
    tt = _src_prefix(hf) + "embeddings.task_type_embeddings.weight"
    if tt in hf:
        out["ernie.task_type_embeddings"] = hf[tt]
    head = _convert_mlm_head(hf)
    head.pop("nsp_head.weight", None)
    head.pop("nsp_head.bias", None)
    out.update(head)
    return out


_GPT2_LAYER = {
    "ln_1": "ln_1", "ln_2": "ln_2",
    "attn.c_attn": "attn.qkv_proj", "attn.c_proj": "attn.out_proj",
    "mlp.c_fc": "mlp.fc_in", "mlp.c_proj": "mlp.fc_out",
}


def _convert_gpt2(hf: Dict[str, Any], cfg) -> Dict[str, Any]:
    """HF GPT2LMHeadModel -> ``models/gpt.py``. GPT-2's ``Conv1D`` stores
    its weights [in, out] already (the JAX layout), so nothing is
    transposed here (``load_jax_state_dict`` transposes them once, into
    the port's [out, in]); the fused ``c_attn`` q|k|v column order is the
    qkv reshape's [3, heads, head_dim]. Per key, so it works one shard at
    a time."""
    out = {}
    for k, v in hf.items():
        if k.endswith((".attn.bias", ".attn.masked_bias")):
            continue  # causal-mask buffers
        if k == "lm_head.weight":
            continue  # GPT-2 always ties; the tied head reads the table
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if k == "wte.weight":
            out["model.embed_tokens.weight"] = v
        elif k == "wpe.weight":
            out["model.embed_positions"] = v
        elif k.startswith("ln_f."):
            out["model.ln_f." + k[len("ln_f."):]] = v
        else:
            m = re.match(r"h\.(\d+)\.(.+)\.(weight|bias)$", k)
            if m is None:
                raise KeyError(f"unmapped GPT-2 key {k!r}")
            n, sub, wb = m.groups()
            out[f"model.layers.{n}.{_GPT2_LAYER[sub]}.{wb}"] = v
    return out


_CONVERTERS = {"llama": _convert_llama, "qwen2": _convert_llama,
               "ernie4_5": _convert_llama,
               "qwen2_moe": _convert_qwen2_moe,
               "ernie4_5_moe": _convert_qwen2_moe,
               "deepseek_v2": _convert_deepseek_v2,
               "deepseek_v3": _convert_deepseek_v2,
               "bert": _convert_bert, "ernie": _convert_ernie,
               "gpt2": _convert_gpt2}
# converted over the whole checkpoint: a layer's q, k and v fuse
_WHOLE_CHECKPOINT = ("bert", "ernie")
# converted over the whole checkpoint read into numpy (their converters
# reshape and concatenate across blocks)
_VISION = ("vit", "clip", "resnet", "autoencoder_kl", "dit",
           "sd3_transformer")
# missing keys under these prefixes are heads a bare encoder checkpoint
# lacks: they stay at their random init with a warning, even when strict
_OPTIONAL_HEAD_PREFIXES = ("mlm_head.", "nsp_head.", "bert.pooler.",
                           "ernie.encoder.pooler.",
                           "ernie.task_type_embeddings",
                           "head.")   # a bare ViTModel has no classifier
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
    port's own ``Linear`` layout), or an ``AutoencoderKL``, ``DiT`` or
    ``MMDiT`` to the diffusers layout, as float32 numpy arrays for
    floating tensors (numpy has no bf16)."""
    from ..convert import jax_state_dict
    sd = {k: (v.float() if v.is_floating_point() else v).numpy()
          for k, v in jax_state_dict(model).items()}
    out = hf_vision.revert(model, sd)
    return out if out is not None else _revert_llama(sd, model.config)


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
    with biased q/k/v), ``qwen2_moe`` / ``ernie4_5_moe``,
    ``deepseek_v2`` / ``deepseek_v3``, ``gpt2`` (``GPTForCausalLM``, tied),
    ``bert`` / ``ernie`` (``BertForPretraining`` / ``ErnieForMaskedLM``),
    ``vit`` (``ViTForImageClassification``), ``resnet``, ``clip``, and a
    diffusers ``config.json`` by its ``_class_name`` (``AutoencoderKL``,
    ``DiTTransformer2DModel``, ``SD3Transformer2DModel``), with the JAX
    package's fields and its ``ValueError`` for each variant it does not
    build (a VAE without quant convs or with ``shift_factor``: SD3's and
    FLUX's; an SD3.5 transformer; a DiT not adaLN-Zero)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "")
    if not mt:
        found = hf_vision.diffusers_config(hf)
        if found is not None:
            return found
    if mt in ("vit", "resnet", "clip"):
        return hf_vision.vision_config(hf, mt, _torch_dtype(hf))
    if mt not in _CONVERTERS:
        raise ValueError(f"unsupported model_type {mt!r} in {model_dir} "
                         f"(the port loads {sorted(_CONVERTERS)})")
    if mt == "gpt2":
        from .gpt import GPTConfig, GPTForCausalLM
        cfg = GPTConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["n_embd"],
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
            num_hidden_layers=hf["n_layer"],
            num_attention_heads=hf["n_head"],
            max_position_embeddings=hf.get("n_positions", 1024),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=True,  # GPT-2 checkpoints always tie
            dtype=_torch_dtype(hf))
        return GPTForCausalLM, cfg, mt
    if mt in ("bert", "ernie"):
        from .bert import BertConfig, BertForPretraining
        from .ernie import ErnieConfig, ErnieForMaskedLM
        ccls, cls = ((ErnieConfig, ErnieForMaskedLM) if mt == "ernie"
                     else (BertConfig, BertForPretraining))
        kw = dict(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
            dtype=_torch_dtype(hf))
        if mt == "ernie":
            kw["task_type_vocab_size"] = hf.get("task_type_vocab_size", 3)
            kw["use_task_id"] = hf.get("use_task_id", True)
        return cls, ccls(**kw), mt
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


def _copy_experts(name, dst, by_id) -> None:
    """Copy a shard's experts ``{expert id: [in, out] array}`` into their
    rows of the stacked parameter ``dst``; on a mesh, only the rows of
    this rank's shard (its E / ep experts), each read from the file
    there alone."""
    from ..convert import _read_part
    from ..parallel.sharding import local, local_index
    idx = local_index(dst)
    lo, hi = idx[0].start, idx[0].stop
    mine = local(dst)
    for e, v in by_id.items():
        if not 0 <= e < dst.shape[0] or \
                tuple(v.shape) != tuple(dst.shape[1:]):
            raise ValueError(f"{name}: expert {e} of shape "
                             f"{tuple(v.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        if lo <= e < hi:
            part = _read_part(v, idx[1:])
            mine[e - lo].copy_(torch.from_numpy(
                np.asarray(part, np.float32)))


def _cast_loaded(model, own, names, dtype) -> None:
    """Give each floating tensor of ``model`` named in ``names`` the dtype
    ``dtype`` before the checkpoint is copied in, as the JAX loader's
    ``_place`` casts every floating tensor of the converted checkpoint to
    the config's dtype: a bf16 checkpoint's heads that the constructor
    keeps fp32 (ViT's classifier, CLIP's projections and logit scale,
    the BERT family's NSP and classifier heads) load bf16. Tensors the
    checkpoint lacks keep the constructor's dtype, as in JAX. A DTensor
    is cast by its local shard, keeping its placements and metadata."""
    from ..nn.common import copy_meta
    from ..parallel.sharding import _owner, map_local
    for name in names:
        t = own.get(name)
        if t is None or not t.is_floating_point() or t.dtype == dtype:
            continue
        owner, attr = _owner(model, name)
        if attr in owner._parameters:
            new = copy_meta(t, torch.nn.Parameter(
                map_local(t.detach(), lambda x: x.to(dtype)),
                requires_grad=t.requires_grad))
            owner._parameters[attr] = new
        else:
            new = t.to(dtype)
            owner._buffers[attr] = new
        own[name] = new


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
    The heads a bare encoder checkpoint lacks (``_OPTIONAL_HEAD_PREFIXES``:
    the MLM and NSP heads, the pooler, ERNIE's task-type table) stay at
    their random init with the warning, strict or not, as in JAX.
    ``expert_bias`` (a checkpoint without ``e_score_correction_bias``
    balances otherwise) stays at zero, as the JAX package leaves it.

    Each file is read through a memory map, one tensor at a time. On a
    mesh, call it inside ``parallel.sharding.sharded_build`` on every
    rank: the model is built there (each decoder layer cut to this
    rank's shards as it is drawn), ``shard_layer`` cuts the rest with
    the build's arguments, and each rank then reads only its own slice
    of each tensor into its shard, so no rank holds a decoder layer
    whole but the one being drawn. Call ``bind_static`` on the returned
    model to serve it. An MoE family's rank reads only its own experts
    (its E / ep rows of each stacked tensor, over ep) and its tp slices
    of the attention and dense projections."""
    import warnings

    from ..convert import copy_jax_params
    from ..parallel import sharding
    cls, cfg, mt = config_from_hf(model_dir)
    if dtype is not None:
        cfg.dtype = dtype
        for sub in ("text", "vision"):   # CLIP's towers read their own
            if hasattr(cfg, sub):
                getattr(cfg, sub).dtype = dtype
    build = sharding.open_build()
    model = (model_cls or cls)(cfg, device=device, generator=generator)
    if build is not None:
        mesh, kw = build
        sharding.shard_layer(model, mesh, **kw)
    own = model.state_dict(keep_vars=True)
    loaded = set()
    experts: Dict[str, set] = {}
    shards = _iter_checkpoint(model_dir, _open_safetensors_file)
    if mt in _WHOLE_CHECKPOINT or mt in _VISION:
        whole: Dict[str, Any] = {}
        for shard in shards:
            whole.update(shard if mt in _WHOLE_CHECKPOINT else
                         {k: np.asarray(v) for k, v in shard.items()})
        shards = [whole]
    for shard in shards:
        if mt in _MOE_PARTS:
            sd, parts = _MOE_PARTS[mt](shard, cfg)
        else:
            sd, parts = convert_hf_state_dict(shard, cfg, mt), {}
        unexpected = [k for k in [*sd, *parts] if k not in own]
        if unexpected:
            raise KeyError(f"converted keys not in model: {unexpected[:8]}")
        _cast_loaded(model, own, sd, cfg.dtype)
        copy_jax_params(model, sd, own)
        loaded.update(sd)
        for name, by_id in parts.items():
            _copy_experts(name, own[name], by_id)
            experts.setdefault(name, set()).update(by_id)
        del shard, sd, parts
    for name, ids in experts.items():
        if ids != set(range(own[name].shape[0])):
            raise KeyError(f"missing experts in {name}: have "
                           f"{sorted(ids)}")
    loaded.update(experts)
    missing = [k for k in own
               if k not in loaded and not k.endswith(".expert_bias")]
    hard_missing = [k for k in missing
                    if not k.startswith(_OPTIONAL_HEAD_PREFIXES)]
    if hard_missing and strict:
        raise KeyError(f"checkpoint missing model keys: {hard_missing[:8]}")
    if missing:
        warnings.warn(f"{len(missing)} keys left at random init "
                      f"(e.g. {missing[:4]})", stacklevel=2)
    return model


# the vision and diffusion families (their converters use _fuse_qkv above)
from . import hf_vision  # noqa: E402

_CONVERTERS.update(hf_vision.CONVERTERS)
