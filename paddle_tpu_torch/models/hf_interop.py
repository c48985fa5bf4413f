"""Pretrained-weight interop for the Llama family: HF safetensors
checkpoints into the port (counterpart of the Llama half of
``paddle_tpu/models/hf_interop.py``: ``iter_hf_checkpoint_shards``,
``load_hf_checkpoint``, ``_convert_llama``, ``_revert_llama``,
``convert_hf_state_dict``, ``to_hf_state_dict``, ``config_from_hf`` and
``from_pretrained``).

The converters work on numpy arrays in the JAX package's layout (every
2-D linear weight [in, out], HF's transposed), so a shard converts to
exactly what the JAX package converts it to; ``from_pretrained`` then
copies it into the port's modules as ``load_jax_state_dict`` does (the
port's ``Linear`` keeps HF's [out, in]), one shard at a time.

The safetensors layout is read here, without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}`` and the raw little-endian
tensors. BF16 tensors come back as float32 numpy arrays (numpy has no
bf16 type; the JAX package's reader gives ml_dtypes' bf16, or float32
through torch, by the ``safetensors`` version), every other dtype as
itself, with the JAX reader's values.

The other model families' converters come with their models.
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


def _load_safetensors_file(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of one ``.safetensors`` file (BF16 as float32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[lo:hi]
        if info["dtype"] == "BF16":
            t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) \
                if raw else torch.empty(0, dtype=torch.bfloat16)
            out[name] = t.float().numpy().reshape(shape)
        elif info["dtype"] in _NUMPY_DTYPES:
            out[name] = np.frombuffer(
                raw, dtype=np.dtype(_NUMPY_DTYPES[info["dtype"]])
                .newbyteorder("<")).reshape(shape).copy()
        else:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which is not read here")
    return out


def iter_hf_checkpoint_shards(
        model_dir: str) -> Iterator[Dict[str, np.ndarray]]:
    """Yield tensors shard by shard, so the caller converts and places
    each and lets it go before the next loads (host peak: one shard)."""
    idx = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        for shard in sorted(set(weight_map.values())):
            yield _load_safetensors_file(os.path.join(model_dir, shard))
        return
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        yield _load_safetensors_file(single)
        return
    binp = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(binp):
        sd = torch.load(binp, map_location="cpu", weights_only=True)
        yield {k: v.float().numpy() for k, v in sd.items()}
        return
    raise FileNotFoundError(f"no safetensors/bin checkpoint in {model_dir}")


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


_CONVERTERS = {"llama": _convert_llama, "qwen2": _convert_llama,
               "ernie4_5": _convert_llama}


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
    """An HF ``config.json`` -> (model class, ``LlamaConfig``, model
    type), for the Llama family (``llama``, ``qwen2``: the Llama backbone
    with biased q/k/v; ``ernie4_5``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "")
    if mt not in _CONVERTERS:
        raise ValueError(f"unsupported model_type {mt!r} in {model_dir} "
                         f"(the port loads {sorted(_CONVERTERS)})")
    from .llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        num_key_value_heads=hf.get("num_key_value_heads",
                                   hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=hf.get("attention_bias", mt == "qwen2"),
        sliding_window=(hf.get("sliding_window")
                        if hf.get("use_sliding_window") else None),
        max_window_layers=(hf.get("max_window_layers")
                           if hf.get("use_sliding_window") else None),
        rope_scaling=_rope_scaling_cfg(hf, mt),
        dtype=_torch_dtype(hf))
    return LlamaForCausalLM, cfg, mt


@torch.no_grad()
def from_pretrained(model_dir: str, dtype: Optional[torch.dtype] = None,
                    device=None, model_cls=None, strict: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Build a Llama-family model from an HF checkpoint directory on
    ``device`` (the card unless the caller passes ``"cpu"``), its weights
    copied in shard by shard. A converted key the model lacks always
    raises (converter drift); a model key the checkpoint lacks raises
    when ``strict``, and otherwise stays at its random init with a
    warning."""
    import warnings

    from ..convert import copy_jax_params
    cls, cfg, mt = config_from_hf(model_dir)
    if dtype is not None:
        cfg.dtype = dtype
    model = (model_cls or cls)(cfg, device=device, generator=generator)
    own = model.state_dict(keep_vars=True)
    loaded = set()
    for shard in iter_hf_checkpoint_shards(model_dir):
        sd = convert_hf_state_dict(shard, cfg, mt)
        unexpected = [k for k in sd if k not in own]
        if unexpected:
            raise KeyError(f"converted keys not in model: {unexpected[:8]}")
        copy_jax_params(model, sd, own)
        loaded.update(sd)
        del shard, sd
    missing = [k for k in own if k not in loaded]
    if missing and strict:
        raise KeyError(f"checkpoint missing model keys: {missing[:8]}")
    if missing:
        warnings.warn(f"{len(missing)} keys left at random init "
                      f"(e.g. {missing[:4]})", stacklevel=2)
    return model
