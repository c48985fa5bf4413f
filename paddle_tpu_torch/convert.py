"""Weights from the JAX package into the port.

``params`` is ``{name: np.ndarray}`` as the JAX package's
``model.state_dict()`` gives it, under the same names
(``model.layers.0.self_attn.q_proj.weight``, ...). The port's modules
are built so that their parameter and buffer names are those names.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .nn.common import Linear


@torch.no_grad()
def load_jax_state_dict(model: nn.Module,
                        params: Mapping[str, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` in place: its parameters and its
    persistent buffers (a quantized model's ``qweight``, ``scales``,
    ``bias`` and ``awq_inv``).

    - Transposes: every ``Linear`` weight (the q/k/v/o, gate/up/down
      projections and ``lm_head``; GPT's and BERT's fused ``qkv_proj``,
      ``out_proj``, ``fc_in`` and ``fc_out``, the pooler, the MLM
      transform, the NSP head and the classifiers; the ``nn.Transformer``
      layers' projections) is stored [in, out] by the JAX package and
      [out, in] here, so it is transposed. Everything else keeps its
      layout: embedding tables, norm weights (``LayerNorm``'s weight and
      bias too), biases, the plain parameter tables (GPT's
      ``embed_positions``, BERT's ``position_embeddings`` and
      ``token_type_embeddings``, ERNIE's ``task_type_embeddings``, the
      MLM head's ``mlm_bias``), and a ``QuantizedLinear``'s codes and
      scales, which are [din, dout] in both packages (it is not a
      ``Linear``). Nor are the MoE layers'
      parameters (``parallel.moe.MoEMLP``): the stacked experts
      ``w_gate``/``w_up`` [E, h, m] and ``w_down`` [E, m, h], the router
      ``gate`` [h, E], the ``shared_*`` projections and
      ``shared_expert_gate`` [h, 1] are plain parameters in the JAX
      layout in both packages, and are copied untransposed. Nor are the
      vision and diffusion families': a conv's weight [out, in / groups,
      k...] and a transposed conv's [in, out / groups, k...] (Paddle's
      layouts, which are torch's too), BatchNorm's ``_mean`` and
      ``_variance`` buffers, and the plain parameters ViT's ``cls_token``
      and ``pos_embed``, DiT's and MMDiT's frozen ``pos_embed``, SVTR's
      ``pos_embed``, CLIP's ``position_embedding``, ``logit_scale``,
      ``text_projection`` and ``visual_projection`` (the last two [h,
      proj], used as ``x @ P`` in both packages).
    - LoRA adapters (``peft.lora``): a ``Linear``'s ``lora_A`` ([in, r] in
      the JAX package, [r, in] here) and ``lora_B`` ([r, out] there,
      [out, r] here) are transposed as its weight is, and sharded by the
      partitions ``apply_lora`` gave them.
    - Dtypes: each value is cast to the dtype of the tensor it fills and
      moved to its device. Floating values go through float32, so bf16
      scales cross bit for bit; integer codes are copied as integers.
    - Strict, as the JAX ``set_state_dict`` is: a missing or unexpected key
      raises ``KeyError``; a shape that does not fit raises ``ValueError``.
    - A fused JAX model's ``qkv_proj`` / ``gate_up_proj`` weights (and
      biases) load into a port model fused by
      ``nn.fuse.fuse_projections`` at the same tp degree: the fused
      layers are ``Linear``s, so their weights are transposed, and both
      packages interleave the outputs in the same rank order.
    - On a mesh, into a model already sharded (built in
      ``parallel.sharding.sharded_build``, cut by ``shard_layer``; or the
      whole model, sharded after): each rank reads only its own slice of
      each array (a DTensor parameter's shard, a ``buffer_partitions()``
      buffer's cut) and copies it into its shard, so no rank makes a
      tensor of a sharded parameter's whole shape. The shapes checked
      are the logical ones.
    """
    own = model.state_dict(keep_vars=True)
    missing = [k for k in own if k not in params]
    unexpected = [k for k in params if k not in own]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing[:5]} "
                       f"unexpected={unexpected[:5]}")
    copy_jax_params(model, params, own)


def _transposed(model: nn.Module):
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            out.update(f"{name}.{k}" if name else k
                       for k in ("weight", "lora_A", "lora_B")
                       if k in mod._parameters)
    return out


@torch.no_grad()
def copy_jax_params(model: nn.Module, params: Mapping[str, np.ndarray],
                    own=None) -> None:
    """Copy each of ``params`` into the model's tensor of that name, with
    :func:`load_jax_state_dict`'s transposes, casts and sharding, without
    its check that every key is there (``from_pretrained`` loads a
    checkpoint one shard at a time and checks the keys at the end). A
    value may be any array with ``shape``, ``.T`` and basic indexing
    that reads only what it is indexed by (``from_pretrained``'s views
    of a checkpoint file)."""
    own = model.state_dict(keep_vars=True) if own is None else own
    transposed = _transposed(model)
    for name in params:
        dst = own[name]
        src = params[name]
        if torch.is_tensor(src):
            src = src.detach().cpu().float().numpy() \
                if src.is_floating_point() else src.cpu().numpy()
        elif not hasattr(src, "shape"):
            src = np.asarray(src)
        if name in transposed:
            src = src.T
        target, idx, held = _rank_target(model, name, dst, src.shape)
        if tuple(src.shape) != held:
            raise ValueError(f"{name}: shape {tuple(src.shape)} after "
                             f"conversion, model holds {held}")
        part = _read_part(src, idx)
        value = torch.from_numpy(np.array(
            part, np.float32 if dst.is_floating_point() else part.dtype))
        target.copy_(value.to(device=target.device, dtype=target.dtype))


def _rank_target(model: nn.Module, name: str, dst, shape):
    """(the tensor this rank fills for ``name``, the index of its slice
    of a source of logical ``shape``, the logical shape the model
    holds): a DTensor's local shard and index, a buffer cut by its
    module's ``buffer_partitions()`` and its index, else the whole."""
    from .parallel.sharding import (_owner, buffer_index, is_sharded,
                                    local, local_index)
    if is_sharded(dst):
        return local(dst), local_index(dst), tuple(dst.shape)
    whole = tuple(slice(None) for _ in dst.shape)
    owner, attr = _owner(model, name)
    parts = getattr(owner, "buffer_partitions", None)
    part = parts().get(attr) if parts is not None and getattr(
        owner, "_buffers_sharded", False) else None
    if part is None or len(shape) != dst.ndim:
        return dst, whole, tuple(dst.shape)
    from .distributed.env import get_mesh
    idx = buffer_index(shape, part, get_mesh())
    if tuple(s.stop - s.start for s in idx) != tuple(dst.shape):
        return dst, whole, f"a shard of shape {tuple(dst.shape)}"
    return dst, idx, tuple(shape)


def _read_part(src, idx):
    """``src[idx]`` as an array of its own (a view of a checkpoint file
    reads only those elements; a fused projection's strided dim block by
    block, ``parallel.sharding.take``)."""
    from .parallel.sharding import take
    return np.asarray(take(src, idx))


@torch.no_grad()
def jax_state_dict(model: nn.Module):
    """The model's parameters and persistent buffers under the JAX
    package's names and layout (every ``Linear`` weight transposed to
    [in, out], its LoRA adapters to [in, r] and [r, out]), as CPU
    tensors of the model's dtypes: what the JAX package's
    ``model.state_dict()`` holds, for ``checkpoint.save``."""
    transposed = _transposed(model)
    return {name: (t.T if name in transposed else t).detach().cpu()
            .contiguous()
            for name, t in model.state_dict().items()}
