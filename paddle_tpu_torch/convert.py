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
      projections and ``lm_head``) is stored [in, out] by the JAX package
      and [out, in] here, so it is transposed. Everything else keeps its
      layout: embedding tables, norm weights, biases, and a
      ``QuantizedLinear``'s codes and scales, which are [din, dout] in
      both packages (it is not a ``Linear``). Nor are the MoE layers'
      parameters (``parallel.moe.MoEMLP``): the stacked experts
      ``w_gate``/``w_up`` [E, h, m] and ``w_down`` [E, m, h], the router
      ``gate`` [h, E], the ``shared_*`` projections and
      ``shared_expert_gate`` [h, 1] are plain parameters in the JAX
      layout in both packages, and are copied untransposed.
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
    - On a tp mesh, load into the whole model, then shard it
      (``parallel.sharding.shard_layer``): each rank keeps its shards.
    """
    own = model.state_dict(keep_vars=True)
    missing = [k for k in own if k not in params]
    unexpected = [k for k in params if k not in own]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing[:5]} "
                       f"unexpected={unexpected[:5]}")
    copy_jax_params(model, params, own)


def _transposed(model: nn.Module):
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules() if isinstance(mod, Linear)}


@torch.no_grad()
def copy_jax_params(model: nn.Module, params: Mapping[str, np.ndarray],
                    own=None) -> None:
    """Copy each of ``params`` into the model's tensor of that name, with
    :func:`load_jax_state_dict`'s transposes and casts, without its check
    that every key is there (``from_pretrained`` loads a checkpoint one
    shard at a time and checks the keys at the end)."""
    own = model.state_dict(keep_vars=True) if own is None else own
    transposed = _transposed(model)
    for name in params:
        dst = own[name]
        src = params[name]
        if torch.is_tensor(src):
            src = src.detach().cpu().float().numpy() \
                if src.is_floating_point() else src.cpu().numpy()
        src = np.asarray(src)
        value = torch.from_numpy(np.array(
            src, np.float32 if dst.is_floating_point() else src.dtype))
        if name in transposed:
            value = value.T
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} after "
                             f"conversion, model holds {tuple(dst.shape)}")
        dst.copy_(value.to(device=dst.device, dtype=dst.dtype))


@torch.no_grad()
def jax_state_dict(model: nn.Module):
    """The model's parameters and persistent buffers under the JAX
    package's names and layout (every ``Linear`` weight transposed to
    [in, out]), as CPU tensors of the model's dtypes: what the JAX
    package's ``model.state_dict()`` holds, for ``checkpoint.save``."""
    transposed = _transposed(model)
    return {name: (t.T if name in transposed else t).detach().cpu()
            .contiguous()
            for name, t in model.state_dict().items()}
