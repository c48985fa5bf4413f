"""Serving-time projection fusion (counterpart of ``paddle_tpu/nn/fuse.py``;
reference: PaddleNLP's ``fuse_attention_qkv`` / ``fuse_attention_ffn``
flags on the Llama family).

A decode step reads every weight once; q/k/v as three products (and
gate/up as two) are three (two) launches over small outputs.
``fuse_projections`` rewrites a loaded model in place: the q/k/v weights
become one ``qkv_proj`` of ``(nh + 2 * kvh) * d`` outputs and gate/up
one ``gate_up_proj`` of ``2 * ffn``; the attention and MLP forwards
split the single product (``models.llama.split_fused``).

tp-safe through a rank-interleaved order of the outputs, as in the JAX
package: with a ``tp`` degree T the fused outputs are
``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]``, ``x_t`` being rank t's head shard
of projection x, so the ``("tp", None)`` partition puts exactly
``q_t|k_t|v_t`` on rank t, the columns the unfused layout puts there,
and the split never crosses a shard. T is recorded on the module
(``_fused_tp``); T == 1 is the plain concat. The port's Linear weights
are [out, in], so the interleave runs along dim 0 (the JAX package's
[in, out] weights interleave along dim 1); a quantized layer's codes and
scales are [in, out] in both packages and interleave along dim 1.

The families whose checkpoints are fused already (GPT, BERT, ERNIE,
ViT, CLIP, DiT: one qkv of [q; k; v]) keep that layout and get the same
rank order from the sharding instead: their qkv weight and bias are
tagged as three blocks (``nn.common.set_fused``), and a tp split cuts
each block apart (a strided DTensor shard), so rank t computes on
``q_t|k_t|v_t`` while ``state_dict`` and checkpoints read the JAX order.

On a model already sharded over tp, each rank's fused shard is the
concat of its own shards (no collective), and a model bound by
``parallel.sharding.bind_static`` is bound again. A fused layer is built
from the weights alone, as in the JAX package: a merged LoRA adapter
(``peft.merge_lora``) survives the fusion, an unmerged one goes with the
unfused layers, so merge first. Apply after loading
and after quantization (the pass consumes the unfused weights), and
after the serving mesh is installed (the layout bakes in T).
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.env import axis_degree
from ..parallel.layers import ColumnParallelLinear
from ..parallel.sharding import (bind_static, is_sharded, is_static_bound,
                                 local)
from .common import set_partition

__all__ = ["fuse_projections"]


def _interleave(ws, tp: int, dim: int = 0):
    """Concat ``ws`` along ``dim`` rank-interleaved: each split into
    ``tp`` chunks along ``dim``, chunk t of every tensor together."""
    if tp == 1:
        return torch.cat(ws, dim=dim)
    for w in ws:
        if w.shape[dim] % tp:
            raise ValueError(
                f"fuse_projections: out dim {w.shape[dim]} not divisible "
                f"by tp degree {tp}; keep the unfused layout")
    return torch.cat([c for t in range(tp)
                      for c in (w.chunk(tp, dim=dim)[t] for w in ws)],
                     dim=dim)


def _interleave_bias(bs, tp: int):
    return _interleave(bs, tp, 0)


def _fused_param(params, tp: int):
    """The fused [sum out, in] weight (or [sum out] bias) of ``params``:
    a DTensor sharded as the sources are, its local shard the concat of
    theirs, when they are sharded; else the full interleave."""
    if not is_sharded(params[0]):
        return nn.Parameter(_interleave([p.detach() for p in params], tp),
                            requires_grad=False)
    from torch.distributed.tensor import DTensor
    src = params[0]
    shape = (sum(p.shape[0] for p in params),) + tuple(src.shape[1:])
    loc = torch.cat([local(p).detach() for p in params], dim=0)
    return nn.Parameter(DTensor.from_local(loc, src.device_mesh,
                                           src.placements, run_check=False,
                                           shape=torch.Size(shape),
                                           stride=loc.stride()),
                        requires_grad=False)


def _fuse_linears(mods, tp: int):
    """One ColumnParallelLinear (outputs left split) over the outputs of
    the column-parallel ``mods``, which share their input."""
    ws = [m._parameters["weight"] for m in mods]
    fused = ColumnParallelLinear.__new__(ColumnParallelLinear)
    nn.Module.__init__(fused)
    fused.in_features = mods[0].in_features
    fused.out_features = sum(m.out_features for m in mods)
    fused.gather_output = False
    fused.weight = set_partition(_fused_param(ws, tp), ("tp", None))
    fused.bias = None
    if mods[0]._parameters.get("bias") is not None:
        fused.bias = set_partition(
            _fused_param([m._parameters["bias"] for m in mods], tp),
            ("tp",))
    return fused


def _fuse_quantized(mods, tp: int):
    """One QuantizedLinear over the column-parallel quantized ``mods``:
    codes and scales [in, out] interleaved along out (a tp rank's shards
    concatenated as they are)."""
    from ..quant.weight_only import QuantizedLinear
    first = mods[0]
    n = 1 if getattr(first, "_buffers_sharded", False) else tp

    def cat(name, dim):
        vals = [getattr(m, name) for m in mods]
        if vals[0] is None:
            return None
        return _interleave(vals, n, dim)

    fused = QuantizedLinear(
        cat("qweight", 1), cat("scales", 1), cat("bias", 0), first.bits,
        first.block_size, weight_partition=("tp", None),
        bias_partition=("tp",) if first.bias is not None else None,
        output_parallel_axis="tp", in_features=first.in_features,
        out_features=sum(m.out_features for m in mods))
    fused._buffers_sharded = getattr(first, "_buffers_sharded", False)
    return fused


def _fuse(mods, tp: int):
    from ..quant.weight_only import QuantizedLinear
    if all(isinstance(m, QuantizedLinear) for m in mods):
        if len({(m.bits, m.block_size) for m in mods}) != 1:
            raise ValueError("fuse_projections: quantized projections "
                             "of different bits or block sizes")
        return _fuse_quantized(mods, tp)
    if any(isinstance(m, QuantizedLinear) for m in mods):
        raise ValueError("fuse_projections: some projections of a block "
                         "are quantized and some are not")
    return _fuse_linears(mods, tp)


def fuse_projections(model, attention: bool = True, mlp: bool = True):
    """Fuse the q/k/v (and gate/up) projections of every Llama-family
    block of ``model`` in place; returns the model. Idempotent. The
    installed mesh's tp degree is baked into the fused order (module
    docstring); heads and ``intermediate_size`` that it does not divide
    raise ``ValueError`` before anything changes."""
    tp = axis_degree("tp")
    if tp > 1:
        # validate before mutating: a failure halfway would leave the
        # model half fused, its unfused weights already gone
        cfg = model.config
        if attention and (cfg.num_attention_heads % tp
                          or cfg.num_key_value_heads % tp):
            raise ValueError(
                f"fuse_projections: heads ({cfg.num_attention_heads}q/"
                f"{cfg.num_key_value_heads}kv) not divisible by tp "
                f"degree {tp}")
        if mlp and cfg.intermediate_size % tp:
            raise ValueError(
                f"fuse_projections: intermediate_size "
                f"{cfg.intermediate_size} not divisible by tp degree {tp}")
    for layer in getattr(model, "model", model).layers:
        attn = getattr(layer, "self_attn", None)
        if attention and attn is not None and \
                hasattr(attn, "q_proj") and not hasattr(attn, "qkv_proj"):
            attn.qkv_proj = _fuse([attn.q_proj, attn.k_proj, attn.v_proj],
                                  tp)
            attn._fused_tp = tp
            del attn.q_proj, attn.k_proj, attn.v_proj
        mlp_mod = getattr(layer, "mlp", None)
        if mlp and mlp_mod is not None and \
                hasattr(mlp_mod, "gate_proj") and \
                not hasattr(mlp_mod, "gate_up_proj"):
            mlp_mod.gate_up_proj = _fuse([mlp_mod.gate_proj,
                                          mlp_mod.up_proj], tp)
            mlp_mod._fused_tp = tp
            del mlp_mod.gate_proj, mlp_mod.up_proj
    if is_static_bound(model):
        bind_static(model)
    return model
