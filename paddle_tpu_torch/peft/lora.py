"""LoRA low-rank adaptation (counterpart of ``paddle_tpu/peft/lora.py``;
reference: PaddleNLP ``paddlenlp/peft/lora``: LoRAConfig, LoRAModel,
LoRALinear and its column and row parallel forms).

As in the JAX package, the adapter is injected into the existing layer
instance: two ``nn.Parameter``s, ``lora_A`` and ``lora_B``, and a forward
hook that adds the low-rank delta. The base names (``...q_proj.weight``)
stay as they are, so checkpoints, ``from_pretrained``, the partitions and
the optimizer layout keep working; ``...q_proj.lora_A`` appears beside
them.

Layout. The port's ``Linear`` stores its weight [out, in], and the
adapters follow it: ``lora_A`` is [r, in] and ``lora_B`` [out, r], so

    delta = (x @ A.T) @ B.T * scaling,   merged W = W + (B @ A) * scaling.

The JAX package stores them [in, r] and [r, out]. ``convert`` transposes
both on the way in and out (``load_jax_state_dict``, ``jax_state_dict``),
and ``LoRAModel.save_pretrained`` writes the JAX layout, so an adapter
file written by either package loads in the other.

Tensor parallel. The adapters' partitions follow the base weight's, as
the JAX ``_adapter_partitions`` derives them (here in the port's layout):

    W ("tp", None)  column-parallel -> A replicated,   B ("tp", None)
    W (None, "tp")  row-parallel    -> A (None, "tp"), B replicated

and ``parallel.sharding`` splits them as it splits the weight. The hook
writes out the collectives the JAX package leaves to GSPMD: in a column
layer the [.., r] product enters ``copy_to`` (each rank's B shard sees
only its own columns, so that product's gradient is summed over tp) and a
gathered layer's delta is gathered; in a row layer each rank's partial
[.., r] product is summed over tp (``reduce_from``) before B.

Freezing is ``requires_grad=False`` on everything but the adapters (and
the biases ``bias`` asks for): the Trainer gives frozen parameters no
gradient and no optimizer state.

Dropout on the adapter's input draws from the ``torch.Generator`` given
to :func:`apply_lora` (the JAX package folds its key with the step
number), so its masks match the JAX ones in distribution only.

Merging adds (B @ A) * scaling in fp32 into the weight and casts back to
its dtype, in place (the weight keeps its storage), and removes the hook;
unmerging subtracts it and puts the hook back. A captured decode program
(``generation.graphs``) records each module's hooks, so a merge or an
unmerge after a capture drops the captured programs instead of replaying
the adapter's captured delta over a merged weight.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..distributed.collective import axis_size
from ..nn import functional as F
from ..nn.common import Linear, partition_of, set_partition
from ..nn.initializer import KaimingUniform
from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                               _Gather, _Split, copy_to, reduce_from)
from ..parallel.sharding import (bind_static, full_tensor, is_static_bound,
                                 local, local_shard)
from ..utils.rng import make_generator

LORA_NAMES = ("lora_A", "lora_B")


@dataclass
class LoRAConfig:
    """Reference: paddlenlp.peft.LoRAConfig (the subset that matters)."""
    r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.0
    # regexes matched against full module paths (PaddleNLP semantics:
    # ".*q_proj" targets every attention query projection)
    target_modules: Sequence[str] = field(
        default_factory=lambda: [".*q_proj", ".*v_proj"])
    trainable_bias: bool = False
    rslora: bool = False  # scale by alpha/sqrt(r) instead of alpha/r

    @property
    def scaling(self) -> float:
        return self.lora_alpha / (self.r ** 0.5 if self.rslora else self.r)

    def save_pretrained(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "lora_config.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_pretrained(cls, path: str) -> "LoRAConfig":
        with open(os.path.join(path, "lora_config.json")) as f:
            return cls(**json.load(f))


def _adapter_partitions(layer: nn.Module):
    """(A, B) partitions, in the port's layout, from the base weight's."""
    part = partition_of(layer._parameters.get("weight"))
    if part == ("tp", None):        # column-parallel: out dim split
        return None, ("tp", None)
    if part == (None, "tp"):        # row-parallel: in dim split
        return (None, "tp"), None
    return None, None


def _lora_hook(layer, args, result):
    """Forward hook: result + dropout(x) @ A.T @ B.T * scaling, with the
    tp collectives of the module docstring. A merge removes it."""
    x = args[0]
    p = layer._lora_dropout_p
    if p > 0.0 and layer.training:
        keep = torch.empty_like(x).bernoulli_(
            1.0 - p, generator=layer._lora_generator)
        x = x * keep / (1.0 - p)
    a, b = layer.lora_A, layer.lora_B
    x = x.to(a.dtype)
    tp = axis_size("tp")
    if tp > 1 and isinstance(layer, RowParallelLinear):
        if not layer.input_is_parallel:
            x = _Split.apply(x)
        h = reduce_from(F.linear(x, a), "tp")
    elif tp > 1 and isinstance(layer, ColumnParallelLinear):
        h = copy_to(F.linear(x, a), "tp")
    else:
        h = F.linear(x, a)
    delta = F.linear(h, b) * layer._lora_scaling
    if tp > 1 and isinstance(layer, ColumnParallelLinear) \
            and layer.gather_output:
        delta = _Gather.apply(delta)
    return result + delta.to(result.dtype)


def _set_hook(layer, on: bool) -> None:
    hooks = layer._forward_hooks
    for k in [k for k, fn in hooks.items() if fn is _lora_hook]:
        del hooks[k]
    if on:
        layer.register_forward_hook(_lora_hook)


@torch.no_grad()
def inject_lora(layer: nn.Module, config: LoRAConfig,
                generator: Optional[torch.Generator] = None,
                name: str = "") -> None:
    """Attach a LoRA adapter to one Linear-family layer in place. A is
    drawn Kaiming-uniform from ``generator`` (a seed-0 one on the
    weight's device when None), B is zero: the adapted layer is exactly
    the base layer until B moves. On a model already sharded, call
    ``parallel.sharding.shard_layer`` again after (it splits the new
    adapters)."""
    if "lora_A" in layer._parameters:
        raise ValueError(f"{name or type(layer).__name__}: LoRA already "
                         f"injected")
    weight = layer._parameters["weight"]
    dev, dt = local(weight).device, weight.dtype
    gen = generator if generator is not None else make_generator(0, dev)
    part_a, part_b = _adapter_partitions(layer)
    a = torch.empty((config.r, layer.in_features), device=dev, dtype=dt)
    KaimingUniform()(a, gen)
    layer.lora_A = set_partition(nn.Parameter(a), part_a)
    layer.lora_B = set_partition(nn.Parameter(torch.zeros(
        (layer.out_features, config.r), device=dev, dtype=dt)), part_b)
    layer._lora_scaling = config.scaling
    layer._lora_dropout_p = config.lora_dropout
    layer._lora_generator = gen
    layer._lora_merged = False
    _set_hook(layer, True)


def apply_lora(model: nn.Module, config: LoRAConfig,
               generator: Optional[torch.Generator] = None) -> List[str]:
    """Inject adapters into every module whose path matches one of
    ``target_modules``, in module order, all drawn from ``generator``;
    then freeze everything except the adapters. Returns the paths."""
    pats = [re.compile(p + r"\Z") for p in config.target_modules]
    hit, skipped = [], []
    for path, sub in model.named_modules():
        if not path or not any(p.match(path) for p in pats):
            continue
        # isinstance, not the class name: every Linear subclass adapts
        # (Column / RowParallelLinear included; the hook needs forward(x)
        # -> y and in/out_features)
        if isinstance(sub, Linear):
            if generator is None:
                generator = make_generator(
                    0, local(sub._parameters["weight"]).device)
            inject_lora(sub, config, generator, name=path)
            hit.append(path)
        else:
            skipped.append(path)
    if skipped:
        warnings.warn(f"apply_lora: target_modules matched non-Linear "
                      f"modules, skipped: {skipped[:5]}", stacklevel=2)
    if not hit:
        raise ValueError(
            f"target_modules {list(config.target_modules)} matched nothing")
    mark_only_lora_as_trainable(model, bias="lora_only"
                                if config.trainable_bias else "none")
    return hit


def _is_lora_name(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in LORA_NAMES


def mark_only_lora_as_trainable(model: nn.Module, bias: str = "none"):
    """bias: "none" | "lora_only" | "all" (PaddleNLP semantics)."""
    named = list(model.named_parameters())
    lora_layers = {k.rsplit(".", 1)[0] for k, _ in named
                   if _is_lora_name(k)}
    for name, p in named:
        on = _is_lora_name(name) or (name.endswith(".bias") and (
            bias == "all" or (bias == "lora_only"
                              and name.rsplit(".", 1)[0] in lora_layers)))
        p.requires_grad_(on)


def lora_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The adapter parameters by name, in the port's layout (A [r, in],
    B [out, r]; a sharded model's as DTensors)."""
    return {k: v for k, v in model.named_parameters() if _is_lora_name(k)}


def _lora_layers(model: nn.Module):
    for path, sub in model.named_modules():
        if "lora_A" in sub._parameters:
            yield path, sub


@torch.no_grad()
def _fold(model: nn.Module, merge: bool) -> None:
    for _, sub in _lora_layers(model):
        if sub._lora_merged == merge:
            continue
        w = sub._parameters["weight"]
        a = full_tensor(sub._parameters["lora_A"]).float()
        b = full_tensor(sub._parameters["lora_B"]).float()
        delta = local_shard((b @ a) * sub._lora_scaling, w)
        wl = local(w)
        wl.copy_((wl.float() + delta if merge
                  else wl.float() - delta).to(wl.dtype))
        sub._lora_merged = merge
        _set_hook(sub, not merge)
    if is_static_bound(model):
        bind_static(model)


def merge_lora(model: nn.Module) -> None:
    """Fold every adapter into its base weight (W += B @ A * scaling, in
    fp32, cast back) in place, so inference pays nothing for the
    adapters. Idempotent."""
    _fold(model, True)


def unmerge_lora(model: nn.Module) -> None:
    """Undo :func:`merge_lora` (W -= B @ A * scaling); the weight comes
    back within one rounding of its dtype."""
    _fold(model, False)


class LoRAModel:
    """Thin facade mirroring paddlenlp.peft.LoRAModel: wraps a base model,
    injects adapters, saves and loads ONLY the adapter weights. Attribute
    access goes to the wrapped model, whose parameter names are
    unchanged (module docstring)."""

    def __init__(self, model: nn.Module, config: LoRAConfig,
                 generator: Optional[torch.Generator] = None):
        object.__setattr__(self, "model", model)
        object.__setattr__(self, "lora_config", config)
        object.__setattr__(self, "injected",
                           apply_lora(model, config, generator))

    def __getattr__(self, name):
        # through __dict__: during deepcopy / unpickling the instance dict
        # is empty and self.model would recurse into __getattr__
        model = self.__dict__.get("model")
        if model is None:
            raise AttributeError(name)
        return getattr(model, name)

    def __call__(self, *args, **kwargs):
        return self.model(*args, **kwargs)

    def save_pretrained(self, path: str):
        """``lora_config.json`` and ``lora_weights.pdparams`` (an npz of
        the adapters in the JAX layout, ``checkpoint.save``'s format)."""
        from ..checkpoint import save
        os.makedirs(path, exist_ok=True)
        self.lora_config.save_pretrained(path)
        save({k: full_tensor(v).detach().T.contiguous().cpu()
              for k, v in lora_state_dict(self.model).items()},
             os.path.join(path, "lora_weights.pdparams"))

    @classmethod
    def from_pretrained(cls, model: nn.Module, path: str) -> "LoRAModel":
        from ..checkpoint import load
        from ..convert import copy_jax_params
        config = LoRAConfig.from_pretrained(path)
        obj = cls(model, config)
        weights = load(os.path.join(path, "lora_weights.pdparams"))
        want = set(lora_state_dict(model))
        got = set(weights)
        if got != want:
            # the base parameters are rightly absent from the file; a
            # mismatch on the adapter set means it does not fit this model
            raise KeyError(
                f"adapter weights do not match the injected adapters: "
                f"missing={sorted(want - got)[:4]} "
                f"unexpected={sorted(got - want)[:4]}")
        copy_jax_params(model, weights)
        return obj

    def merge(self):
        merge_lora(self.model)

    def unmerge(self):
        unmerge_lora(self.model)
