"""The module system (counterpart of ``paddle_tpu/nn/layer.py``:
``Layer``, ``Parameter``, ``Buffer``, ``ParamMeta``; reference:
python/paddle/nn/layer/layers.py).

``Layer`` is a ``torch.nn.Module`` under Paddle's names: sublayers,
parameters and buffers are the module's own, and the JAX ``Layer``'s
methods map onto torch's (``add_sublayer`` -> ``add_module``,
``register_buffer(persistable=)`` -> ``persistent=``,
``register_forward_post_hook`` -> ``register_forward_hook``).
``functional()`` is the JAX functional bridge on
``torch.func.functional_call``: it returns ``(pure_fn, params)``, and
``pure_fn(params, *args, generator=None)`` runs the forward with
``params`` bound, every dropout of the tree drawing from ``generator``
when one is given (the JAX ``rng=`` key).

Metadata. The JAX package keeps a ``ParamMeta`` (trainable, partition)
beside each parameter. Here a parameter's ``requires_grad`` is its
trainable flag and its ``partition`` attribute (``nn.common.set_partition``)
its partition; ``param_meta()`` reads both into ``ParamMeta`` records.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..dtypes import to_dtype
from ..utils import rng


@dataclass
class ParamMeta:
    """A parameter's metadata: trainable, and its partition (a mesh-axis
    name, a tuple of them or None, a dim)."""
    trainable: bool = True
    partition: Optional[Tuple[Optional[str], ...]] = None
    extras: dict = field(default_factory=dict)


class Parameter:
    """Declaration wrapper: assigning ``Parameter(value, trainable,
    partition)`` to a ``Layer`` attribute registers ``value`` as a
    ``torch.nn.Parameter`` with ``requires_grad = trainable`` and the
    partition; reading the attribute back gives that parameter."""

    __slots__ = ("value", "meta")

    def __init__(self, value, trainable=True, partition=None):
        self.value = torch.as_tensor(value)
        self.meta = ParamMeta(trainable=trainable, partition=partition)


class Buffer:
    """Declaration wrapper for registered state that is not trained
    (BatchNorm's running statistics); ``persistable`` buffers are in the
    state dict."""

    __slots__ = ("value", "persistable")

    def __init__(self, value, persistable=True):
        self.value = torch.as_tensor(value)
        self.persistable = persistable


def _as_parameter(value, trainable=True, partition=None):
    from .common import set_partition
    p = nn.Parameter(value.detach(), requires_grad=bool(trainable)
                     and (value.is_floating_point() or value.is_complex()))
    return set_partition(p, partition)


def _layer_device(layer, device):
    if device is not None:
        return torch.device(device)
    for t in layer.parameters():
        return t.device
    from ..device import resolve_device
    return resolve_device(None)


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None):
        super().__init__()
        self._name_scope = name_scope or type(self).__name__

    # -------------------------------------------------------- attr routing
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._buffers.pop(name, None)
            self._modules.pop(name, None)
            value = _as_parameter(value.value, value.meta.trainable,
                                  value.meta.partition)
        elif isinstance(value, Buffer):
            self._parameters.pop(name, None)
            self.__dict__.pop(name, None)
            self.register_buffer(name, value.value, value.persistable)
            return
        super().__setattr__(name, value)

    # ---------------------------------------------------------- registration
    def add_parameter(self, name: str, param) -> None:
        if isinstance(param, nn.Parameter):
            self.register_parameter(name, param)
            return
        if not isinstance(param, Parameter):
            param = Parameter(param)
        setattr(self, name, param)

    def add_sublayer(self, name: str, sublayer: nn.Module) -> nn.Module:
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        *, persistent: Optional[bool] = None) -> None:
        """Paddle's ``persistable`` (torch's ``persistent`` is taken too)."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(tensor)
        super().register_buffer(name, tensor, persistent=persistable)

    def create_parameter(self, shape, dtype="float32",
                         default_initializer=None, is_bias=False, attr=None,
                         *, device=None,
                         generator: Optional[torch.Generator] = None):
        """A new ``torch.nn.Parameter`` of ``shape`` (in the layout the
        caller uses it in, as in the JAX package: ``x @ w`` takes [in,
        out]), filled by ``default_initializer`` (else zeros for a bias,
        ``XavierNormal`` otherwise) from ``generator`` or the ambient
        stream's next one, on ``device`` (else this layer's parameters'
        device, else the card). Assign it to an attribute to register
        it."""
        from .initializer import Constant, XavierNormal
        init = default_initializer or (Constant(0.0) if is_bias
                                       else XavierNormal())
        device = _layer_device(self, device)
        t = torch.empty(tuple(shape), dtype=to_dtype(dtype), device=device)
        init(t, generator or rng.next_generator(device), jax_layout=True)
        return _as_parameter(t)

    # ------------------------------------------------------------- traversal
    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        for name, sub in self.named_modules(prefix=prefix):
            if sub is not self or include_self:
                yield name, sub

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def param_meta(self, prefix: str = "") -> Dict[str, ParamMeta]:
        from .common import partition_of
        return {name: ParamMeta(trainable=p.requires_grad,
                                partition=partition_of(p))
                for name, p in self.named_parameters(prefix=prefix)}

    def trainable_parameters(self) -> "OrderedDict[str, torch.Tensor]":
        return OrderedDict((k, v) for k, v in self.named_parameters()
                           if v.requires_grad)

    # ------------------------------------------------------------ state dict
    @torch.no_grad()
    def set_state_dict(self, state, strict: bool = True):
        """Copy ``state`` ({name: tensor or array}, the port's layouts)
        into the parameters and persistent buffers in place. With
        ``strict``, a missing or unexpected key raises ``KeyError``, as
        in the JAX package. Returns (missing, unexpected)."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state]
        unexpected = [k for k in state if k not in own]
        if strict and (missing or unexpected):
            raise KeyError(f"state_dict mismatch: missing={missing[:5]} "
                           f"unexpected={unexpected[:5]}")
        for key, value in state.items():
            if key in own:
                dst = own[key]
                dst.copy_(torch.as_tensor(value).to(dst.device, dst.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------------------ train/eval
    def stop_gradient_(self, value: bool = True):
        """Mark every parameter of the tree (non-)trainable."""
        for p in self.parameters():
            p.requires_grad_(not value)
        return self

    # ----------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, args, output)``; a non-None return replaces the
        output."""
        return self.register_forward_hook(hook)

    # ------------------------------------------------------ functional bridge
    def functional(self, with_buffers: bool = False):
        """``(pure_fn, params)``: ``pure_fn(params, *args,
        generator=None, **kwargs)`` runs the forward with ``params``
        ({dotted name: tensor}) bound in place of the parameters. Without
        buffers, the layer's buffers are left as they were (BatchNorm's
        running statistics do not move, as the JAX bridge restores them).
        With ``with_buffers``, ``pure_fn(params, buffers, *args)`` binds
        copies of ``buffers`` too and returns ``(out, new_buffers)``."""
        from .norm import running_stats_kept
        params = OrderedDict(self.named_parameters())
        if not with_buffers:
            def pure_fn(p, *args, generator=None, **kwargs):
                with rng.generator_context(generator), running_stats_kept():
                    return torch.func.functional_call(self, dict(p), args,
                                                      kwargs)
            return pure_fn, params

        names = [k for k, _ in self.state_dict(keep_vars=True).items()
                 if k not in params]
        buffers = OrderedDict((k, self.get_buffer(k)) for k in names)

        def pure_fn_b(p, b, *args, generator=None, **kwargs):
            new_b = OrderedDict((k, v.detach().clone()) for k, v in b.items())
            with rng.generator_context(generator):
                out = torch.func.functional_call(self, {**p, **new_b}, args,
                                                 kwargs)
            return out, new_b
        return pure_fn_b, (params, buffers)

    # ---------------------------------------------------------------- extras
    def to(self, *args, **kwargs):
        """``torch.nn.Module.to``, taking Paddle's dtype names too
        (``"float32"``, ``"bfloat16"``); floating tensors are cast."""
        args = tuple(to_dtype(a) if isinstance(a, str) and _is_dtype(a)
                     else a for a in args)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = to_dtype(kwargs["dtype"])
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=to_dtype(dtype))

    def full_name(self):
        return self._name_scope


def _is_dtype(name: str) -> bool:
    with contextlib.suppress(ValueError):
        to_dtype(name)
        return True
    return False
