"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``;
reference: python/paddle/amp/*.py).

bf16 has fp32's exponent range and needs no loss scaling. fp16 does:
``GradScaler`` scales the loss, unscales the gradients, finds
non-finite ones and moves the dynamic scale, with the JAX package's
rules. Its functional state (scale, growth tracker, NaN tracker) is a
dict of 0-dim tensors on the training device, so a step reads and moves
it without a host sync; a step whose gradients are not finite is skipped
by the optimizer on the device (``Optimizer.apply(found_inf=...)``,
the JAX trainer's ``GradScaler.select``).

``auto_cast`` (O1) makes the port's ``nn.functional.linear`` cast its
inputs to the AMP dtype; ``decorate`` (O2) casts a model's parameters
and gives its optimizers fp32 masters (``multi_precision``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..dtypes import to_dtype

__all__ = ["auto_cast", "amp_guard", "amp_dtype", "maybe_cast", "decorate",
           "GradScaler", "to_dtype"]

_amp_state = threading.local()


def _dtype():
    return getattr(_amp_state, "dtype", None)


@contextlib.contextmanager
def auto_cast(enable=True, dtype="bfloat16", level="O1",
              custom_white_list=None, custom_black_list=None):
    """Context in which ``linear`` casts its inputs to ``dtype``."""
    prev = _dtype()
    _amp_state.dtype = to_dtype(dtype) if enable else None
    _amp_state.level = level
    try:
        yield
    finally:
        _amp_state.dtype = prev


amp_guard = auto_cast


def amp_dtype():
    """The AMP dtype compute layers cast to; None when AMP is off."""
    return _dtype()


def maybe_cast(x):
    dt = _dtype()
    if dt is not None and torch.is_tensor(x) and x.is_floating_point():
        return x.to(dt)
    return x


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """paddle.amp.decorate: cast the models' parameters to ``dtype``; the
    optimizers keep fp32 masters (``multi_precision``)."""
    dt = to_dtype(dtype)
    single = False
    if models is not None and not isinstance(models, (list, tuple)):
        models, single = [models], True
    for m in models or []:
        m.to(dtype=dt)
    if optimizers is not None:
        opts = optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]
        for o in opts:
            o.multi_precision = True if master_weight is None \
                else master_weight
    if models is None:
        return optimizers
    out_models = models[0] if single else models
    if optimizers is None:
        return out_models
    return out_models, optimizers


def _values(grads):
    return list(grads.values()) if isinstance(grads, dict) else list(grads)


class GradScaler:
    """Loss scaling for fp16 (reference: python/paddle/amp/grad_scaler.py).
    ``enable=False`` makes every method a pass-through.

    Functional use inside a train step (no host sync anywhere)::

        sstate = scaler.init_state(device)
        scaled = scaler.scale(loss, sstate)
        ... gradients of scaled ...
        grads, found_inf = scaler.unscale(grads, sstate)
        sstate = scaler.update_state(sstate, found_inf)
        params = scaler.select(found_inf, skipped=old, applied=new)

    The eager ``step(optimizer, ...)`` / ``update()`` keep their own state
    and read ``found_inf`` on the host.
    """

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n = decr_every_n_nan_or_inf
        self.dynamic = use_dynamic_loss_scaling
        st = self.init_state("cpu")
        self._scale = st["scale"]
        self._growth_tracker = st["growth_tracker"]
        self._nan_tracker = st["nan_tracker"]

    def is_enable(self):
        return self._enable

    # ------------------------------------------------------- functional
    def init_state(self, device=None):
        """The scaler's state on ``device`` (the CUDA card when not given):
        {"scale": fp32, "growth_tracker": int32, "nan_tracker": int32}."""
        from ..device import resolve_device
        dev = resolve_device(device)
        return {"scale": torch.tensor(
                    self.init_loss_scaling if self._enable else 1.0,
                    dtype=torch.float32, device=dev),
                "growth_tracker": torch.zeros((), dtype=torch.int32,
                                              device=dev),
                "nan_tracker": torch.zeros((), dtype=torch.int32,
                                           device=dev)}

    def scale(self, loss, state=None):
        if not self._enable:
            return loss
        return loss * (self._scale if state is None else state["scale"])

    def inv_scale(self, state=None):
        """1 / scale, an fp32 tensor (what ``unscale`` multiplies by)."""
        return 1.0 / (self._scale if state is None else state["scale"])

    def found_inf(self, grads, inv):
        """A bool tensor: some unscaled gradient ``g * inv`` (in fp32, as
        the JAX package unscales) is not finite. Taken from the largest
        |g| alone, in one read of each gradient and without an fp32 copy:
        that element's product is the largest, so it overflows if any
        does, and a NaN or inf anywhere makes the maximum NaN or inf."""
        from ..parallel.sharding import is_sharded, local
        values = _values(grads)
        amax = torch.stack([torch.linalg.vector_norm(local(g),
                                                     ord=float("inf"))
                            .float() for g in values]).max()
        if any(is_sharded(g) for g in values):
            # every rank of the mesh skips the same steps
            from ..distributed.collective import _reduce_
            from ..distributed.env import HYBRID_AXES
            amax = _reduce_(amax, "max", HYBRID_AXES)
        return ~torch.isfinite(amax * inv)

    def unscale(self, grads, state=None):
        """(gradients times 1 / scale in fp32, found_inf as a bool
        tensor)."""
        if not self._enable:
            dev = _values(grads)[0].device if _values(grads) else "cpu"
            return grads, torch.zeros((), dtype=torch.bool, device=dev)
        inv = self.inv_scale(state)
        from ..parallel.sharding import map_local

        def un(g):
            return map_local(g, lambda t: t.float() * inv)
        if isinstance(grads, dict):
            unscaled = {k: un(g) for k, g in grads.items()}
        else:
            unscaled = type(grads)(un(g) for g in grads)
        return unscaled, self.found_inf(grads, inv)

    def update_state(self, state, found_inf):
        """paddle's update_loss_scaling, branchless: a bad step zeroes the
        good counter; the scale shrinks once ``decr_every_n`` bad steps
        have accumulated; a good step zeroes the bad counter; the scale
        grows after ``incr_every_n_steps`` good steps in a row."""
        if not (self._enable and self.dynamic):
            return state
        found_inf = torch.as_tensor(found_inf,
                                    device=state["scale"].device)
        growth = torch.where(found_inf, 0, state["growth_tracker"] + 1)
        nan = torch.where(found_inf, state["nan_tracker"] + 1, 0)
        decr = nan >= self.decr_every_n
        incr = growth >= self.incr_every_n_steps
        scale = (state["scale"]
                 * torch.where(decr, self.decr_ratio, 1.0).float()
                 * torch.where(incr, self.incr_ratio, 1.0).float())
        return {"scale": scale,
                "growth_tracker": torch.where(incr, 0, growth).int(),
                "nan_tracker": torch.where(decr, 0, nan).int()}

    @staticmethod
    def select(found_inf, skipped, applied):
        """``skipped`` (the old tensors) on an inf step, ``applied``
        otherwise, tensor by tensor through nested dicts."""
        if isinstance(skipped, dict):
            return {k: GradScaler.select(found_inf, skipped[k], applied[k])
                    for k in skipped}
        if torch.is_tensor(skipped):
            return torch.where(found_inf, skipped, applied)
        return applied

    # ------------------------------------------------ eager (host-synced)
    def update(self, found_inf=None):
        """Move the scaler's own state by one step (eager use)."""
        if not (self._enable and self.dynamic) or found_inf is None:
            return
        state = {"scale": self._scale,
                 "growth_tracker": self._growth_tracker,
                 "nan_tracker": self._nan_tracker}
        state = self.update_state(state, bool(found_inf))
        self._scale = state["scale"]
        self._growth_tracker = state["growth_tracker"]
        self._nan_tracker = state["nan_tracker"]

    def step(self, optimizer, layer=None, grads=None):
        """paddle's ``scaler.step(optimizer)``: unscale, skip the step when
        a gradient is not finite, then ``update``."""
        if grads is None:
            layer = layer or optimizer._layer
            grads = {k: p.grad for k, p in layer.named_parameters()
                     if p.requires_grad}
        grads, found_inf = self.unscale(grads)
        found = bool(found_inf)
        if not found:
            optimizer.step(grads=grads, layer=layer)
        self.update(found)

    def state_dict(self):
        return {"scale": float(self._scale),
                "growth_tracker": int(self._growth_tracker),
                "nan_tracker": int(self._nan_tracker)}

    def load_state_dict(self, sd):
        self._scale = torch.tensor(float(sd["scale"]), dtype=torch.float32)
        self._growth_tracker = torch.tensor(int(sd["growth_tracker"]),
                                            dtype=torch.int32)
        self._nan_tracker = torch.tensor(int(sd.get("nan_tracker", 0)),
                                         dtype=torch.int32)
