"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

The functional core of the JAX package, over dicts of tensors keyed by
parameter name:

    state = opt.init(params)
    params, state = opt.apply(params, grads, state, step)

PyTorch idiom inside: ``apply`` updates the parameters and the state IN
PLACE under ``torch.no_grad()`` (the JAX package returns new arrays and
donates the old ones) and returns the same objects. The state's slots are
fp32. With ``multi_precision=True`` the state also keeps an fp32 master
copy of each parameter: the update runs on the master and the parameter
(bf16, say) receives the master cast down, as the JAX package does.

The stateful paddle facade: ``Optimizer(parameters=module)`` then
``opt.step()`` after ``loss.backward()`` reads each trainable parameter's
``.grad``; ``clear_grad()`` drops them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from .clip import GradClipBase
from .lr import LRScheduler


def _lr_value(lr, step) -> float:
    if isinstance(lr, LRScheduler):
        return float(lr.value_at(step))
    return float(lr)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=0.0,
                 grad_clip: Optional[GradClipBase] = None,
                 multi_precision=False, name=None):
        self._lr = learning_rate
        self.weight_decay = weight_decay or 0.0
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self._layer = (parameters if isinstance(parameters, torch.nn.Module)
                       else None)
        self._step_count = 0
        self._state = None

    # ---- functional core -------------------------------------------------
    @torch.no_grad()
    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        slots = {k: self._init_slot(p) for k, p in params.items()}
        if self.multi_precision:
            # a copy even for fp32 parameters: the master must never alias
            # the parameter it is cast into
            master = {k: p.detach().to(torch.float32, copy=True)
                      for k, p in params.items()}
            return {"slots": slots, "master": master}
        return {"slots": slots}

    @torch.no_grad()
    def apply(self, params, grads, state, step):
        """One update of ``params`` (a dict of tensors) by ``grads`` (the
        same keys), in place. ``grad_clip`` runs first (it may scale the
        grads in place). ``step`` is the 0-based step the LR schedule and
        the bias corrections read."""
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        lr = _lr_value(self._lr, step)
        master = state.get("master")
        for name, p in params.items():
            work = master[name] if master is not None else p.detach().float()
            self._update(name, work, grads[name], state["slots"][name], lr,
                         step)
            if master is not None or work.data_ptr() != p.data_ptr():
                p.detach().copy_(work)
        return params, state

    def _init_slot(self, p):
        raise NotImplementedError

    def _update(self, name, w, g, slot, lr, step):
        """Update the fp32 working copy ``w`` in place."""
        raise NotImplementedError

    # ---- stateful paddle facade -----------------------------------------
    def _trainable(self, layer) -> Dict[str, torch.Tensor]:
        return {k: p for k, p in layer.named_parameters() if p.requires_grad}

    def step(self, grads=None, layer=None):
        layer = layer or self._layer
        if layer is None:
            raise ValueError("pass parameters=module at construction or "
                             "layer= here")
        params = self._trainable(layer)
        if grads is None:
            grads = {k: p.grad for k, p in params.items()}
            missing = [k for k, g in grads.items() if g is None]
            if missing:
                raise ValueError(f"no .grad for {missing[:5]}: call "
                                 f"backward() before step()")
        if self._state is None:
            self._state = self.init(params)
        # a manually driven LRScheduler (scheduler.step()) governs the lr
        if isinstance(self._lr, LRScheduler):
            step_arg = max(self._lr.last_epoch, 0)
        else:
            step_arg = self._step_count
        self.apply(params, {k: grads[k] for k in params}, self._state,
                   step_arg)
        self._step_count += 1

    def clear_grad(self, layer=None):
        layer = layer or self._layer
        if layer is not None:
            for p in layer.parameters():
                p.grad = None

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr.get_lr()
        return float(self._lr)

    def set_lr(self, lr):
        self._lr = lr


class SGD(Optimizer):
    def _init_slot(self, p):
        return None

    def _update(self, name, w, g, slot, lr, step):
        g = g.float()
        if self.weight_decay:
            g = g + self.weight_decay * w
        w.sub_(lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=0.0, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_slot(self, p):
        return torch.zeros_like(p, dtype=torch.float32)

    def _update(self, name, w, g, v, lr, step):
        g = g.float()
        if self.weight_decay:
            g = g + self.weight_decay * w
        v.mul_(self.momentum).add_(g)
        delta = g + self.momentum * v if self.use_nesterov else v
        w.sub_(lr * delta)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.apply_decay_param_fun = apply_decay_param_fun
        self._decoupled = False  # Adam: L2 regularisation in the gradient

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        t = float(step) + 1.0
        bc1 = 1.0 - self.beta1 ** t
        bc2 = 1.0 - self.beta2 ** t
        decay = bool(self.weight_decay) and (
            self.apply_decay_param_fun is None
            or self.apply_decay_param_fun(name))
        g = g.float()
        if decay and not self._decoupled:
            g = g + self.weight_decay * w
        m, v = s["m"], s["v"]
        m.lerp_(g, 1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        # w -= lr * (m / bc1) / (sqrt(v / bc2) + eps), rearranged so that
        # it takes three passes over memory (sqrt, add, addcdiv): the
        # update is bound by the bytes it moves
        root_bc2 = math.sqrt(bc2)
        denom = v.sqrt().add_(self.epsilon * root_bc2)
        if decay and self._decoupled:
            w.mul_(1 - lr * self.weight_decay)
        w.addcdiv_(m, denom, value=-lr * root_bc2 / bc1)


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py).
    ``apply_decay_param_fun(name) -> bool`` picks the parameters that
    decay (all of them when not given)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False, lr_ratio=None,
                 apply_decay_param_fun=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, False, multi_precision,
                         name, apply_decay_param_fun)
        self._decoupled = True
