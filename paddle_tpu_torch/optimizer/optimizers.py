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

Adam and AdamW update every tensor in one fused pass
(``ops/kernels/fused_adam.py``: one CUDA launch a step on a card, its
plain version on the CPU); ``ClipGradByGlobalNorm`` hands that pass its
scale instead of scaling the gradients. The other optimizers update
tensor by tensor in torch ops. ``apply(..., inv_scale=, found_inf=)``
takes a ``GradScaler``'s device scalars: the gradients are unscaled
first, and a step with ``found_inf`` set leaves parameters and state as
they were (the JAX trainer's ``GradScaler.select``), with no host sync.

The stateful paddle facade: ``Optimizer(parameters=module)`` then
``opt.step()`` after ``loss.backward()`` reads each trainable parameter's
``.grad``; ``clear_grad()`` drops them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops.kernels.fused_adam import fused_adam
from .clip import ClipGradByGlobalNorm, GradClipBase
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
    def apply(self, params, grads, state, step, inv_scale=None,
              found_inf=None):
        """One update of ``params`` (a dict of tensors) by ``grads`` (the
        same keys), in place. ``step`` is the 0-based step the LR schedule
        and the bias corrections read. With a GradScaler's ``inv_scale``
        the gradients are unscaled to fp32 first; ``grad_clip`` runs next
        (it may scale the grads in place); a set ``found_inf`` (a device
        bool) keeps every parameter and state tensor as it was."""
        if inv_scale is not None:
            grads = {k: g.float() * inv_scale for k, g in grads.items()}
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        lr = _lr_value(self._lr, step)
        master = state.get("master")
        held = _state_tensors(params, state) if found_inf is not None \
            else []
        before = [t.clone() for t in held]
        for name, p in params.items():
            work = master[name] if master is not None else p.detach().float()
            self._update(name, work, grads[name], state["slots"][name], lr,
                         step)
            if master is not None or work.data_ptr() != p.data_ptr():
                p.detach().copy_(work)
        for t, old in zip(held, before):
            t.copy_(torch.where(found_inf, old, t))
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

    def state_dict(self):
        return {"state": self._state, "step": self._step_count}

    def set_state_dict(self, sd):
        self._state = sd["state"]
        self._step_count = int(sd["step"])


def _state_tensors(params, state):
    """Every tensor ``apply`` may write: the parameters, the masters and
    the slots."""
    out = [p.detach() for p in params.values()]

    def walk(x):
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(state.get("master"))
    walk(state["slots"])
    return out


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
        # the fused pass's device table, kept between steps
        self._fused_cache: Dict[str, Any] = {}

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _decays(self, name) -> bool:
        return bool(self.weight_decay) and (
            self.apply_decay_param_fun is None
            or self.apply_decay_param_fun(name))

    @torch.no_grad()
    def apply(self, params, grads, state, step, inv_scale=None,
              found_inf=None):
        """The update of every tensor in one fused pass (see the module
        docstring); the arguments are the base class's."""
        names = list(params)
        clip_scale = None
        if isinstance(self.grad_clip, ClipGradByGlobalNorm):
            clip_scale = self.grad_clip.scale(grads, inv_scale)
        elif self.grad_clip is not None:
            if inv_scale is not None:
                grads = {k: g.float() * inv_scale for k, g in grads.items()}
                inv_scale = None
            grads = self.grad_clip(grads)
        master = state.get("master")
        slots = state["slots"]
        fused_adam(
            [params[k].detach() for k in names], [grads[k] for k in names],
            [master[k] for k in names] if master is not None else None,
            [slots[k]["m"] for k in names], [slots[k]["v"] for k in names],
            [self._decays(k) for k in names],
            lr=_lr_value(self._lr, step), beta1=self.beta1,
            beta2=self.beta2, eps=self.epsilon,
            weight_decay=self.weight_decay, decoupled=self._decoupled,
            step=step, clip_scale=clip_scale, inv_scale=inv_scale,
            found_inf=found_inf, cache=self._fused_cache)
        return params, state


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


# ------------------------------------------------ tensor-by-tensor updates
# The JAX package's formulas, op for op in fp32; host scalars that the JAX
# package computes from an fp32 step are computed in np.float32 here.
_f32 = np.float32


def _t(step):
    return _f32(step) + _f32(1.0)


def _l2(opt, g, w):
    g = g.float()
    return g + opt.weight_decay * w if opt.weight_decay else g


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=0.0, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _init_slot(self, p):
        return torch.full_like(p, self.initial_accumulator_value,
                               dtype=torch.float32)

    def _update(self, name, w, g, acc, lr, step):
        g = _l2(self, g, w)
        acc.add_(g * g)
        w.sub_(lr * g / (acc.sqrt() + self.epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=0.0, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _init_slot(self, p):
        s = {"ms": torch.zeros_like(p, dtype=torch.float32),
             "mom": torch.zeros_like(p, dtype=torch.float32)}
        if self.centered:
            s["mg"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _update(self, name, w, g, s, lr, step):
        g = _l2(self, g, w)
        s["ms"].copy_(self.rho * s["ms"] + (1 - self.rho) * (g * g))
        if self.centered:
            s["mg"].copy_(self.rho * s["mg"] + (1 - self.rho) * g)
            denom = (s["ms"] - s["mg"] * s["mg"] + self.epsilon).sqrt()
        else:
            denom = (s["ms"] + self.epsilon).sqrt()
        s["mom"].copy_(self.momentum * s["mom"] + lr * g / denom)
        w.sub_(s["mom"])


class Lamb(Optimizer):
    """Layer-wise adaptive moments (reference:
    python/paddle/optimizer/lamb.py)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        t = _t(step)
        bc1 = float(_f32(1.0) - _f32(self.beta1) ** t)
        bc2 = float(_f32(1.0) - _f32(self.beta2) ** t)
        g = g.float()
        s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * g)
        s["v"].copy_(self.beta2 * s["v"] + (1 - self.beta2) * (g * g))
        r = (s["m"] / bc1) / ((s["v"] / bc2).sqrt() + self.epsilon)
        if self.weight_decay and not (self.exclude_fn
                                      and self.exclude_fn(name)):
            r = r + self.weight_decay * w
        w_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        w.sub_(lr * trust * r)


class Adafactor(Optimizer):
    """Memory-factored second moments (row/column factors for matrices)."""

    def __init__(self, learning_rate=0.001, beta1=None, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1 = beta1
        self.decay_rate = decay_rate
        self.eps1, self.eps2 = epsilon1, epsilon2
        self.clip_threshold = clip_threshold

    def _init_slot(self, p):
        s = {}
        if p.dim() >= 2:
            s["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                  device=p.device)
            s["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                  dtype=torch.float32, device=p.device)
        else:
            s["v"] = torch.zeros_like(p, dtype=torch.float32)
        if self.beta1 is not None:
            s["m"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _update(self, name, w, g, s, lr, step):
        rho = _f32(1.0) - _t(step) ** _f32(-self.decay_rate)
        omr = float(_f32(1.0) - rho)
        rho = float(rho)
        g = g.float()
        g2 = g * g + self.eps1
        if w.dim() >= 2:
            s["vr"].copy_(rho * s["vr"] + omr * g2.mean(dim=-1))
            s["vc"].copy_(rho * s["vc"] + omr * g2.mean(dim=-2))
            vr = s["vr"]
            denom = (vr / vr.mean(dim=-1, keepdim=True))[..., None] \
                * s["vc"][..., None, :]
            update = g * torch.rsqrt(denom + self.eps1)
        else:
            s["v"].copy_(rho * s["v"] + omr * g2)
            update = g * torch.rsqrt(s["v"] + self.eps1)
        rms = (update * update).mean().sqrt()
        update = update / torch.clamp(rms / self.clip_threshold, min=1.0)
        if self.beta1 is not None:
            s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * update)
            update = s["m"]
        if self.weight_decay:
            update = update + self.weight_decay * w
        scaled_lr = lr * torch.clamp((w * w).mean().sqrt(), min=self.eps2)
        w.sub_(scaled_lr * update)


class Adadelta(Optimizer):
    """reference: python/paddle/optimizer/adadelta.py."""

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.rho, self.epsilon = rho, epsilon

    def _init_slot(self, p):
        return {"avg_sq": torch.zeros_like(p, dtype=torch.float32),
                "acc_delta": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        g = _l2(self, g, w)
        s["avg_sq"].copy_(self.rho * s["avg_sq"] + (1 - self.rho) * (g * g))
        delta = (s["acc_delta"] + self.epsilon).sqrt() \
            / (s["avg_sq"] + self.epsilon).sqrt() * g
        s["acc_delta"].copy_(self.rho * s["acc_delta"]
                             + (1 - self.rho) * (delta * delta))
        w.sub_(lr * delta)


class Adamax(Optimizer):
    """Adam with the infinity norm (reference:
    python/paddle/optimizer/adamax.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "u": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        bc1 = float(_f32(1.0) - _f32(self.beta1) ** _t(step))
        g = _l2(self, g, w)
        s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * g)
        torch.maximum(self.beta2 * s["u"], g.abs(), out=s["u"])
        w.sub_(lr * ((s["m"] / bc1) / (s["u"] + self.epsilon)))


class NAdam(Optimizer):
    """Nesterov Adam (reference: python/paddle/optimizer/nadam.py; Dozat
    2016, with the mu-product momentum schedule)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=0.0, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.momentum_decay = momentum_decay

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32),
                "mu_prod": torch.ones((), dtype=torch.float32,
                                      device=p.device)}

    def _update(self, name, w, g, s, lr, step):
        t = _t(step)
        md, half = _f32(self.momentum_decay), _f32(0.5)
        mu_t = _f32(self.beta1) * (_f32(1.0) - half * _f32(0.96) ** (t * md))
        mu_t1 = _f32(self.beta1) * (
            _f32(1.0) - half * _f32(0.96) ** ((t + _f32(1.0)) * md))
        bc2 = float(_f32(1.0) - _f32(self.beta2) ** t)
        omu = float(_f32(1.0) - mu_t)
        mu_t, mu_t1 = float(mu_t), float(mu_t1)
        g = _l2(self, g, w)
        s["mu_prod"].mul_(mu_t)
        s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * g)
        s["v"].copy_(self.beta2 * s["v"] + (1 - self.beta2) * (g * g))
        mp = s["mu_prod"]
        m_hat = mu_t1 * s["m"] / (1.0 - mp * mu_t1) + omu * g / (1.0 - mp)
        w.sub_(lr * m_hat / ((s["v"] / bc2).sqrt() + self.epsilon))


class RAdam(Optimizer):
    """Rectified Adam (reference: python/paddle/optimizer/radam.py; Liu et
    al. 2020): SGD with momentum until the variance estimate's
    rectification term is usable (rho_t > 5)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        t = _t(step)
        b2t = _f32(self.beta2) ** t
        bc1 = float(_f32(1.0) - _f32(self.beta1) ** t)
        bc2 = _f32(1.0) - b2t
        rho_inf = 2.0 / (1.0 - self.beta2) - 1.0
        rho_t = _f32(rho_inf) - _f32(2.0) * t * b2t / bc2
        r_num = (rho_t - _f32(4.0)) * (rho_t - _f32(2.0)) * _f32(rho_inf)
        r_den = _f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho_t
        rect = float(np.sqrt(max(r_num, _f32(0.0))
                             / max(r_den, _f32(1e-12))))
        g = _l2(self, g, w)
        s["m"].copy_(self.beta1 * s["m"] + (1 - self.beta1) * g)
        s["v"].copy_(self.beta2 * s["v"] + (1 - self.beta2) * (g * g))
        m_hat = s["m"] / bc1
        if rho_t > 5.0:
            update = rect * m_hat / ((s["v"] / float(bc2)).sqrt()
                                     + self.epsilon)
        else:
            update = m_hat
        w.sub_(lr * update)


class Rprop(Optimizer):
    """Sign-based resilient propagation (reference:
    python/paddle/optimizer/rprop.py), for full-batch regimes."""

    def __init__(self, learning_rate=0.01, learning_rate_range=(1e-5, 50.0),
                 etas=(0.5, 1.2), parameters=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, 0.0, grad_clip)
        self.lr_min, self.lr_max = learning_rate_range
        self.eta_neg, self.eta_pos = etas

    def _init_slot(self, p):
        # a schedule's step-0 value seeds the per-element step size; the
        # eta rules move it afterwards
        lr0 = self._lr(0) if callable(self._lr) else self._lr
        return {"prev_g": torch.zeros_like(p, dtype=torch.float32),
                "step_size": torch.full_like(p, float(lr0),
                                             dtype=torch.float32)}

    def _update(self, name, w, g, s, lr, step):
        g = g.float()
        sign = torch.sign(g * s["prev_g"])
        one = torch.ones_like(g)
        scale = torch.where(sign > 0, self.eta_pos * one,
                            torch.where(sign < 0, self.eta_neg * one, one))
        s["step_size"].copy_(torch.clamp(s["step_size"] * scale,
                                         self.lr_min, self.lr_max))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        s["prev_g"].copy_(g_eff)
        w.sub_(torch.sign(g_eff) * s["step_size"])
