"""LR schedules (counterpart of ``paddle_tpu/optimizer/lr.py``).

Each schedule is ``value_at(step) -> lr``, plain scalar math on the host
(the JAX package writes the same formulas in jnp so they trace into its
jitted step; the port's step is eager, so a Python float is all it
needs). The stateful paddle API (``step()``, ``get_lr()``) sits on top.
"""
from __future__ import annotations

import bisect
import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.step()  # paddle semantics: init advances to epoch 0

    # functional core — override this
    def value_at(self, step) -> float:
        return float(self.base_lr)

    # stateful facade
    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def get_lr(self) -> float:
        return float(self.value_at(max(self.last_epoch, 0)))

    def __call__(self, step):
        return self.value_at(step)

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        s = max(float(step), 1.0)
        return self.base_lr * self.d_model ** -0.5 * min(
            s ** -0.5, s * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1):
        self.boundaries = list(boundaries)
        self.values = [float(v) for v in values]
        super().__init__(float(values[0]), last_epoch)

    def value_at(self, step):
        return self.values[bisect.bisect_right(self.boundaries, step)]


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * self.gamma ** step


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * math.exp(-self.gamma * step)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr / (1 + self.gamma * step)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1):
        self.decay_steps, self.end_lr, self.power, self.cycle = \
            decay_steps, end_lr, power, cycle
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        step = float(step)
        if self.cycle:
            decay_steps = self.decay_steps * max(
                math.ceil(step / self.decay_steps), 1.0)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr=0.0,
                 end_lr=None, last_epoch=-1):
        self.inner = (learning_rate if isinstance(learning_rate, LRScheduler)
                      else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        base = self.inner.base_lr if self.inner else float(learning_rate)
        self.end_lr = end_lr if end_lr is not None else base
        super().__init__(base, last_epoch)

    def value_at(self, step):
        step = float(step)
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * min(
                step / max(self.warmup_steps, 1), 1.0)
        if self.inner is not None:
            return self.inner.value_at(max(step - self.warmup_steps, 0))
        return float(self.end_lr)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        cos = math.cos(math.pi * min(float(step), self.T_max) / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        step = float(step)
        if self.T_mult == 1:
            t_cur = math.fmod(step, self.T_0)
            t_i = self.T_0
        else:
            n = math.floor(math.log1p(step * (self.T_mult - 1) / self.T_0)
                           / math.log(self.T_mult))
            start = self.T_0 * (self.T_mult ** n - 1) / (self.T_mult - 1)
            t_cur = step - start
            t_i = self.T_0 * self.T_mult ** n
        cos = math.cos(math.pi * t_cur / t_i)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * self.gamma ** (step // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        count = sum(1 for m in self.milestones if m <= step)
        return self.base_lr * self.gamma ** count


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * float(self.lr_lambda(step))


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=1e-4, phase_pct=0.3, last_epoch=-1):
        self.total_steps = total_steps
        self.phase_pct = phase_pct
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        super().__init__(max_learning_rate, last_epoch)

    def value_at(self, step):
        step = float(step)
        up_steps = self.phase_pct * self.total_steps
        if step < up_steps:
            return self.initial_lr + (self.base_lr - self.initial_lr) * (
                1 - math.cos(math.pi * step / up_steps)) / 2
        down_steps = self.total_steps - up_steps
        t = min(max((step - up_steps) / down_steps, 0.0), 1.0)
        return self.end_lr + (self.base_lr - self.end_lr) * (
            1 + math.cos(math.pi * t)) / 2


class ReduceOnPlateau(LRScheduler):
    """Metric-driven (host-side) schedule, stateful by nature; value_at
    returns the current factor-scaled lr."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0.0, last_epoch=-1):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.cooldown, self.min_lr = (threshold, cooldown,
                                                      min_lr)
        self.best = None
        self.num_bad = 0
        self.cooldown_left = 0
        self.current = learning_rate
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return float(self.current)

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics)
        better = (self.best is None or
                  (self.mode == "min" and m < self.best - self.threshold) or
                  (self.mode == "max" and m > self.best + self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current = max(self.current * self.factor, self.min_lr)
                self.cooldown_left = self.cooldown
                self.num_bad = 0
