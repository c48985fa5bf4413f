"""paddle.callbacks (the port's copy of ``paddle_tpu/callbacks.py``;
reference: python/paddle/hapi/callbacks: EarlyStopping, ModelCheckpoint,
LRScheduler).

These follow the epoch protocol of paddle's ``Model.fit``
(``on_train_batch_end(step, logs)`` at log points, ``on_epoch_end(epoch,
logs)`` per epoch, duck-typed; the JAX package's ``hapi.Model`` is not
ported yet). The ``Trainer`` fires only ``on_step_end`` / ``on_save`` /
``on_train_end`` and has no epochs: a ``Callback`` there sees
``on_step_end`` as ``on_train_batch_end``, and the epoch-driven
callbacks (EarlyStopping, ModelCheckpoint) do nothing; use
TrainingArguments' save_steps and the watchdog instead. State is host
only.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["Callback", "EarlyStopping", "ModelCheckpoint", "LRScheduler"]


class Callback:
    """Base: all hooks optional (reference: paddle.callbacks.Callback)."""

    def set_model(self, model):
        self.model = model

    def on_train_batch_end(self, step: int, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass

    # Trainer-protocol aliases
    def on_step_end(self, step: int, logs=None):
        self.on_train_batch_end(step, logs)

    def on_save(self, step: int):
        pass

    def on_train_end(self, step: int):
        pass


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference:
    paddle.callbacks.EarlyStopping). The callback sets ``stop_training``
    for the loop to check; with ``raise_on_stop=True`` it raises
    StopIteration."""

    def __init__(self, monitor: str = "loss", mode: str = "min",
                 patience: int = 3, min_delta: float = 0.0,
                 baseline: Optional[float] = None,
                 raise_on_stop: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.monitor, self.mode = monitor, mode
        self.patience, self.min_delta = patience, min_delta
        self.best = baseline if baseline is not None else (
            float("inf") if mode == "min" else -float("inf"))
        self.wait = 0
        self.stop_training = False
        self.raise_on_stop = raise_on_stop
        self.stopped_epoch: Optional[int] = None

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch: int, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        value = float(logs[self.monitor])
        if self._improved(value):
            self.best = value
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.stop_training = True
            self.stopped_epoch = epoch
            if self.raise_on_stop:
                raise StopIteration(
                    f"EarlyStopping: no {self.monitor} improvement for "
                    f"{self.patience} epochs (best {self.best:.6g})")


class ModelCheckpoint(Callback):
    """Save the model every N epochs / on metric improvement (reference:
    paddle.callbacks.ModelCheckpoint): a model with ``.save``, or any
    module (its state_dict through ``checkpoint.save``)."""

    def __init__(self, save_dir: str, save_freq: int = 1,
                 monitor: Optional[str] = None, mode: str = "min"):
        self.save_dir = save_dir
        self.save_freq = save_freq
        self.monitor = monitor
        self.mode = mode
        self.best = float("inf") if mode == "min" else -float("inf")
        self.saved = []

    def _save(self, tag: str):
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, tag)
        model = getattr(self, "model", None)
        if model is None:
            raise RuntimeError(
                "ModelCheckpoint has no model attached: call set_model "
                "first; the Trainer saves via "
                "TrainingArguments(save_steps=...) instead")
        if hasattr(model, "save"):          # a model with its own save
            model.save(path)
        else:                               # a bare module
            from .checkpoint import save as _save
            _save(model.state_dict(), path + ".pdparams")
        self.saved.append(path)

    def on_epoch_end(self, epoch: int, logs=None):
        logs = logs or {}
        if self.monitor is not None:
            if self.monitor not in logs:
                return
            v = float(logs[self.monitor])
            better = v < self.best if self.mode == "min" else v > self.best
            if not better:
                return
            self.best = v
            self._save("best")
            return
        if (epoch + 1) % self.save_freq == 0:
            self._save(f"epoch_{epoch}")


class LRScheduler(Callback):
    """Step a manually-driven LR scheduler each epoch (reference:
    paddle.callbacks.LRScheduler). ``by_epoch=False`` steps per TRAINING
    step: the batch hook fires only at log points, so the callback steps
    the scheduler by the observed step delta rather than once per call;
    the LR trajectory stays correct under any logging cadence."""

    def __init__(self, scheduler, by_epoch: bool = True):
        self.scheduler = scheduler
        self.by_epoch = by_epoch
        self._last_step = 0

    def on_epoch_end(self, epoch: int, logs=None):
        if self.by_epoch:
            self.scheduler.step()

    def on_train_batch_end(self, step: int, logs=None):
        if not self.by_epoch:
            for _ in range(step - self._last_step):
                self.scheduler.step()
            self._last_step = step
