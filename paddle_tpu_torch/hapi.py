"""paddle.Model, the high-level Keras-style API (counterpart of
``paddle_tpu/hapi.py``; reference: python/paddle/hapi/model.py:
Model.prepare/fit/evaluate/predict/save/load, paddle.summary).

A ``fit`` step is the Trainer's, in the port's idiom: the forward and the
loss, ``torch.autograd.grad`` over every parameter, then the optimizer's
``apply(params, grads, state, step)`` (on a card, Adam and AdamW update
every tensor in one ``fused_adam`` launch). The loss is read on the host
only at log points. As in the JAX package, whose ``Model`` runs
``network.functional()`` without buffers:

- the parameters move and the buffers do not: a BatchNorm in training
  mode normalises by the batch's statistics and keeps its running ones
  (``nn.norm.running_stats_kept``);
- ``evaluate`` and ``predict`` run the network in eval mode and put its
  mode back after;
- ``fit`` counts its steps from 0 at every call (the LR schedule and the
  Adam bias corrections read that count).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch import nn

from .metric import Metric
from .nn.norm import running_stats_kept

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _update_metric(m: Metric, preds, labels):
    """paddle's metric protocol: compute() (if defined) pre-reduces the
    device outputs and update() takes its result; metrics without
    compute() (Precision/Recall/Auc) take update(preds, labels)."""
    if hasattr(m, "compute"):
        m.update(m.compute(preds, labels))
    else:
        m.update(preds, labels)


def _to(tree, device):
    """Every tensor of a nested dict on ``device`` (a loaded state)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Model:
    """Reference: paddle.Model(network). input/label specs are accepted
    for signature parity; shapes are taken from the actual batches."""

    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self._params = dict(network.named_parameters())
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._opt_state = None
        self._prepared = False

    @property
    def _device(self) -> torch.device:
        return next(iter(self._params.values())).device

    # ---------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None):
        """optimizer: paddle_tpu_torch.optimizer.*; loss: callable
        (logits, label) -> scalar or an nn loss layer; metrics: Metric(s)."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._prepared = True
        return self

    def _require(self, what, ready):
        if not ready:
            raise RuntimeError(f"call prepare() with {what} first")

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (tuple, list)):
            if len(batch) == 2:
                return batch[0], batch[1]
            raise TypeError(
                f"fit/evaluate expect (input, label) 2-tuples, got "
                f"{len(batch)} elements — multi-input networks should "
                "pack their inputs into one structure")
        raise TypeError("fit/evaluate expect (input, label) batches; got "
                        f"{type(batch)}")

    def _tensor(self, x):
        return torch.as_tensor(x, device=self._device)

    def _train_step(self, x, y, stepno):
        params = self._params
        with running_stats_kept():
            loss = self._loss(self.network(x), y).float()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        self._optimizer.apply(params, dict(zip(params, grads)),
                              self._opt_state, stepno)
        return loss.detach()

    # -------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, log_freq: int = 10, verbose: int = 1,
            shuffle: bool = True, callbacks=None):
        """train_data: DataLoader-like iterable of (x, y) batches, or a
        Dataset (wrapped in a DataLoader with ``batch_size``/``shuffle``).
        callbacks: objects with (any of) ``on_train_batch_end(step, logs)``
        / ``on_epoch_end(epoch, logs)``, invoked at log points."""
        self._require("an optimizer and a loss",
                      self._optimizer is not None and self._loss is not None)
        loader = self._as_loader(train_data, batch_size, shuffle)
        callbacks = _to_list(callbacks)
        for cb in callbacks:
            if hasattr(cb, "set_model"):
                cb.set_model(self)
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(self._params)
        stepno = 0
        history = {"loss": []}
        loss = None
        for epoch in range(epochs):
            logged = False
            for batch in loader:
                x, y = self._split_batch(batch)
                loss = self._train_step(self._tensor(x), self._tensor(y),
                                        stepno)
                stepno += 1
                logged = stepno % log_freq == 0
                if logged:
                    lv = float(loss)
                    history["loss"].append(lv)
                    if verbose:
                        print(f"epoch {epoch + 1}/{epochs} step "
                              f"{stepno}: loss {lv:.4f}", flush=True)
                    for cb in callbacks:  # duck-typed callback hook
                        if hasattr(cb, "on_train_batch_end"):
                            cb.on_train_batch_end(stepno, {"loss": lv})
            if loss is not None and not logged:
                # epoch-end loss, unless the last step just logged it
                history["loss"].append(float(loss))
            if eval_data is not None:
                eres = self.evaluate(eval_data, batch_size=batch_size,
                                     verbose=verbose)
                history.setdefault("eval_loss", []).append(eres["loss"])
            try:
                for cb in callbacks:
                    if hasattr(cb, "on_epoch_end"):
                        cb.on_epoch_end(epoch, {k: v[-1] for k, v in
                                                history.items() if v})
            except StopIteration:
                break  # a callback (EarlyStopping) ended training
        return history

    def _as_loader(self, data, batch_size, shuffle):
        from .io.dataset import Dataset
        if isinstance(data, Dataset):
            from .io import DataLoader
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        return data

    # --------------------------------------------------------- evaluate
    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 1):
        self._require("a loss", self._loss is not None)
        loader = self._as_loader(eval_data, batch_size, shuffle=False)
        was_training = self.network.training
        self.network.eval()
        try:
            losses = []
            for m in self._metrics:
                m.reset()
            with torch.no_grad():
                for batch in loader:
                    x, y = self._split_batch(batch)
                    y = self._tensor(y)
                    out = self.network(self._tensor(x))
                    losses.append(float(self._loss(out, y).float()))
                    for m in self._metrics:
                        _update_metric(m, out, y)
        finally:
            if was_training:
                self.network.train()
        result = {"loss": float(np.mean(losses)) if losses else float("nan")}
        for m in self._metrics:
            result[m.name() if callable(m.name) else m.name] = m.accumulate()
        if verbose:
            print(f"eval: {result}", flush=True)
        return result

    # ---------------------------------------------------------- predict
    def predict(self, test_data, batch_size: int = 1):
        self._require("prepare()", self._prepared)
        loader = self._as_loader(test_data, batch_size, shuffle=False)
        was_training = self.network.training
        self.network.eval()
        try:
            outs = []
            with torch.no_grad():
                for batch in loader:
                    x = batch[0] if isinstance(batch, (tuple, list)) \
                        else batch
                    outs.append(self.network(self._tensor(x)).cpu().numpy())
        finally:
            if was_training:
                self.network.train()
        return outs

    # ------------------------------------------------------- save/load
    def save(self, path: str, training: bool = True):
        from .checkpoint import save as _save
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._opt_state is not None:
            _save({"opt_state": self._opt_state}, path + ".pdopt")

    def load(self, path: str, reset_optimizer: bool = False):
        from .checkpoint import load as _load
        self.network.load_state_dict(_load(path + ".pdparams"))
        self._params = dict(self.network.named_parameters())
        opt_path = path + ".pdopt"
        # checkpoint.save appends .npz to array archives
        if not reset_optimizer and (os.path.exists(opt_path) or
                                    os.path.exists(opt_path + ".npz")):
            self._opt_state = _to(_load(opt_path)["opt_state"],
                                  self._device)
        return self

    def parameters(self):
        return list(self.network.parameters())


def summary(net: nn.Module, input_size=None, dtypes=None):
    """paddle.summary parity: layer tree with parameter counts."""
    rows = []
    total = 0
    for name, sub in net.named_modules():
        own = sum(v.numel() for v in sub._parameters.values()
                  if v is not None)
        total += own
        if own or not name:
            rows.append((name or type(net).__name__,
                         type(sub).__name__, own))
    lines = [f"{'Layer':40s} {'Type':24s} {'Params':>12s}"]
    lines += [f"{n:40s} {t:24s} {p:>12,d}" for n, t, p in rows]
    lines.append(f"{'Total params':>66s}: {total:,d}")
    text = "\n".join(lines)
    print(text, flush=True)
    return {"total_params": total, "text": text}
