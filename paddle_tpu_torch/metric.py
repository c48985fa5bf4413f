"""Metrics (counterpart of ``paddle_tpu/metric.py``; reference:
python/paddle/metric/metrics.py: a Metric base with
update/accumulate/reset, Accuracy, Precision, Recall, Auc).

``Accuracy.compute`` takes the model's output tensor and does its top-k
on the output's device; the running counters are host numbers (metrics
are epoch-scale state), updated from what ``compute`` returns."""
from __future__ import annotations

import numpy as np
import torch


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return type(self).__name__.lower()


class Accuracy(Metric):
    """Top-k accuracy (reference: metrics.Accuracy)."""

    def __init__(self, topk=(1,)):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.reset()

    def reset(self):
        self._correct = np.zeros(len(self.topk))
        self._total = 0

    def compute(self, pred, label):
        """Returns per-sample correctness for each k (paddle's compute).
        Accepts class-index labels [n] / [n, 1] or one-hot [n, classes]."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        maxk = max(self.topk)
        top = torch.topk(pred, maxk, dim=-1).indices
        label = label.reshape(label.shape[0], -1)
        if label.shape[1] > 1:                  # one-hot / soft labels
            label = label.argmax(dim=-1, keepdim=True)
        hits = top == label
        return torch.stack([hits[..., :k].any(dim=-1) for k in self.topk],
                           dim=-1)

    def update(self, correct):
        c = _numpy(correct)
        if c.ndim == 1:
            c = c[:, None]
        self._correct += c.sum(axis=0)
        self._total += c.shape[0]
        return self.accumulate()

    def accumulate(self):
        acc = self._correct / max(self._total, 1)
        return float(acc[0]) if len(self.topk) == 1 else [float(a) for a in acc]

    def name(self):
        return "acc"


class Precision(Metric):
    """Binary precision over thresholded predictions."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = self.fp = 0

    def update(self, preds, labels):
        p = _numpy(preds).ravel() > self.threshold
        lab = _numpy(labels).ravel().astype(bool)
        self.tp += int((p & lab).sum())
        self.fp += int((p & ~lab).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = self.fn = 0

    def update(self, preds, labels):
        p = _numpy(preds).ravel() > self.threshold
        lab = _numpy(labels).ravel().astype(bool)
        self.tp += int((p & lab).sum())
        self.fn += int((~p & lab).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC-AUC via fixed-bin histogram accumulation (reference:
    metrics.Auc with num_thresholds buckets: streaming-friendly, so
    epoch-scale eval never stores raw scores)."""

    def __init__(self, num_thresholds: int = 4095):
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1)
        self._neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        scores = _numpy(preds)
        if scores.ndim == 2 and scores.shape[1] == 2:
            scores = scores[:, 1]               # paddle passes [n, 2] probs
        scores = scores.ravel()
        labels_ = _numpy(labels).ravel().astype(bool)
        idx = np.clip((scores * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        np.add.at(self._pos, idx[labels_], 1)
        np.add.at(self._neg, idx[~labels_], 1)

    def accumulate(self):
        # integrate TPR over FPR from the histogram (trapezoid)
        pos = self._pos[::-1].cumsum()
        neg = self._neg[::-1].cumsum()
        tot_pos, tot_neg = pos[-1], neg[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.concatenate([[0.0], pos / tot_pos])
        fpr = np.concatenate([[0.0], neg / tot_neg])
        return float(np.trapezoid(tpr, fpr))
