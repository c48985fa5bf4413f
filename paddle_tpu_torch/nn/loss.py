"""Loss layers (counterpart of ``paddle_tpu/nn/loss.py``; reference:
python/paddle/nn/layer/loss.py): thin ``nn.Module`` wrappers over the
loss functions of ``functional``, with the JAX layers' names, arguments
and defaults. They hold no parameters; ``hapi.Model.prepare(loss=)``
takes any of them."""
from __future__ import annotations

import math

import torch

from . import functional as F
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class CTCLoss(Layer):
    """Reference: paddle.nn.CTCLoss (warpctc-backed); here the alpha
    recursion of ``functional.ctc_loss``."""

    def __init__(self, blank: int = 0, reduction: str = "mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths=None,
                label_lengths=None):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class _SimpleLoss(Layer):
    """reduction-carrying wrapper over an F.* loss."""
    _fn = None

    def __init__(self, reduction="mean", **kw):
        super().__init__()
        self.reduction = reduction
        self.kw = kw

    def forward(self, *args):
        return type(self)._fn(*args, reduction=self.reduction, **self.kw)


class TripletMarginLoss(_SimpleLoss):
    _fn = staticmethod(F.triplet_margin_loss)

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, reduction="mean"):
        super().__init__(reduction, margin=margin, p=p, epsilon=epsilon)


class MarginRankingLoss(_SimpleLoss):
    _fn = staticmethod(F.margin_ranking_loss)

    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__(reduction, margin=margin)


class SoftMarginLoss(_SimpleLoss):
    _fn = staticmethod(F.soft_margin_loss)


class HingeEmbeddingLoss(_SimpleLoss):
    _fn = staticmethod(F.hinge_embedding_loss)

    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__(reduction, margin=margin)


class CosineEmbeddingLoss(_SimpleLoss):
    _fn = staticmethod(F.cosine_embedding_loss)

    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__(reduction, margin=margin)


class PoissonNLLLoss(_SimpleLoss):
    _fn = staticmethod(F.poisson_nll_loss)

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean"):
        super().__init__(reduction, log_input=log_input, full=full,
                         epsilon=epsilon)


class MultiLabelSoftMarginLoss(_SimpleLoss):
    _fn = staticmethod(F.multi_label_soft_margin_loss)

    def __init__(self, weight=None, reduction="mean"):
        super().__init__(reduction, weight=weight)


class GaussianNLLLoss(Layer):
    """reference: paddle.nn.GaussianNLLLoss. The variance is clamped to
    ``epsilon`` (no data-dependent raise), as in the JAX package."""

    def __init__(self, full=False, epsilon=1e-6, reduction="mean"):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):  # noqa: A002
        var = variance.clamp_min(self.epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
        if self.full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss
