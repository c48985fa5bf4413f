"""The subset of ``paddle_tpu/nn/functional.py`` the Llama serving and
training paths use: ``linear``, ``embedding``, ``rms_norm``, ``silu`` and
``cross_entropy``."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def silu(x):
    return TF.silu(x)


def linear(x, weight, bias=None):
    """y = x @ W.T + b with the weight stored the torch way, [out, in].

    The JAX package stores Linear weights [in, out]; ``convert`` transposes
    them on the way in, so the product is the same."""
    return TF.linear(x, weight, bias)


def embedding(ids, weight):
    return TF.embedding(ids, weight)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with fp32 accumulation: normalise in fp32, cast back to the
    input dtype, then multiply by the weight (the JAX package's rounding
    points)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def cross_entropy(logits, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """paddle.nn.functional.cross_entropy (softmax + NLL), computed in fp32
    whatever the input dtype.

    Hard labels (int) are masked where they equal ``ignore_index``, and
    ``reduction="mean"`` divides by the number of unmasked labels (at
    least 1), with or without ``weight`` [n_classes], as the JAX package
    does. ``label_smoothing`` mixes the one-hot target with the uniform
    one. ``soft_label=True`` takes ``label`` as a distribution over
    ``axis``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none; got "
                         f"{reduction!r}")
    logp = torch.log_softmax(logits.float(), dim=axis)
    n = logits.shape[axis]
    mask = None
    if soft_label:
        target = label.float()
        if label_smoothing > 0:
            target = target * (1 - label_smoothing) + label_smoothing / n
        loss = -(target * logp).sum(dim=axis)
    else:
        idx = label.long().clamp(0, n - 1)
        if label_smoothing > 0:
            # an ignored label's row is masked below, whatever its target
            onehot = TF.one_hot(idx, n).float().movedim(-1, axis)
            target = onehot * (1 - label_smoothing) + label_smoothing / n
            loss = -(target * logp).sum(dim=axis)
        else:
            loss = -logp.gather(axis, idx.unsqueeze(axis)).squeeze(axis)
        mask = (label != ignore_index).to(loss.dtype)
        loss = loss * mask
        if weight is not None:
            loss = loss * weight.float()[idx]
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if mask is not None:
        return loss.sum() / mask.sum().clamp_min(1.0)
    return loss.mean()
