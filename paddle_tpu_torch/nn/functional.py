"""The subset of ``paddle_tpu/nn/functional.py`` the Llama serving path
uses: ``linear``, ``embedding``, ``rms_norm`` and ``silu``."""
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
