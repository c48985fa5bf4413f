"""The subset of ``paddle_tpu/nn/functional.py`` the port's models use:
``linear``, ``embedding``, ``take_rows``, ``rms_norm``, ``layer_norm``,
the activations ``silu``, ``relu``, ``tanh`` and ``gelu`` (exact and
tanh), ``dropout`` in both of Paddle's modes, ``scaled_dot_product_attention``
and ``cross_entropy``.

Where the JAX function takes a PRNG key, the port's takes an explicit
``torch.Generator``. The two give different bits for one seed, so the
tests hold dropout to its rates and modes, and parity at p = 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF


# ------------------------------------------------------------- activations
def silu(x):
    return TF.silu(x)


def relu(x):
    return TF.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate=False):
    """GELU, exact (erf) or, with ``approximate``, its tanh form (GPT's)."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


# ------------------------------------------------------------------- linear
def linear(x, weight, bias=None):
    """y = x @ W.T + b with the weight stored the torch way, [out, in].

    The JAX package stores Linear weights [in, out]; ``convert`` transposes
    them on the way in, so the product is the same. Under
    ``amp.auto_cast`` (O1) the inputs are cast to the AMP dtype first.
    Operands of mixed dtypes are promoted as ``jnp`` promotes them: a bf16
    activation through an fp32 head (BERT's classifier) gives fp32, and a
    bias of a wider dtype is added after the product is rounded."""
    from ..amp import maybe_cast
    x, weight, bias = maybe_cast(x), maybe_cast(weight), maybe_cast(bias)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    if bias is not None and bias.dtype != x.dtype:
        return TF.linear(x, weight) + bias
    return TF.linear(x, weight, bias)


def embedding(ids, weight):
    return TF.embedding(ids, weight)


def take_rows(table, idx):
    """``table[idx]`` with the JAX gather's index rule: a negative index
    counts from the end, and one out of range is clamped to the nearest
    row (torch would raise on the CPU and assert on the card). GPT's and
    BERT's learned position tables are read this way, so a sequence past
    ``max_position_embeddings`` reads the last row, as in JAX."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


# ------------------------------------------------------------------- norms
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm at the JAX package's rounding point: mean and variance
    and the normalisation in fp32, rounded to ``x.dtype``, and only then
    the weight and the bias (``torch.nn.functional.layer_norm`` rounds
    once, after the affine)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


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


# ----------------------------------------------------------------- dropout
DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, training=True, generator=None,
            mode="upscale_in_train"):
    """paddle.nn.functional.dropout. ``upscale_in_train`` keeps each
    element with probability 1 - p and scales the kept ones by 1 / (1 -
    p) in training, and is the identity in inference;
    ``downscale_in_infer`` applies the raw mask in training and scales
    by 1 - p in inference. The mask is drawn from ``generator`` (required
    in training, as the JAX function requires its key), on ``x``'s
    device: ``uniform < 1 - p``, as ``jax.random.bernoulli`` draws it."""
    if mode not in DROPOUT_MODES:
        raise ValueError(f"mode must be one of {DROPOUT_MODES}, got "
                         f"{mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and p > 0.0 and not training:
            return (x * (1.0 - p)).to(x.dtype)
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit "
                         "torch.Generator")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
    return torch.where(mask, x, torch.zeros_like(x))


# --------------------------------------------------------------- attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 generator=None):
    """paddle.nn.functional.scaled_dot_product_attention on [batch, seq,
    heads, head_dim]. The flash route (``ops.attention.use_flash``: no
    mask, no dropout, whole 128-row tiles) runs the flash kernels on a
    CUDA tensor and their plain version on a CPU one; otherwise the dense
    path, with attention dropout drawn from ``generator``."""
    from ..ops.attention import dense_attention, flash_attention, use_flash
    if use_flash(query, key, attn_mask, dropout_p):
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return dense_attention(query, key, value, attn_mask=attn_mask,
                           dropout_p=dropout_p, causal=is_causal,
                           scale=scale, generator=generator)


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
