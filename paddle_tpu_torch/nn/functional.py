"""paddle.nn.functional (counterpart of ``paddle_tpu/nn/functional.py``):
every function of the JAX module, as plain torch ops with the JAX
function's semantics where they differ from torch's (``pad``'s spec
order, ``grid_sample``'s and ``affine_grid``'s ``align_corners=True``,
the pools' ``exclusive``, Paddle's argument names for ``unfold`` and
``fold``, the dropout modes, the rounding points of the norms, the
convolutions and the losses). Only ``scaled_dot_product_attention``
runs a hand-written kernel: the flash kernels, through
``ops.attention``, where the JAX function reaches the Pallas ones.

Where the JAX function takes a PRNG key, the port's takes an explicit
``torch.Generator``, required in training as the JAX key is. The two
give different bits for one seed, so the tests hold the random
functions to their rates, modes and invariants, and parity at p = 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .. import tensor as _tensor


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


def sigmoid(x):
    return torch.sigmoid(x)


def quick_gelu(x):
    """OpenAI CLIP's quick-gelu: x * sigmoid(1.702 x)."""
    return x * sigmoid(1.702 * x)


def relu6(x):
    return torch.clamp(x, 0, 6)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight):
    return torch.where(x >= 0, x, weight * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return x.clamp_min(0) + torch.clamp(alpha * torch.expm1(x / alpha), max=0)


swish = silu


def mish(x):
    return x * torch.tanh(_softplus(x))


def hardswish(x):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=1 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0, 1)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    return torch.sign(x) * (x.abs() - threshold).clamp_min(0)


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x):
    return x / (1 + x.abs())


def log_sigmoid(x):
    return -_softplus(-x)


def softmax(x, axis=-1, dtype=None):
    from ..dtypes import to_dtype
    return torch.softmax(x.to(to_dtype(dtype)) if dtype else x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def _need(generator, what):
    if generator is None:
        raise ValueError(f"{what} in training mode needs an explicit "
                         f"torch.Generator")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """softmax((x + g) / temperature) with Gumbel noise g = -log(-log u),
    u uniform in [tiny, 1) as ``jax.random.gumbel`` draws it, from
    ``generator`` (required, as the JAX key is); ``hard`` takes the
    one-hot of the argmax forward and the soft gradient backward."""
    _need(generator, "gumbel_softmax")
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(x.shape, generator=generator, device=x.device)
    g = -torch.log(-torch.log(u.clamp_min(tiny))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = hard_y + y - y.detach()
    return y


def glu(x, axis=-1):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def swiglu(x, gate=None):
    """silu(x) * gate; with no gate, ``x`` splits in half on the last
    dim (Paddle's fused swiglu)."""
    if gate is None:
        x, gate = x.chunk(2, dim=-1)
    return TF.silu(x) * gate


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


def embedding(ids, weight, padding_idx=None, sparse=False):  # noqa: ARG001
    """Rows of ``weight`` at ``ids``; rows at ``padding_idx`` read zeros."""
    out = TF.embedding(ids, weight)
    if padding_idx is not None:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


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


def _channel_shape(x):
    """(1, C, 1, ...) for a per-channel [C] vector against NC... ``x``."""
    return (1, -1) + (1,) * (x.dim() - 2)


class _RankSum(torch.autograd.Function):
    """The sum over the ranks of ``axes`` forward, and the same sum of the
    cotangents backward: each rank's loss is its share of the global
    loss, so a value every rank reads gets the sum of their gradients."""

    @staticmethod
    def forward(ctx, t, axes):
        from ..distributed.collective import _reduce_
        ctx.axes = axes
        return _reduce_(t.clone(), "sum", axes)

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import _reduce_
        return _reduce_(g.clone(), "sum", ctx.axes), None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, ranks=1,
               axes=()):
    """Batch norm over every dim but the channel (dim 1). In training it
    returns (out, new_mean, new_var): the batch's mean and **biased**
    variance in fp32 normalise ``x``, and the running statistics move by
    Paddle's convention, ``momentum * running + (1 - momentum) * batch``
    (``torch.nn.functional.batch_norm`` weighs them the other way round
    and keeps the unbiased variance). Out of training, the running
    statistics normalise. The result is rounded to ``x``'s dtype before
    the weight and the bias, which promote as ``jnp`` does.

    With ``ranks`` > 1 the batch is split over the mesh ``axes`` (each of
    the ``ranks`` ranks holds as many rows): the mean and then the
    variance are per-channel sums all-reduced over ``axes`` (two
    collectives, differentiable), so the statistics are the global
    batch's, as the JAX layer's are on a global array."""
    shape = _channel_shape(x)
    if training:
        dims = (0,) + tuple(range(2, x.dim()))
        x32 = x.float()
        if ranks > 1:
            n = ranks * (x32.numel() // x32.shape[1])
            mean = _RankSum.apply(x32.sum(dim=dims), axes) / n
            var = _RankSum.apply((x32 - mean.reshape(shape)).square()
                                 .sum(dim=dims), axes) / n
        else:
            mean = x32.mean(dim=dims)
            var = (x32 - mean.reshape(shape)).square().mean(dim=dims)
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * var
    else:
        mean, var = running_mean, running_var
    out = ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if training:
        return out, new_mean, new_var
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5):
    """Group norm of NC... ``x``: each group's mean and biased variance in
    fp32, the result rounded to ``x``'s dtype before the per-channel
    weight and bias (which promote as ``jnp`` does)."""
    n, c = x.shape[0], x.shape[1]
    g = x.reshape(n, num_groups, c // num_groups, *x.shape[2:]).float()
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dim=dims, keepdim=True)
    var = (g - mean).square().mean(dim=dims, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape) \
        .to(x.dtype)
    shape = _channel_shape(x)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    return group_norm(x, x.shape[1], weight, bias, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x`` over its ``p``-norm along ``axis``, the norm floored at
    ``epsilon``."""
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


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
    device: ``uniform < 1 - p``, as ``jax.random.bernoulli`` draws it.
    Every rank of a mesh draws the same mask from the same generator, so
    the copies of a replicated ``x`` stay equal; for an ``x`` split over
    a mesh axis (a rank's heads or columns) pass
    ``utils.rng.fold_axis(generator, axis)``: each rank then draws its
    own mask, as one global JAX mask gives each shard its own bits."""
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


def ctc_loss(log_probs, labels, input_lengths=None, label_lengths=None,
             blank: int = 0, reduction: str = "mean"):
    """Connectionist temporal classification loss over [B, T, C] logits
    (log-softmaxed here) and [B, L] labels padded past ``label_lengths``:
    the JAX function's log-space alpha recursion over time, step by step
    (-1e30 stands for log 0, a row is frozen once its ``input_lengths``
    ends), so its value and gradients are the JAX function's.
    ``reduction="mean"`` averages the losses divided by their label
    lengths (Paddle's warpctc convention), ``"sum"`` sums them."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    b, t, _ = lp.shape
    nl = labels.shape[1]
    dev = lp.device
    if input_lengths is None:
        input_lengths = torch.full((b,), t, dtype=torch.long, device=dev)
    if label_lengths is None:
        label_lengths = torch.full((b,), nl, dtype=torch.long, device=dev)
    input_lengths = torch.as_tensor(input_lengths, device=dev).long()
    label_lengths = torch.as_tensor(label_lengths, device=dev).long()
    s = 2 * nl + 1
    # the extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    ext_prev2 = TF.pad(ext, (2, 0), value=blank)[:, :s]
    allow_skip = (ext != blank) & (ext != ext_prev2) & (pos >= 2)
    emit = lp.gather(2, ext[:, None, :].expand(b, t, s))       # [B, T, S]
    alpha = neg_inf.expand(b, s).clone()
    alpha[:, 0] = emit[:, 0, 0]
    if nl > 0:
        alpha[:, 1] = emit[:, 0, 1]
    for ti in range(1, t):
        a1 = TF.pad(alpha, (1, 0), value=-1e30)[:, :s]
        a2 = TF.pad(alpha, (2, 0), value=-1e30)[:, :s]
        a2 = torch.where(allow_skip, a2, neg_inf)
        stacked = torch.stack([alpha, a1, a2], dim=0)
        m = stacked.max(dim=0).values
        tot = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
        new = torch.where(m <= neg_inf / 2, neg_inf, tot) + emit[:, ti]
        alpha = torch.where((ti < input_lengths)[:, None], new, alpha)
    last = 2 * label_lengths
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, (last - 1).clamp_min(0)[:, None])[:, 0]
    # an empty target: only the all-blank path counts
    a_prev = torch.where(last == 0, neg_inf, a_prev)
    m = torch.maximum(a_last, a_prev)
    ll = m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))
    loss = -torch.where(m <= neg_inf / 2, neg_inf, ll)
    if reduction == "mean":
        return (loss / label_lengths.clamp_min(1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# ------------------------------------------------------------------ losses
# The JAX package's loss functions (``paddle_tpu/nn/functional.py``), term
# for term: the same clamps, masks and reductions, so ``nn/loss.py``'s
# layers give the JAX values under every ``reduction``.
def _reduce(loss, reduction):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.mean()


def _softplus(x):
    """log(1 + exp(x)) without the overflow (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def nll_loss(log_probs, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """Labels equal to ``ignore_index`` are masked; ``"mean"`` divides by
    the unmasked count (at least 1), with or without ``weight``."""
    n = log_probs.shape[-1]
    idx = label.long().clamp(0, n - 1)
    loss = -log_probs.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    mask = (label != ignore_index).to(loss.dtype)
    loss = loss * mask
    if weight is not None:
        loss = loss * weight[idx]
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / mask.sum().clamp_min(1.0)


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(input.clamp_min(eps))
             + (1 - label) * torch.log((1 - input).clamp_min(eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    logit = logit.float()
    loss = (logit.clamp_min(0) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * label + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):  # noqa: A002 (input: log-prob)
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True,  # noqa: A002
                     full=False, epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1.0, input, (margin - input).clamp_min(0.0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    return _reduce((-label * (input - other) + margin).clamp_min(0.0),
                   reduction)


def soft_margin_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(_softplus(-label * input), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean"):
    # log_sigmoid(x) == -softplus(-x), as jax.nn.log_sigmoid
    loss = label * _softplus(-input) + (1 - label) * _softplus(input)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    sim = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp_min(1e-12)
    loss = torch.where(label == 1, 1.0 - sim, (sim - margin).clamp_min(0.0))
    return _reduce(loss, reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = (torch.abs(x - y + epsilon) ** p).sum(-1) ** (1.0 / p)
    return d.unsqueeze(-1) if keepdim else d


def triplet_margin_loss(anchor, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, reduction="mean"):
    # epsilon inside the distance keeps the p-root differentiable at zero
    dp = pairwise_distance(anchor, positive, p, epsilon)
    dn = pairwise_distance(anchor, negative, p, epsilon)
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


# -------------------------------------------------------------------- conv
def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _same_pads(size, k, s, d):
    """XLA's SAME padding (lo, hi) of one spatial dim."""
    eff = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _check_same_dtype(x, weight):
    # lax.conv_general_dilated refuses mixed dtypes; so does the port
    # (a bf16 backbone fed fp32 latents outside auto_cast)
    if x.dtype != weight.dtype:
        raise TypeError(f"conv requires arguments to have the same dtypes, "
                        f"got {str(x.dtype).replace('torch.', '')}, "
                        f"{str(weight.dtype).replace('torch.', '')}")


_CONVS = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _convnd(x, weight, bias, stride, padding, dilation, groups, n):
    """NC... convolution with an OI... weight, as the JAX function does
    it: under ``amp.auto_cast`` both operands are cast first; the product
    is rounded to ``x``'s dtype, and only then is the bias added (it
    promotes as ``jnp`` does; ``torch.nn.functional.conv2d(..., bias)``
    would add it before the rounding). ``padding`` is an int, a tuple or
    ``"SAME"`` / ``"VALID"``."""
    from ..amp import maybe_cast
    x, weight = maybe_cast(x), maybe_cast(weight)
    _check_same_dtype(x, weight)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got "
                             f"{padding!r}")
        pads = [(0, 0)] * n if mode == "VALID" else [
            _same_pads(x.shape[2 + i], weight.shape[2 + i], stride[i],
                       dilation[i]) for i in range(n)]
    else:
        pads = [(p, p) for p in _ntuple(padding, n)]
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        # TF.pad lists the last dim first
        x = TF.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        conv_pad = 0
    out = _CONVS[n](x, weight, None, stride, conv_pad, dilation, groups)
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 3)


def _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                      dilation, groups, n):
    """The transposed convolution as the JAX function computes it: ``x``
    dilated by ``stride`` (zeros between its elements), padded by (k_eff
    - 1 - p, k_eff - 1 - p + output_padding) on each spatial dim (a
    negative pad crops), and convolved at stride 1 with the Paddle weight
    [in, out / groups, k...] swapped to [out / groups, in, k...] and
    flipped; with ``groups`` > 1 the weight is rebuilt group by group
    into [out, in / groups, k...] as the JAX function rebuilds it. No
    ``auto_cast``, and the bias is added without a cast, as there."""
    _check_same_dtype(x, weight)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    p = _ntuple(padding, n)
    op = _ntuple(output_padding, n)
    k = tuple(weight.shape[2:])
    flip = tuple(range(2, 2 + n))
    if groups > 1:
        ic, ocg = weight.shape[0], weight.shape[1]
        w = weight.reshape(groups, ic // groups, ocg, *k).transpose(1, 2) \
            .reshape(groups * ocg, ic // groups, *k).flip(flip)
    else:
        w = weight.transpose(0, 1).flip(flip)
    if any(s > 1 for s in stride):
        size = [(x.shape[2 + i] - 1) * stride[i] + 1 for i in range(n)]
        dil = x.new_zeros(x.shape[:2] + tuple(size))
        dil[(slice(None), slice(None)) + tuple(
            slice(None, None, s) for s in stride)] = x
        x = dil
    pads = []
    for i in reversed(range(n)):
        eff = (k[i] - 1) * dilation[i] + 1
        pads += [eff - 1 - p[i], eff - 1 - p[i] + op[i]]
    x = TF.pad(x, pads)
    out = _CONVS[n](x, w, None, 1, 0, dilation, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    return _convnd_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    return _convnd_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, 2)


# ------------------------------------------------------------------ pooling
_POOLS = {"max": {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d},
          "avg": {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}}


def _pool_nd(x, kernel_size, stride, padding, nd, op, exclusive=True):
    """One pooling window definition for 1-, 2- and 3-D (the JAX
    ``reduce_window`` one): the output has floor((size + 2p - k) / s) + 1
    positions a dim; max pools pad with -inf (an integer dtype's
    minimum), average pools divide the window sum by the window's size
    or, with ``exclusive`` and any padding, by the count of unpadded
    positions in it."""
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride if stride is not None else kernel_size, nd)
    p = _ntuple(padding, nd)
    pads = [v for pi in reversed(p) for v in (pi, pi)]
    if op == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        return _POOLS["max"][nd](TF.pad(x, pads, value=fill), k, s)
    avg = _POOLS["avg"][nd]
    summed = avg(TF.pad(x, pads), k, s) * math.prod(k)
    if exclusive and any(p):
        ones = TF.pad(torch.ones_like(x[:1, :1]), pads)
        counts = avg(ones, k, s) * math.prod(k)
        return summed / counts
    return summed / math.prod(k)


def max_pool1d(x, kernel_size, stride=None, padding=0):
    return _pool_nd(x, kernel_size, stride, padding, 1, "max")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", exclusive)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    return _pool_nd(x, kernel_size, stride, padding, 2, "max")


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True):
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", exclusive)


def max_pool3d(x, kernel_size, stride=None, padding=0):
    return _pool_nd(x, kernel_size, stride, padding, 3, "max")


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", exclusive)


def _adaptive_window(x, output_size):
    out = _ntuple(output_size, 2)
    h, w = x.shape[2], x.shape[3]
    if h % out[0] or w % out[1]:
        # the JAX pools assert it: one static window for the whole map
        raise ValueError(f"adaptive pool needs divisible sizes: {(h, w)} "
                         f"into {out}")
    return h // out[0], w // out[1]


def adaptive_avg_pool2d(x, output_size):
    k = _adaptive_window(x, output_size)
    return avg_pool2d(x, k, k)


def adaptive_max_pool2d(x, output_size):
    k = _adaptive_window(x, output_size)
    return max_pool2d(x, k, k)


def global_avg_pool2d(x):
    return x.mean(dim=(2, 3), keepdim=True)


# ------------------------------------------------------------ interpolation
def _resize_nearest(x, dim, n):
    """``jax.image.resize``'s nearest: the source of output i is
    floor((i + 0.5) * m / n) in fp32 (half-pixel centres: torch's
    ``nearest-exact``, not its ``nearest``)."""
    m = x.shape[dim]
    src = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n)
    return x.index_select(dim, src.long().clamp_(max=m - 1).to(x.device))


def _triangle(t):
    return torch.clamp(1 - t.abs(), min=0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _resize_weights(m, n, kernel):
    """``jax.image``'s ``compute_weight_mat`` [m, n] for scale n / m, no
    translation, with its antialiasing (the kernel widened by m / n when
    downsampling), normalised columns, and zero columns for samples
    outside the input."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None])
    w = kernel(dist.abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


_RESIZE_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False):
    """Resize NCHW ``x`` to ``size`` (or int(h * scale), int(w * scale)),
    as the JAX function does. ``nearest`` (with or without
    ``align_corners``), and ``bilinear`` / ``bicubic`` without it, are
    ``jax.image.resize``'s: half-pixel centres, and an antialiasing
    kernel when downsampling (a dim whose size does not change is left as
    it is). ``bilinear`` with ``align_corners`` samples the corner grid
    i * (h - 1) / (oh - 1) in fp32."""
    n, c, h, w = x.shape
    if size is None:
        sf = _ntuple(scale_factor, 2)
        size = (int(h * sf[0]), int(w * sf[1]))
    oh, ow = size
    if mode == "nearest":
        if oh != h:
            x = _resize_nearest(x, 2, oh)
        if ow != w:
            x = _resize_nearest(x, 3, ow)
        return x
    if not align_corners:
        if mode not in _RESIZE_KERNELS:
            raise ValueError(f"unknown interpolation mode {mode!r}")
        kernel = _RESIZE_KERNELS[mode]
        out = x if x.is_floating_point() else x.float()
        if oh != h:
            wh = _resize_weights(h, oh, kernel).to(out.device, out.dtype)
            out = torch.einsum("nchw,hy->ncyw", out, wh)
        if ow != w:
            ww = _resize_weights(w, ow, kernel).to(out.device, out.dtype)
            out = torch.einsum("nchw,wx->nchx", out, ww)
        return out
    if mode not in ("bilinear", "linear"):
        raise NotImplementedError(f"align_corners=True with mode={mode!r}")
    return TF.interpolate(x.float(), size=(oh, ow), mode="bilinear",
                          align_corners=True).to(x.dtype)


upsample = interpolate


# ------------------------------------------------------------ random masks
# Each takes the JAX function's ``key`` as ``generator`` and requires it in
# training; out of training each is the identity (rrelu: the mean slope).
def dropout2d(x, p=0.5, training=True, generator=None):
    """Drop whole channels of NC... ``x``: one draw a (row, channel)."""
    if not training or p == 0.0:
        return x
    _need(generator, "dropout2d")
    keep = 1.0 - p
    mask = torch.rand(x.shape[:2] + (1,) * (x.dim() - 2),
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def dropout3d(x, p=0.5, training=True, generator=None):
    if not training or p == 0.0:
        return x
    _need(generator, "dropout3d")
    mask = torch.rand(x.shape[:2] + (1, 1, 1), generator=generator,
                      device=x.device) < 1.0 - p
    return x * mask / (1.0 - p)


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU-preserving dropout: dropped elements take SELU's saturation
    value, and an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    _need(generator, "alpha_dropout")
    alpha_p = -1.7580993408473766
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True, generator=None):
    """Leaky ReLU with a slope drawn uniformly in [lower, upper) for each
    element in training, their mean out of it."""
    if not training:
        return torch.where(x >= 0, x, x * (lower + upper) / 2)
    _need(generator, "rrelu")
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        .uniform_(lower, upper, generator=generator).to(x.dtype)
    return torch.where(x >= 0, x, x * slope)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis: axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


# ------------------------------------------------------------------ shapes
def one_hot(x, num_classes):
    """fp32 one-hot over a new last dim; an index outside [0,
    num_classes) gives a row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, epsilon=0.1):
    return label * (1 - epsilon) + epsilon / label.shape[-1]


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """[..., maxlen] mask of positions below each length; ``maxlen``
    defaults to the largest length."""
    lengths = torch.as_tensor(lengths)
    ml = int(maxlen) if maxlen is not None else int(lengths.max())
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    pos = torch.arange(ml, device=lengths.device)
    return (pos < lengths.unsqueeze(-1)).to(dt)


def temporal_shift(x, seg_num, shift_ratio=0.25):
    """TSM over [n * seg_num, c, h, w]: the first ``shift_ratio`` of the
    channels move one segment back in time, the next as many one forward,
    the rest stay."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold], torch.zeros_like(x[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                       x[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, x[:, :, 2 * fold:]], 2) \
        .reshape(nt, c, h, w)


def pixel_shuffle(x, upscale_factor):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_unshuffle(x, downscale_factor):
    n, c, h, w = x.shape
    r = downscale_factor
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """paddle.nn.functional.pad. A full spec (``len(pad) == 2 *
    x.ndim``) pads from dim 0 outward, pair i on dim i (the opposite of
    ``torch.nn.functional.pad``); a partial spec pads the trailing dims
    innermost first (pair i on dim -(i + 1)); an int pads every spatial
    side. Modes ``constant``, ``reflect``, ``replicate``, ``circular``;
    channels-last formats raise, as in the JAX package."""
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        raise NotImplementedError(
            f"data_format {data_format!r}: channels-last layouts are not "
            "supported (the port's path is channels-first)")
    if isinstance(pad, int):
        pad = [pad, pad] * (x.dim() - 2)
    pad = [int(v) for v in pad]
    if len(pad) % 2:
        raise ValueError("pad length must be even")
    pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]
    cfg = [(0, 0)] * x.dim()
    if len(pairs) == x.dim():
        cfg = pairs
    else:
        for i, pair in enumerate(pairs):
            cfg[x.dim() - 1 - i] = pair
    return _tensor.pad(x, cfg, "constant" if mode == "constant"
                       else _PAD_MODES[mode], value)


def zeropad2d(x, padding):
    """Zeros around the last two dims: ``padding`` an int or [left,
    right, top, bottom]."""
    left, right, top, bottom = ((padding,) * 4 if isinstance(padding, int)
                                else tuple(padding))
    return TF.pad(x, (left, right, top, bottom))


def adaptive_avg_pool1d(x, output_size):
    out = output_size if isinstance(output_size, int) else output_size[0]
    n = x.shape[-1]
    if n % out:
        raise ValueError(f"adaptive pool needs divisible sizes: {n} into "
                         f"{out}")
    return avg_pool1d(x, n // out, n // out)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    """Pooled values scattered back to their argmax positions (``indices``
    as flat h * w offsets, the Paddle and torch convention), zeros
    elsewhere."""
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride if stride is not None else kernel_size, 2)
    p = _ntuple(padding, 2)
    n, c, h, w = x.shape
    if output_size is None:
        oh = (h - 1) * s[0] + k[0] - 2 * p[0]
        ow = (w - 1) * s[1] + k[1] - 2 * p[1]
    else:
        oh, ow = output_size[-2:]
    flat = x.new_zeros((n, c, oh * ow))
    flat.scatter_(2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: [n, c * kh * kw, L], channels outermost. ``paddings`` pads
    symmetrically by its first two entries (h, w), as the JAX function
    reads an int, a pair or Paddle's 4 entries."""
    k = _ntuple(kernel_sizes, 2)
    p = _ntuple(paddings, 2)
    return TF.unfold(x, k, dilation=_ntuple(dilations, 2),
                     padding=(p[0], p[1]), stride=_ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the inverse of :func:`unfold`: overlapping patches sum."""
    k = _ntuple(kernel_sizes, 2)
    s = _ntuple(strides, 2)
    p = _ntuple(paddings, 2)
    d = _ntuple(dilations, 2)
    size = _ntuple(output_sizes, 2)
    blocks = math.prod((size[i] + 2 * p[i] - d[i] * (k[i] - 1) - 1) // s[i]
                       + 1 for i in range(2))
    if blocks != x.shape[-1]:
        raise ValueError(f"fold: {x.shape[-1]} blocks for an output of "
                         f"{size} holding {blocks}")
    return TF.fold(x, size, k, dilation=d, padding=(p[0], p[1]), stride=s)


def affine_grid(theta, out_shape, align_corners=True):
    """theta [n, 2, 3] -> sampling grid [n, h, w, 2] of normalised (x,
    y); ``align_corners`` (the default, as in the JAX package) puts -1 and
    1 on the corner pixels' centres, else on their outer edges."""
    from ..diffusion.schedulers import linspace
    _, _, h, w = out_shape
    dev = theta.device
    if align_corners:
        ys, xs = linspace(-1.0, 1.0, h), linspace(-1.0, 1.0, w)
    else:
        ys = (torch.arange(h) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys.to(dev), xs.to(dev), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base.to(theta.dtype), theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x [n, c, h, w] sampled at grid [n, oh, ow, 2] (normalised x, y) ->
    [n, c, oh, ow], bilinear or nearest (round half to even), with
    ``zeros`` or ``border`` padding; ``align_corners`` defaults to True,
    as in the JAX package. ``reflection`` raises, as there."""
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample padding_mode {padding_mode!r} (zeros/border)")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * (w - 1) / 2.0
        fy = (gy + 1.0) * (h - 1) / 2.0
    else:
        fx = ((gx + 1.0) * w - 1.0) / 2.0
        fy = ((gy + 1.0) * h - 1.0) / 2.0
    bi = torch.arange(n, device=x.device)[:, None, None, None]
    ci = torch.arange(c, device=x.device)[None, :, None, None]

    def sample_at(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = x[bi, ci, iy.clamp(0, h - 1)[:, None], ix.clamp(0, w - 1)[:, None]]
        if padding_mode == "zeros":
            v = v * inb[:, None]
        return v

    if mode == "nearest":
        return sample_at(torch.round(fx).long(), torch.round(fy).long())
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    return (sample_at(x0, y0) * (1 - wx) * (1 - wy)
            + sample_at(x0 + 1, y0) * wx * (1 - wy)
            + sample_at(x0, y0 + 1) * (1 - wx) * wy
            + sample_at(x0 + 1, y0 + 1) * wx * wy)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """x / (k + alpha / size * sum of x^2 over a channel window)^beta, the
    window padded (size // 2, size - 1 - size // 2) around each channel."""
    c = x.shape[1]
    half = size // 2
    sq = TF.pad(x.square(), (0, 0, 0, 0, half, size - 1 - half))
    acc = sq[:, 0:c]
    for i in range(1, size):
        acc = acc + sq[:, i:i + c]
    return x / (k + alpha * acc / size) ** beta


def bilinear(x1, x2, weight, bias=None):
    """x1 W x2 with ``weight`` [out, in1, in2], as in the JAX package."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + bias if bias is not None else out


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / (n1 * n2).clamp_min(eps)


# ------------------------------------------------------------ more losses
def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1):
    return cross_entropy(logits, label, soft_label=soft_label, axis=axis,
                         reduction="none")


def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    p = torch.sigmoid(logit)
    ce = label * _softplus(-logit) + (1 - label) * _softplus(logit)
    pt_ = label * p + (1 - label) * (1 - p)
    a = label * alpha + (1 - label) * (1 - alpha)
    loss = a * (1 - pt_) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    """``input`` [n, ..., c] probabilities, ``label`` [n, ..., 1] ints."""
    oh = one_hot(label.squeeze(-1), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dim=dims)
    union = (input + oh).sum(dim=dims)
    return (1.0 - 2.0 * inter / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    reg = l2_reg * (anchor.square().sum(-1).mean()
                    + positive.square().sum(-1).mean()) / 4
    sim = anchor @ positive.T
    lab = (labels[:, None] == labels[None, :]).to(sim.dtype)
    lab = lab / lab.sum(dim=1, keepdim=True)
    ce = -(lab * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    return ce + reg


def hsigmoid_loss(*args, **kw):
    raise NotImplementedError(
        "hierarchical sigmoid needs a host-side Huffman tree; use "
        "margin_cross_entropy / cross_entropy (the JAX package refuses it "
        "too)")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean"):
    """ArcFace-family margin softmax, one rank: the target logit becomes
    cos(margin1 * theta + margin2) - margin3, every logit is scaled."""
    cos = logits.clamp(-1.0, 1.0)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    oh = one_hot(label, logits.shape[-1]).to(logits.dtype)
    logp = torch.log_softmax(scale * (oh * tgt + (1 - oh) * cos), dim=-1)
    loss = _reduce(-(oh * logp).sum(dim=-1), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss
