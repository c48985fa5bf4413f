"""paddle.incubate.nn.functional (counterpart of
``paddle_tpu/incubate/nn/functional.py``; reference:
python/paddle/incubate/nn/functional, the fused_* ops PaddleNLP model code
imports directly).

The entry points keep the reference's signatures, so model code written
against them ports without edits. Each is the plain composition the JAX
function is, except the attention: ``fused_dot_product_attention`` sends
causal attention with no mask and no dropout at whole 128-row tiles to
``ops.attention.flash_attention`` (the flash forward kernel, and the dq
and dk/dv kernels in its backward, on a CUDA tensor; their plain version
on a CPU one), as the JAX function sends it to the Pallas kernel.

Weight layouts are the reference's, not the port's ``Linear`` one:
``fused_linear``'s ``weight`` is [in, out] (unless ``transpose_weight``),
``fused_linear_activation``'s ``y`` [K, N] (unless ``trans_y``) and
``fused_feedforward``'s ``linear1_weight`` [d_model, dim_feedforward].
Dropout draws from ``generator`` when one is given, else from the ambient
stream (``utils.rng.ambient_generator``), as the JAX functions draw
``next_key()``.
"""
from __future__ import annotations

import torch

from ...models.llama import apply_rotary, rotary_cos_sin
from ...nn import functional as F
from ...ops.attention import dense_attention, flash_attention, use_flash
from ...utils import rng

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_linear",
    "fused_linear_activation", "swiglu", "fused_dropout_add",
    "fused_rotary_position_embedding", "fused_dot_product_attention",
    "fused_feedforward",
]


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=None):
    """RMSNorm over the last dim, or over every dim from
    ``begin_norm_axis`` on (the weight and bias then align with the
    flattened dims)."""
    if begin_norm_axis is not None and begin_norm_axis != x.dim() - 1:
        shape = x.shape
        flat = x.reshape(tuple(shape[:begin_norm_axis]) + (-1,))
        w = None if norm_weight is None else norm_weight.reshape(-1)
        y = F.rms_norm(flat, weight=w, epsilon=epsilon)
        if norm_bias is not None:
            y = y + norm_bias.reshape(-1)
        return y.reshape(shape)
    y = F.rms_norm(x, weight=norm_weight, epsilon=epsilon)
    return y if norm_bias is None else y + norm_bias


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=None):
    if begin_norm_axis is not None and begin_norm_axis != x.dim() - 1:
        shape = x.shape
        flat = x.reshape(tuple(shape[:begin_norm_axis]) + (-1,))
        w = None if norm_weight is None else norm_weight.reshape(-1)
        b = None if norm_bias is None else norm_bias.reshape(-1)
        return F.layer_norm(flat, flat.shape[-1:], weight=w, bias=b,
                            epsilon=epsilon).reshape(shape)
    return F.layer_norm(x, x.shape[-1:], weight=norm_weight,
                        bias=norm_bias, epsilon=epsilon)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """x @ weight + bias, ``weight`` [in, out] ([out, in] with
    ``transpose_weight``)."""
    return F.linear(x, weight if transpose_weight else weight.T, bias)


_ACTS = {"": lambda x: x, None: lambda x: x, "relu": F.relu,
         "gelu": F.gelu, "silu": F.silu, "swish": F.silu}


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation=""):
    """act(x @ y + bias), ``y`` [K, N] ([N, K] with ``trans_y``)."""
    if trans_x:
        x = x.transpose(-1, -2)
    return _ACTS[activation](F.linear(x, y if trans_y else y.transpose(-1, -2),
                                      bias))


def swiglu(x, y=None):
    """silu(x) * y; with y None, ``x`` splits in half on the last dim."""
    return F.swiglu(x, y)


def _generator(generator, x, p, training):
    if not training or p == 0.0:
        return None
    return generator or rng.ambient_generator(x.device)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator=None):
    return F.dropout(x, p, training=training, mode=mode,
                     generator=_generator(generator, x, p, training)) + y


def _apply_rotary_interleaved(x, cos, sin):
    """Non-neox ("interleaved") RoPE: the pairs are (x[2i], x[2i + 1])
    rather than (x[i], x[i + d/2])."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """RoPE on [b, s, h, d] tensors. With ``sin``/``cos`` None they are
    the port's ``rotary_cos_sin`` at ``position_ids`` (else arange) and
    theta 10000. Given tables [max_pos, d] or [max_pos, d / 2] (or
    [1, max_pos, 1, ...]) are gathered at ``position_ids``, a full-width
    table halved first, so a left-padded row rotates by its logical
    position; a position at or past the table's rows raises
    ``ValueError``. ``use_neox_rotary_style=False`` pairs (x[2i],
    x[2i + 1]). Returns q's result alone, or the tuple (q, k, v) with
    None for an input not given, as the JAX function does."""
    b, s = q.shape[0], q.shape[1]
    pos = (torch.as_tensor(position_ids, device=q.device)
           if position_ids is not None else
           torch.arange(s, device=q.device)[None].expand(b, s))
    if cos is None or sin is None:
        cos, sin = rotary_cos_sin(pos, q.shape[-1], 10000.0, q.dtype)
    else:
        mx = int(pos.max())        # one host read for both tables

        def table(t):
            t = torch.as_tensor(t, device=q.device).to(q.dtype)
            t = t.reshape(-1, t.shape[-1])
            if t.shape[-1] == q.shape[-1]:
                t = t[..., ::2]
            if mx >= t.shape[0]:
                raise ValueError(
                    f"position {mx} >= rotary table rows {t.shape[0]}")
            return t[pos][:, :, None, :]
        cos, sin = table(cos), table(sin)
    rot = apply_rotary if use_neox_rotary_style else \
        _apply_rotary_interleaved
    outs = tuple(rot(t, cos, sin) if t is not None else None
                 for t in (q, k, v))
    return outs if (k is not None or v is not None) else outs[0]


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                is_causal: bool = False, scale=None,
                                training: bool = True, generator=None):
    """[b, s, h, d] attention. Causal with no mask and no dropout in
    effect, at the flash kernel's shapes (``ops.attention.use_flash``):
    the flash kernels. Otherwise the dense path, where ``is_causal`` and
    ``attn_mask`` compose (the causal structure and a padding or bias
    mask) and attention dropout applies only in ``training``."""
    p = dropout_p if training else 0.0
    if attn_mask is None and is_causal and p == 0.0 and \
            use_flash(q, k, None, 0.0):
        return flash_attention(q, k, v, causal=True, scale=scale)
    return dense_attention(q, k, v, causal=is_causal, attn_mask=attn_mask,
                           scale=scale, dropout_p=p,
                           generator=_generator(generator, q, p, True))


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, mode=None,
                      name=None, generator=None):
    """LN -> linear -> act -> dropout -> linear -> dropout, plus the
    residual, with the reference's parameter order, ln1 / ln2 weights and
    dropout defaults: ``pre_layer_norm`` normalises the input with ln1,
    else the residual sum with ln2. ``downscale_in_infer`` scales by
    1 - p at inference."""
    dmode = mode or "upscale_in_train"

    def drop(t, rate):
        if not rate:
            return t
        return F.dropout(t, rate, training=training, mode=dmode,
                         generator=_generator(generator, t, rate, training))

    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = drop(_ACTS[activation](F.linear(x, linear1_weight.T, linear1_bias)),
             dropout1_rate)
    out = residual + drop(F.linear(h, linear2_weight.T, linear2_bias),
                          dropout2_rate)
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], weight=ln2_scale,
                           bias=ln2_bias, epsilon=ln2_epsilon)
    return out
