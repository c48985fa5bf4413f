"""Error-compensating PTQ: GPTQ and AWQ (counterpart of
``paddle_tpu/quant/gptq_awq.py``).

Both emit the layout of ``quantize_blockwise`` (int8 or packed int4 codes
[din, dout], bf16 scales [din/128, dout]), so the quantized model serves
through ``QuantizedLinear`` and the fused dequant-matmul kernel unchanged;
the algorithms only choose better codes.

- **GPTQ** quantizes input channels one at a time and pushes each
  channel's rounding error onto the channels not yet quantized through
  the inverse Hessian of the calibration activations (H = X^T X), on the
  host in float64, as in the JAX package.
- **AWQ** scales salient input channels up before rounding (s_j =
  act_j^alpha / w_j^(1-alpha), alpha grid-searched per layer against the
  calibration reconstruction error) and divides the activations by the
  same scale at run time.

Calibration inputs are captured with forward pre-hooks.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.common import Linear
from .weight_only import (QUANT_BLOCK, QuantizedLinear, dequantize_weight,
                          pack_int4, quantize_blockwise, quantize_model)

__all__ = ["gptq_quantize_weight", "awq_search_scale", "AWQLinear",
           "gptq_quantize_model", "awq_quantize_model",
           "capture_linear_inputs"]


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


# ------------------------------------------------------------------- GPTQ
def gptq_quantize_weight(w, x_cal, bits: int = 4,
                         block_size: int = QUANT_BLOCK,
                         percdamp: float = 0.01, act_order: bool = False):
    """GPTQ on a [in, out] weight with calibration activations [n, in].
    Returns (qweight, scales) in ``quantize_blockwise``'s layout, on the
    CPU.

    ``act_order=False``: channels are quantized 0 .. in-1, each block's
    scales taken from the current (error-compensated) values at the block
    start. ``act_order=True``: channels are visited by descending diag(H),
    each keeps the scale of its own contiguous block (fixed up front from
    the uncompensated weights) and the codes are put back in row order,
    so the layout needs no index indirection."""
    w = np.asarray(_np(w), np.float64)                  # [in, out]
    x = np.asarray(_np(x_cal), np.float64).reshape(-1, w.shape[0])
    din, dout = w.shape
    if din % block_size:
        raise ValueError(f"in_features {din} % block {block_size} != 0")
    qmax = 127.0 if bits == 8 else 7.0

    H = x.T @ x                                          # [in, in]
    damp = percdamp * np.mean(np.diag(H))
    H[np.diag_indices(din)] += max(damp, 1e-8)
    Q = np.zeros_like(w)

    if act_order:
        perm = np.argsort(-np.diag(H))                   # salient first
        Hp = H[perm][:, perm]
        Hinv = np.linalg.cholesky(np.linalg.inv(Hp)).T   # upper
        W = w[perm].copy()
        scales = np.maximum(
            np.abs(w).reshape(din // block_size, block_size, dout)
            .max(axis=1) / qmax, 1e-12)
        for i in range(din):
            s = scales[perm[i] // block_size]
            qi = np.clip(np.round(W[i] / s), -qmax, qmax)
            Q[perm[i]] = qi
            err = (W[i] - qi * s) / Hinv[i, i]
            W[i + 1:] -= np.outer(Hinv[i, i + 1:], err)
    else:
        Hinv = np.linalg.cholesky(np.linalg.inv(H)).T    # upper
        W = w.copy()
        scales = np.zeros((din // block_size, dout))
        for b0 in range(0, din, block_size):
            b1 = b0 + block_size
            blk = b0 // block_size
            scales[blk] = np.maximum(np.abs(W[b0:b1]).max(axis=0) / qmax,
                                     1e-12)
            for i in range(b0, b1):
                s = scales[blk]
                qi = np.clip(np.round(W[i] / s), -qmax, qmax)
                Q[i] = qi
                err = (W[i] - qi * s) / Hinv[i, i]
                W[i + 1:] -= np.outer(Hinv[i, i + 1:], err)
    q = torch.from_numpy(Q.astype(np.int8))
    if bits == 4:
        q = pack_int4(q)
    return q, torch.from_numpy(scales.astype(np.float32)).to(torch.bfloat16)


# -------------------------------------------------------------------- AWQ
def awq_search_scale(w, x_cal, bits: int = 4, block_size: int = QUANT_BLOCK,
                     n_grid: int = 20) -> torch.Tensor:
    """Per-input-channel AWQ scale for a [in, out] weight: grid-search
    alpha in [0, 1) minimizing || x @ W - (x/s) @ RTN(W * s) || on the
    calibration sample. Returns the [in] scale vector (float32, CPU)."""
    wnp = np.asarray(_np(w), np.float32)
    x = np.asarray(_np(x_cal), np.float32).reshape(-1, wnp.shape[0])
    act = np.maximum(np.abs(x).mean(axis=0), 1e-8)       # [in]
    wmax = np.maximum(np.abs(wnp).max(axis=1), 1e-8)     # [in]
    ref = x @ wnp
    best_s, best_err = np.ones_like(act), np.inf
    for g in range(n_grid):
        alpha = g / n_grid
        s = act ** alpha / wmax ** (1 - alpha)
        s = s / np.sqrt(s.max() * s.min())               # center the range
        qw, sc = quantize_blockwise(torch.from_numpy(wnp * s[:, None]),
                                    bits, block_size)
        deq = dequantize_weight(qw, sc, bits, block_size,
                                torch.float32).numpy()
        err = float(np.mean((ref - (x / s) @ deq) ** 2))
        if err < best_err:
            best_err, best_s = err, s
    return torch.from_numpy(np.asarray(best_s, np.float32))


class AWQLinear(QuantizedLinear):
    """``QuantizedLinear`` whose input is divided by the AWQ channel scale
    (the weight was multiplied by it before rounding: the same product,
    with the codes' range spent on the salient channels). The inverse
    scale is an fp32 buffer, ``awq_inv``."""

    def __init__(self, *args, awq_scales=None, **kw):
        super().__init__(*args, **kw)
        self.register_buffer("awq_inv", 1.0 / awq_scales.float())

    def forward(self, x):
        return super().forward(x * self.awq_inv.to(x.dtype))


# ---------------------------------------------------------- model passes
def capture_linear_inputs(model, batches, max_tokens: int = 512,
                          skip: Optional[List[str]] = None
                          ) -> Dict[str, np.ndarray]:
    """Run ``model`` over ``batches`` (tuples of model-call args, or
    single inputs), recording up to ``max_tokens`` input rows per
    ``Linear`` through forward pre-hooks. Returns {module path: [n, in]}
    as fp32 numpy arrays."""
    skip = skip or []
    captured: Dict[str, list] = {}
    handles = []

    def make_hook(path):
        def hook(module, inputs):
            x = _np(inputs[0])
            x = x.reshape(-1, x.shape[-1])
            have = sum(a.shape[0] for a in captured[path])
            if have < max_tokens:
                captured[path].append(x[:max_tokens - have])
        return hook

    for path, sub in model.named_modules():
        if path and isinstance(sub, Linear) \
                and not any(s in path for s in skip):
            captured[path] = []
            handles.append(sub.register_forward_pre_hook(make_hook(path)))
    try:
        with torch.no_grad():
            for b in batches:
                model(*b) if isinstance(b, tuple) else model(b)
    finally:
        for h in handles:
            h.remove()
    return {p: np.concatenate(a) for p, a in captured.items() if a}


def gptq_quantize_model(model, batches, bits: int = 4,
                        block_size: int = QUANT_BLOCK,
                        skip: Optional[List[str]] = None,
                        percdamp: float = 0.01,
                        act_order: bool = False) -> int:
    """Calibrate and GPTQ-quantize every eligible linear in place
    (``quantize_model`` drives the swap). Returns the number swapped."""
    calib = capture_linear_inputs(model, batches, skip=skip)

    def build(sub, path):
        q, s = gptq_quantize_weight(sub.weight.T, calib[path], bits,
                                    block_size, percdamp, act_order)
        dev = sub.weight.device
        return QuantizedLinear.from_linear(sub, bits=bits,
                                           block_size=block_size,
                                           qweight=q.to(dev),
                                           scales=s.to(dev))

    return quantize_model(model, bits, block_size, skip, build=build,
                          extra_filter=lambda p: p in calib)


def awq_quantize_model(model, batches, bits: int = 4,
                       block_size: int = QUANT_BLOCK,
                       skip: Optional[List[str]] = None,
                       n_grid: int = 20) -> int:
    """Calibrate and AWQ-quantize every eligible linear in place."""
    calib = capture_linear_inputs(model, batches, skip=skip)

    def build(sub, path):
        dev = sub.weight.device
        w = sub.weight.detach().T
        s = awq_search_scale(w, calib[path], bits, block_size, n_grid)
        q, sc = quantize_blockwise(w.float().cpu() * s[:, None], bits,
                                   block_size)
        bias = sub.bias.detach() if sub.bias is not None else None
        return AWQLinear(q.to(dev), sc.to(dev), bias, bits, block_size,
                         awq_scales=s.to(dev))

    return quantize_model(model, bits, block_size, skip, build=build,
                          extra_filter=lambda p: p in calib)
