"""One fused Adam / AdamW update over all of a model's tensors on Hopper,
and its plain PyTorch version.

Replaces: the optimizer update of the JAX package's jitted train step,
``paddle_tpu/optimizer/optimizers.py`` ``Adam._update`` (:182), which
XLA fuses into a few passes inside the step (``paddle_tpu/trainer.py``
:263-300), together with ``GradScaler.unscale`` / ``select``
(``paddle_tpu/amp/__init__.py``) and ``ClipGradByGlobalNorm``'s scaling
(``paddle_tpu/optimizer/clip.py``) in front of it. It is not a Pallas
kernel: the port writes it by hand so that the update stays one program,
as it is in the JAX design, instead of some ten eager ops a tensor.

What it computes, per element in fp32, at the JAX package's rounding
points:

    g = float(grad)
    g = g * inv_scale                    (GradScaler.unscale; fp32 from here)
    g = g * clip_scale                   (ClipGradByGlobalNorm; rounded to
                                          the gradient's type when there is
                                          no inv_scale, as its astype does)
    w = master, or float(param) without masters
    Adam with decay:   g = g + wd * w    (L2 in the gradient)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps),  bc_i = 1 - b_i ** (step + 1)
    AdamW with decay:  u = u + wd * w    (decoupled)
    w = w - lr * u;  master = w;  param = w cast to the parameter's type

``decay`` is per tensor (``apply_decay_param_fun``). ``inv_scale``,
``clip_scale`` and ``found_inf`` are device scalars and are read on the
device: no ``.item()``, no host sync. When ``found_inf`` is set nothing
is written (the JAX trainer's ``GradScaler.select`` of the old state).

Bound on the H100: one pass over the state. bf16 parameters with fp32
masters move 2 (grad) + 8 (master) + 8 (m) + 8 (v) + 2 (param) = 28
bytes a parameter; Llama-3-8B's width at 4 layers (1.923 B parameters)
is 53.8 GB, 16.1 ms at 3.35 TB/s. Its ~20 fp32 operations an element are
far below the card's rate, so the bound is the bytes.

Design (``csrc/fused_adam.cu``). One launch per (parameter type, gradient
type, masters or not) group, normally one a step. The state's pointers
do not move (the update is in place), so the device table of (param,
master, m, v, numel, decay) entries and the tensors' chunk prefix sums
are built once per optimizer state and kept in a :class:`FusedAdamTable`;
each step uploads only the gradients' pointers (autograd allocates new
gradient tensors every step; the upload is one small non-blocking copy
from pinned memory) and passes lr, the bias corrections and the scalar
pointers. The table is rebuilt only when a pointer or a gradient type
changes. Blocks walk chunks of 2048 elements grid-stride, 16-byte loads
of the fp32 state. Every fp32 operation is rounded on its own (no fma
contraction), so the kernel repeats bit for bit and follows the plain
version's roundings; the plain version on a card may still differ by an
ulp where PyTorch divides by a scalar through its reciprocal.

:func:`fused_adam` takes the kernel for CUDA tensors and
:func:`fused_adam_reference` for CPU tensors; there is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import _build, count_launch, sm_count, stream_of, use_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("simt",)
# elements a chunk of the kernel (fused_adam.cu CHUNK) and the int64 words
# of one table entry (param, master, m, v, numel, decay)
CHUNK = 2048
ENTRY_WORDS = 6
BLOCKS_PER_SM = 8

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_float] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 4)


def adam_scalars(lr, beta1, beta2, eps, weight_decay, step):
    """The update's fp32 scalars: (lr, b1, b2, 1 - b1, 1 - b2, bc1, bc2,
    eps, wd). The bias corrections are taken in fp32 as the JAX package
    takes them (``t`` an fp32 step + 1)."""
    f = np.float32
    t = f(step) + f(1.0)
    bc1 = f(1.0) - f(beta1) ** t
    bc2 = f(1.0) - f(beta2) ** t
    return tuple(float(f(x)) for x in (lr, beta1, beta2, 1.0 - beta1,
                                       1.0 - beta2, bc1, bc2, eps,
                                       weight_decay))


def fused_adam_reference(params: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor],
                         masters: Optional[Sequence[torch.Tensor]],
                         ms: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         decay: Sequence[bool], *, lr, beta1, beta2, eps,
                         weight_decay, decoupled: bool, step,
                         clip_scale=None, inv_scale=None,
                         found_inf=None) -> None:
    """The kernel's function in plain torch ops, tensor by tensor, each op
    rounded to fp32 at the kernel's points; updates params, masters, m
    and v in place. A set ``found_inf`` leaves every tensor as it was."""
    lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd = adam_scalars(
        lr, beta1, beta2, eps, weight_decay, step)
    for i, p in enumerate(params):
        g = grads[i].float()
        if inv_scale is not None:
            g = g * inv_scale
        if clip_scale is not None:
            g = g * clip_scale
            if inv_scale is None:
                g = g.to(grads[i].dtype).float()
        w = masters[i] if masters is not None else p.float()
        if decay[i] and not decoupled:
            g = g + w * wd
        m = ms[i] * b1 + g * omb1
        v = vs[i] * b2 + (g * g) * omb2
        u = (m / bc1) / ((v / bc2).sqrt() + eps)
        if decay[i] and decoupled:
            u = u + w * wd
        w_new = w - u * lr
        outs = [(ms[i], m), (vs[i], v), (p, w_new)]
        if masters is not None:
            outs.append((masters[i], w_new))
        for dst, new in outs:
            new = new.to(dst.dtype)
            if found_inf is not None:
                new = torch.where(found_inf, dst, new)
            dst.copy_(new)


class FusedAdamTable:
    """The device side of one optimizer state for the kernel: per group of
    (parameter type, gradient type), the entry table, the chunk prefix
    sums and a buffer for the gradients' pointers. Built from the state's
    tensors; valid while none of them moves (``key`` names them)."""

    def __init__(self, params, masters, ms, vs, decay, grad_dtypes, key):
        dev = params[0].device
        self.key = key
        self.groups = []     # (pdtype, gdtype, indices, table, chunk_end)
        by_group = {}
        for i, p in enumerate(params):
            by_group.setdefault((p.dtype, grad_dtypes[i]), []).append(i)
        offset = 0
        for (pd, gd), idx in by_group.items():
            rows, ends, total = [], [], 0
            for i in idx:
                n = params[i].numel()
                total += -(-n // CHUNK)
                ends.append(total)
                rows.append([params[i].data_ptr(),
                             masters[i].data_ptr() if masters else 0,
                             ms[i].data_ptr(), vs[i].data_ptr(), n,
                             int(bool(decay[i]))])
            table = torch.tensor(rows, dtype=torch.int64).to(dev)
            chunk_end = torch.tensor(ends, dtype=torch.int64).to(dev)
            self.groups.append((pd, gd, idx, offset, table, chunk_end,
                                total))
            offset += len(idx)
        self.order = [i for g in self.groups for i in g[2]]
        self.grad_ptrs = torch.empty(len(params), dtype=torch.int64,
                                     device=dev)


def _check(params, grads, masters, ms, vs):
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n) or (
            masters is not None and len(masters) != n):
        raise ValueError("params, grads, masters, m and v differ in length")
    for i, p in enumerate(params):
        if p.dtype not in DTYPES or grads[i].dtype not in DTYPES:
            raise ValueError(f"tensor {i}: parameter {p.dtype} / gradient "
                             f"{grads[i].dtype}: fp32, bf16 or fp16 only")
        state = [ms[i], vs[i]] + ([masters[i]] if masters else [])
        if any(t.dtype != torch.float32 for t in state):
            raise ValueError(f"tensor {i}: m, v and masters must be fp32")
        if any(t.numel() != p.numel() for t in state + [grads[i]]):
            raise ValueError(f"tensor {i}: sizes differ from the "
                             f"parameter's {tuple(p.shape)}")


def _table_for(cache, params, grads, masters, ms, vs, decay):
    key = tuple(t.data_ptr() for t in params) + tuple(
        t.data_ptr() for t in (masters or ())) + tuple(
        t.data_ptr() for t in ms) + tuple(t.data_ptr() for t in vs) + tuple(
        g.dtype for g in grads) + tuple(bool(d) for d in decay)
    table = cache.get("table") if cache is not None else None
    if table is None or table.key != key:
        lib = _build.load("fused_adam")
        for sym, want in (("fused_adam_entry_bytes", ENTRY_WORDS * 8),
                          ("fused_adam_chunk", CHUNK)):
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_longlong
            if fn() != want:
                raise RuntimeError(f"fused_adam.cu {sym} is {fn()}, the "
                                   f"wrapper packs {want}")
        for name, t in [("param", p) for p in params] + [
                ("master", t) for t in (masters or ())] + [
                ("m", t) for t in ms] + [("v", t) for t in vs]:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"every {name} must be contiguous and "
                                 f"16-byte aligned")
        table = FusedAdamTable(params, masters, ms, vs, decay,
                               [g.dtype for g in grads], key)
        if cache is not None:
            cache["table"] = table
    return table


def fused_adam(params: List[torch.Tensor], grads: List[torch.Tensor],
               masters: Optional[List[torch.Tensor]], ms, vs, decay, *,
               lr, beta1, beta2, eps, weight_decay, decoupled: bool, step,
               clip_scale: Optional[torch.Tensor] = None,
               inv_scale: Optional[torch.Tensor] = None,
               found_inf: Optional[torch.Tensor] = None,
               cache: Optional[dict] = None) -> None:
    """Update ``params`` (and ``masters``, ``ms``, ``vs``) in place by one
    Adam (``decoupled=False``) or AdamW step. CPU tensors take
    :func:`fused_adam_reference`; CUDA tensors launch the kernel, one
    launch per (parameter type, gradient type) group, on the current
    stream, or raise. ``cache`` (a dict the caller keeps with its state)
    holds the :class:`FusedAdamTable` between steps."""
    if not params:
        return
    _check(params, grads, masters, ms, vs)
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, decoupled=decoupled, step=step,
              clip_scale=clip_scale, inv_scale=inv_scale,
              found_inf=found_inf)
    scalars = [t for t in (clip_scale, inv_scale, found_inf)
               if t is not None]
    everything = (list(params) + list(grads) + list(masters or ())
                  + list(ms) + list(vs) + scalars)
    if not use_kernel(*everything):
        fused_adam_reference(params, grads, masters, ms, vs, decay, **kw)
        return
    for t, dt in ((clip_scale, torch.float32), (inv_scale, torch.float32),
                  (found_inf, torch.bool)):
        if t is not None and (t.dtype != dt or t.numel() != 1):
            raise ValueError(f"scalar inputs: clip_scale and inv_scale "
                             f"fp32, found_inf bool, one element each; got "
                             f"{t.dtype} {tuple(t.shape)}")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    if any(g.data_ptr() % 16 for g in grads):
        raise ValueError("every gradient must be 16-byte aligned")
    table = _table_for(cache, params, grads, masters, ms, vs, decay)
    ptrs = torch.tensor([grads[i].data_ptr() for i in table.order],
                        dtype=torch.int64, pin_memory=True)
    table.grad_ptrs.copy_(ptrs, non_blocking=True)
    s = adam_scalars(lr, beta1, beta2, eps, weight_decay, step)
    fn = _build.entry("fused_adam", "fused_adam_step", _ARGTYPES)
    blocks_cap = sm_count(params[0]) * BLOCKS_PER_SM

    def ptr(t):
        return None if t is None else t.data_ptr()

    for pd, gd, idx, offset, tab, chunk_end, nchunks in table.groups:
        rc = fn(tab.data_ptr(), table.grad_ptrs.data_ptr() + 8 * offset,
                chunk_end.data_ptr(), len(idx), nchunks,
                min(nchunks, blocks_cap), *s, int(decoupled),
                int(masters is not None), DTYPES[pd], DTYPES[gd],
                ptr(clip_scale), ptr(inv_scale), ptr(found_inf),
                stream_of(params[0]))
        _build.check("fused_adam", rc)
        count_launch(fused_adam, "simt")


fused_adam.launches = 0
fused_adam.launches_by_route = dict.fromkeys(ROUTES, 0)
