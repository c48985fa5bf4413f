"""The fused Adam / AdamW update's plain version (what the CUDA kernel
computes, ``ops/kernels/fused_adam.py``) against the JAX package's
``Adam`` / ``AdamW`` on the same seeded numpy parameters and gradients:
multi-precision on and off, a decay mask, global-norm clipping, a
GradScaler's unscale and its skip of a non-finite step. Also against the
port's earlier per-tensor update (about ten eager ops a tensor), and the
bias corrections against the JAX package's fp32 ones.

Tolerance: fp32 masters (or fp32 parameters) within 1e-6 of the largest
|value| of their tensor (the same fp32 ops, which XLA may fuse or order
otherwise); 16-bit parameters within one step of their type."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.amp import GradScaler as JaxScaler
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.ops.kernels.fused_adam import (adam_scalars,
                                                     fused_adam,
                                                     fused_adam_reference)
from paddle_tpu_torch.optimizer import clip as tclip

RTOL_MASTER = 1e-6
STEP_OF = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
SHAPES = {"w": (6, 5), "b": (7,), "emb": (3, 4)}


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol, name


def _inputs(seed, steps, gdtype=np.float32, bad_step=None):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(steps):
        g = {k: (rs.randn(*s) * 3).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == bad_step:
            g["b"][2] = np.inf
        grads.append(g)
    return params, grads


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


CASES = [
    # (name, optimizer kw, multi_precision, param dtype, clip, scaler)
    ("adamw", dict(weight_decay=0.1), False, "float32", None, False),
    ("adamw-mask", dict(weight_decay=0.1,
                        apply_decay_param_fun=lambda n: n != "b"),
     True, "float32", None, False),
    ("adam-l2", dict(weight_decay=0.01), False, "float32", None, False),
    ("adamw-clip", dict(weight_decay=0.1), True, "float32", 1.0, False),
    ("adam-clip-mask", dict(weight_decay=0.05,
                            apply_decay_param_fun=lambda n: n == "w"),
     False, "float32", 0.5, False),
    ("adamw-bf16-masters", dict(weight_decay=0.1), True, "bfloat16", 1.0,
     False),
    ("adamw-scaler", dict(weight_decay=0.1), True, "float32", 1.0, True),
    ("adam-fp16-scaler", dict(weight_decay=0.01), True, "float16", None,
     True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_fused_update_matches_jax_adam(case):
    """Four steps (the third with a non-finite gradient under the
    scaler): parameters, masters, m and v of the plain fused update
    against the JAX optimizer's functional apply behind the JAX
    GradScaler and clip, as the JAX trainer's step composes them."""
    name, kw, mp, pdt, clip, use_scaler = case
    cls = "Adam" if name.startswith("adam-") else "AdamW"
    kw = dict(kw, learning_rate=1e-2, beta1=0.9, beta2=0.95,
              multi_precision=mp)
    params, grads = _inputs(3, 4, bad_step=2 if use_scaler else None)
    tdt = getattr(torch, pdt)
    jopt = getattr(pt.optimizer, cls)(
        grad_clip=jclip.ClipGradByGlobalNorm(clip) if clip else None, **kw)
    topt = getattr(ptt.optimizer, cls)(
        grad_clip=tclip.ClipGradByGlobalNorm(clip) if clip else None, **kw)
    jp = {k: _to_jax(v, getattr(jnp, pdt)) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jsc = tsc = None
    if use_scaler:
        jscaler = JaxScaler(init_loss_scaling=2.0 ** 4,
                            incr_every_n_steps=2)
        tscaler = GradScaler(init_loss_scaling=2.0 ** 4,
                             incr_every_n_steps=2)
        jsc, tsc = jscaler.init_state(), tscaler.init_state("cpu")
    for step, g in enumerate(grads):
        if use_scaler:
            # the scaled gradients the backward of a scaled loss gives
            g = {k: v * float(jsc["scale"]) for k, v in g.items()}
        jg = {k: _to_jax(v, getattr(jnp, pdt)) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        if use_scaler:
            ug, found = jscaler.unscale(jg, jsc)
            cand_p, cand_s = jopt.apply(jp, ug, js, jnp.asarray(step))
            jp = jscaler.select(found, jp, cand_p)
            js = jscaler.select(found, js, cand_s)
            jsc = jscaler.update_state(jsc, found)
            inv = tscaler.inv_scale(tsc)
            tfound = tscaler.found_inf(tg, inv)
            assert bool(tfound) == bool(found)
            topt.apply(tp, tg, ts, step, inv_scale=inv, found_inf=tfound)
            tsc = tscaler.update_state(tsc, tfound)
        else:
            jp, js = jopt.apply(jp, jg, js, jnp.asarray(step))
            topt.apply(tp, tg, ts, step)
    for k in SHAPES:
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        if tdt == torch.float32:
            _close(got, want, RTOL_MASTER, k)
        else:
            _close(got, want, STEP_OF[tdt], k)
        for slot in ("m", "v"):
            _close(ts["slots"][k][slot].numpy(),
                   np.asarray(js["slots"][k][slot]), RTOL_MASTER,
                   f"{k}.{slot}")
        if mp:
            _close(ts["master"][k].numpy(), np.asarray(js["master"][k]),
                   RTOL_MASTER, f"{k} master")
    if use_scaler:
        assert float(tsc["scale"]) == float(jsc["scale"])


def _per_tensor_adam(w, g, m, v, lr, b1, b2, eps, wd, decay, decoupled,
                     step):
    """The port's update before the fused pass, tensor by tensor."""
    t = float(step) + 1.0
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    g = g.float()
    if decay and not decoupled:
        g = g + wd * w
    m.lerp_(g, 1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    root_bc2 = math.sqrt(bc2)
    denom = v.sqrt().add_(eps * root_bc2)
    if decay and decoupled:
        w.mul_(1 - lr * wd)
    w.addcdiv_(m, denom, value=-lr * root_bc2 / bc1)


@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("clip", [None, 0.3])
def test_plain_fused_update_matches_the_per_tensor_path(decoupled, clip):
    """Five steps of the fused plain version against the port's earlier
    per-tensor update (clip applied to the gradients first), fp32."""
    params, grads = _inputs(5, 5)
    names = list(SHAPES)
    decay = [n != "b" for n in names]
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.1)
    ws = [torch.from_numpy(params[n].copy()) for n in names]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    old = [[w.clone() for w in ws], [m.clone() for m in ms],
           [v.clone() for v in vs]]
    for step, g in enumerate(grads):
        tg = [torch.from_numpy(g[n]) for n in names]
        cs = None if clip is None else torch.tensor(clip)
        fused_adam(ws, tg, None, ms, vs, decay, decoupled=decoupled,
                   step=step, clip_scale=cs, **hyper)
        for i, n in enumerate(names):
            gi = tg[i] * cs if cs is not None else tg[i]
            _per_tensor_adam(old[0][i], gi, old[1][i], old[2][i],
                             hyper["lr"], hyper["beta1"], hyper["beta2"],
                             hyper["eps"], hyper["weight_decay"], decay[i],
                             decoupled, step)
    for i, n in enumerate(names):
        _close(ws[i].numpy(), old[0][i].numpy(), RTOL_MASTER, n)
        _close(ms[i].numpy(), old[1][i].numpy(), RTOL_MASTER, n)
        _close(vs[i].numpy(), old[2][i].numpy(), RTOL_MASTER, n)


def test_bias_corrections_are_the_jax_fp32_ones():
    for step in (0, 1, 9, 999):
        _, _, _, _, _, bc1, bc2, _, _ = adam_scalars(1.0, 0.9, 0.999, 1e-8,
                                                     0.0, step)
        t = jnp.asarray(step, jnp.float32) + 1.0
        assert bc1 == pytest.approx(float(1.0 - 0.9 ** t), rel=2 ** -23)
        assert bc2 == pytest.approx(float(1.0 - 0.999 ** t), rel=2 ** -22)


def test_found_inf_leaves_every_tensor_and_cpu_takes_the_plain_version():
    params, grads = _inputs(7, 1)
    names = list(SHAPES)
    ws = [torch.from_numpy(params[n].copy()).bfloat16() for n in names]
    mas = [w.float() for w in ws]
    ms = [torch.full_like(m, 0.1) for m in mas]
    vs = [torch.full_like(m, 0.2) for m in mas]
    before = [t.clone() for t in ws + mas + ms + vs]
    tg = [torch.from_numpy(grads[0][n]).bfloat16() for n in names]
    fused_adam.launches = 0
    fused_adam(ws, tg, mas, ms, vs, [True] * 3, lr=1e-2, beta1=0.9,
               beta2=0.99, eps=1e-8, weight_decay=0.1, decoupled=True,
               step=0, inv_scale=torch.tensor(0.5),
               found_inf=torch.tensor(True))
    for a, b in zip(ws + mas + ms + vs, before):
        assert torch.equal(a, b)
    assert fused_adam.launches == 0          # CPU tensors: no kernel
    fused_adam_reference(ws, tg, mas, ms, vs, [True] * 3, lr=1e-2,
                         beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
                         decoupled=True, step=0)
    assert torch.equal(ws[0], mas[0].bfloat16())
    assert not torch.equal(mas[0], before[3])


def test_shape_and_type_checks():
    w = torch.zeros(4)
    with pytest.raises(ValueError, match="fp32"):
        fused_adam([w], [w], None, [w.double()], [w], [True], lr=1.0,
                   beta1=0.9, beta2=0.9, eps=1e-8, weight_decay=0.0,
                   decoupled=True, step=0)
    with pytest.raises(ValueError, match="sizes"):
        fused_adam([w], [torch.zeros(5)], None, [w], [w], [True], lr=1.0,
                   beta1=0.9, beta2=0.9, eps=1e-8, weight_decay=0.0,
                   decoupled=True, step=0)
