"""The port's remaining optimizers, its moving average of weights and the
optimizers' state_dict against the JAX package's, on the same seeded
numpy parameters and gradients, in fp32 on the CPU: Lamb, Adafactor
(factored and not, with and without beta1), RMSProp (plain, centered,
momentum), Adagrad, Adadelta, Adamax, NAdam, RAdam (both sides of its
rectification switch) and Rprop, 8 applies each; the same fp32 ops in
another order, so within 1e-6 (relative to each tensor's largest
|value|, plus 1e-7 for values near zero)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.optimizer import ema as jema
from paddle_tpu_torch.optimizer import ema as tema

RTOL = 1e-6
ATOL = 1e-7
SHAPES = {"w": (6, 5), "b": (7,), "k": (2, 3, 4)}

OPTIMIZERS = [
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01,
                  exclude_from_weight_decay_fn=lambda n: n == "b")),
    ("Lamb", dict(learning_rate=0.01, multi_precision=True)),
    ("Adafactor", dict(learning_rate=0.01)),
    ("Adafactor", dict(learning_rate=0.01, beta1=0.9, weight_decay=0.01,
                       clip_threshold=0.5)),
    ("RMSProp", dict(learning_rate=0.01, weight_decay=0.01)),
    ("RMSProp", dict(learning_rate=0.01, centered=True, momentum=0.9)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1,
                     weight_decay=0.01)),
    ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    ("NAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    ("RAdam", dict(learning_rate=0.01, beta2=0.9, weight_decay=0.01)),
    ("Rprop", dict(learning_rate=0.01)),
]


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    tol = RTOL * max(float(np.abs(want).max()), 1e-30) + ATOL
    assert float(np.abs(np.asarray(got) - want).max()) <= tol, name


def _inputs(seed, steps):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def _walk(t, j, name):
    if isinstance(t, dict):
        for k in t:
            _walk(t[k], j[k], f"{name}.{k}")
    elif torch.is_tensor(t):
        _close(t.numpy(), j, name)


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_remaining_optimizers_match_jax(name, kw):
    params, grads = _inputs(17, 8)
    jopt = getattr(pt.optimizer, name)(**kw)
    topt = getattr(ptt.optimizer, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js, jnp.asarray(step))
        topt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                   step)
    for k in SHAPES:
        _close(tp[k].numpy(), jp[k], k)
    _walk(ts["slots"], js["slots"], "slots")
    if "master" in ts:
        _walk(ts["master"], js["master"], "master")


def test_state_dict_round_trip_continues_the_same_updates():
    """The stateful facade: after two steps, a fresh optimizer given (a
    copy of) the first one's state_dict makes the same third step. The
    dict holds the live state tensors, which the update moves in place,
    as torch optimizers' state_dict does."""
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    b.load_state_dict(a.state_dict())
    oa = ptt.optimizer.Lamb(learning_rate=0.1, parameters=a)
    for _ in range(2):
        a(torch.randn(2, 4)).sum().backward()
        oa.step()
        oa.clear_grad()
    b.load_state_dict(a.state_dict())
    ob = ptt.optimizer.Lamb(learning_rate=0.1, parameters=b)
    sd = copy.deepcopy(oa.state_dict())
    assert sd["step"] == 2 and set(sd["state"]) == {"slots"}
    ob.set_state_dict(sd)
    x = torch.randn(2, 4)
    for m, o in ((a, oa), (b, ob)):
        m(x).sum().backward()
        o.step()
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("warmup", [False, True])
def test_ema_matches_jax(warmup):
    params, updates = _inputs(21, 5)
    jshadow = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    tshadow = tema.ema_init({k: torch.from_numpy(v)
                             for k, v in params.items()})
    for step, u in enumerate(updates):
        s = step if warmup else None
        jshadow = jema.ema_update(jshadow, {k: jnp.asarray(v)
                                            for k, v in u.items()},
                                  decay=0.99, step=s)
        tema.ema_update(tshadow, {k: torch.from_numpy(v)
                                  for k, v in u.items()}, decay=0.99,
                        step=s)
    for k in SHAPES:
        _close(tshadow[k].numpy(), jshadow[k], k)


def test_ema_facade_swaps_shadows_in_and_back():
    torch.manual_seed(1)
    lin = torch.nn.Linear(3, 2)
    orig = {k: p.detach().clone() for k, p in lin.named_parameters()}
    ema = ptt.optimizer.ExponentialMovingAverage(lin, decay=0.5,
                                                 use_warmup=True)
    with torch.no_grad():
        for p in lin.parameters():
            p.add_(1.0)
    ema.update()                       # step 0: d = min(0.5, 0.1) = 0.1
    ema.apply()
    for k, p in lin.named_parameters():
        torch.testing.assert_close(p, 0.1 * orig[k] + 0.9 * (orig[k] + 1))
    ema.restore()
    for k, p in lin.named_parameters():
        assert torch.equal(p, orig[k] + 1)
    with pytest.raises(ValueError, match="apply"):
        ema.restore()
