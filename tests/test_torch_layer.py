"""The port's module system (``paddle_tpu_torch.nn.Layer``, ``Parameter``,
``Buffer``, ``ParamMeta``), its initializers and the ambient random
stream against the JAX package's ``paddle_tpu/nn/layer.py``,
``nn/initializer.py`` and ``utils/rng.py``, mirroring the Layer cases of
``tests/test_nn.py``.

- a user ``Layer`` with ``create_parameter`` crosses from JAX through
  ``load_jax_state_dict`` (the [in, out] parameter untransposed, the
  ``Linear`` transposed) and gives the JAX outputs within 1e-5;
- ``functional()``'s gradients equal ``jax.grad`` through the JAX
  ``functional()`` within 1e-5; with buffers, BatchNorm's new running
  statistics equal the JAX ones; without, they do not move in either;
- ``set_state_dict(strict=True)`` raises ``KeyError`` on a missing or
  unexpected key, and non-strict returns the JAX (missing, unexpected);
- ``seed(s)`` makes construction reproducible; the initializers' moments
  (mean, std, orthogonality) match the JAX draws at the same shapes
  (threefry has no torch twin: 5 % on a std over >= 2048 draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI

ATOL = 1e-5


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([6, 5])
        self.b = self.create_parameter([5], is_bias=True)
        self.fc = jnn.Linear(5, 3)
        self.drop = jnn.Dropout(0.5)

    def forward(self, x):
        return self.fc(self.drop(jnn.functional.gelu(x @ self.w + self.b)))


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([6, 5], device="cpu")
        self.b = self.create_parameter([5], is_bias=True, device="cpu")
        self.fc = tnn.Linear(5, 3, device="cpu")
        self.drop = tnn.Dropout(0.5)

    def forward(self, x):
        return self.fc(self.drop(tnn.functional.gelu(x @ self.w + self.b)))


def _pair(seed=0):
    pt.seed(seed)
    jnet = JNet()
    tnet = TNet()
    state = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    ptt.load_jax_state_dict(tnet, state)
    return jnet, tnet, state


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_create_parameter_crosses_untransposed_and_matches_jax():
    jnet, tnet, state = _pair()
    assert list(tnet.state_dict()) == list(jnet.state_dict())
    np.testing.assert_array_equal(tnet.w.detach().numpy(), state["w"])
    np.testing.assert_array_equal(tnet.fc.weight.detach().numpy(),
                                  state["fc.weight"].T)
    assert tuple(tnet.w.shape) == (6, 5) and tnet.b.abs().sum() == 0
    jnet.eval()
    tnet.eval()
    x = _x(4, 6)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(jnp.asarray(x))), atol=ATOL)


def test_functional_gradients_match_jax_grad():
    jnet, tnet, _ = _pair(1)
    jnet.eval()
    tnet.eval()
    x = _x(4, 6, seed=2)
    jfn, jparams = jnet.functional()
    tfn, tparams = tnet.functional()
    assert list(tparams) == list(jparams)

    def jloss(p):
        return jnp.sum(jfn(p, jnp.asarray(x)) ** 2)
    jg = jax.grad(jloss)(dict(jparams))
    tg = torch.autograd.grad((tfn(tparams, torch.from_numpy(x)) ** 2).sum(),
                             list(tparams.values()))
    for (name, g) in zip(tparams, tg):
        want = np.asarray(jg[name])
        got = g.numpy().T if name == "fc.weight" else g.numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
    # new parameters bound through the bridge, the layer's left as it was
    moved = {k: v + 1.0 for k, v in tparams.items()}
    before = tnet(torch.from_numpy(x))
    shifted = tfn(moved, torch.from_numpy(x))
    assert not torch.allclose(shifted, before)
    assert torch.equal(tnet(torch.from_numpy(x)), before)


def test_functional_generator_routes_every_dropout():
    _, tnet, _ = _pair(3)
    tfn, tparams = tnet.functional()
    x = torch.from_numpy(_x(64, 6, seed=4))
    a = tfn(tparams, x, generator=ptt.make_generator(7, "cpu"))
    b = tfn(tparams, x, generator=ptt.make_generator(7, "cpu"))
    c = tfn(tparams, x, generator=ptt.make_generator(8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_functional_buffers_as_jax():
    pt.seed(0)
    jbn = jnn.BatchNorm2D(3)
    tbn = tnn.BatchNorm2D(3, device="cpu")
    x = _x(4, 3, 5, 5, seed=5) * 2 + 1
    jfn, (jp, jb) = jbn.functional(with_buffers=True)
    tfn, (tp, tb) = tbn.functional(with_buffers=True)
    assert list(tb) == list(jb) == ["_mean", "_variance"]
    jout, jnew = jfn(jp, jb, jnp.asarray(x))
    tout, tnew = tfn(tp, tb, torch.from_numpy(x))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   atol=ATOL)
    # the layer's own statistics did not move, in either package
    np.testing.assert_array_equal(tbn._mean.numpy(), np.zeros(3))
    np.testing.assert_array_equal(np.asarray(jbn._mean), np.zeros(3))
    pfn, params = tbn.functional()
    pfn(params, torch.from_numpy(x))
    np.testing.assert_array_equal(tbn._variance.numpy(), np.ones(3))


def test_set_state_dict_strict_and_not_as_jax():
    jnet, tnet, state = _pair()
    tstate = {k: v.numpy().copy() for k, v in tnet.state_dict().items()}
    for net, st, conv in ((jnet, state, jnp.asarray),
                          (tnet, tstate, torch.from_numpy)):
        with pytest.raises(KeyError, match="missing"):
            net.set_state_dict({k: conv(v) for k, v in st.items()
                                if k != "b"})
    want = jnet.set_state_dict(
        {**{k: jnp.asarray(v) for k, v in state.items() if k != "b"},
         "bogus": jnp.zeros(2)}, strict=False)
    got = tnet.load_dict({**{k: v + 1 for k, v in tstate.items()
                             if k != "b"}, "bogus": np.zeros(2)},
                         strict=False)
    assert got == want == (["b"], ["bogus"])
    np.testing.assert_array_equal(tnet.w.detach().numpy(), state["w"] + 1)
    sd = tnet.state_dict()
    other = TNet()
    other.set_state_dict(sd)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k])


def test_seed_makes_construction_reproducible():
    ptt.seed(11)
    a = TNet()
    state = ptt.get_rng_state()
    b = TNet()
    ptt.set_rng_state(state)
    c = TNet()
    ptt.seed(11)
    d = TNet()
    for x, y in zip(a.parameters(), d.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(b.parameters(), c.parameters()):
        assert torch.equal(x, y)
    assert not torch.equal(a.w, b.w)
    assert ptt.seed(3) == 3


def test_state_dict_roundtrip_as_test_nn():
    model = tnn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.ReLU(),
                           tnn.Linear(8, 2, device="cpu"))
    sd = model.state_dict()
    assert set(sd) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    model2 = tnn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.ReLU(),
                            tnn.Linear(8, 2, device="cpu"))
    model2.set_state_dict(sd)
    x = torch.ones(1, 4)
    assert torch.allclose(model(x), model2(x))


def test_train_eval_dropout_as_test_nn():
    d = tnn.Dropout(0.5)
    x = torch.ones(100)
    d.eval()
    assert torch.allclose(d(x), torch.ones(100))
    d.train()
    out = d(x)
    assert (out == 0).any() and (out > 1).any()


def test_sublayer_traversal_and_apply_as_test_nn():
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(2, 2), jnn.Sequential(jnn.Linear(2, 2)))
    tm = tnn.Sequential(tnn.Linear(2, 2, device="cpu"),
                        tnn.Sequential(tnn.Linear(2, 2, device="cpu")))
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    count = []
    tm.apply(lambda l: count.append(type(l).__name__))
    assert "Linear" in count and "Sequential" in count
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert [n for n, _ in tm.named_sublayers(prefix="m", include_self=True)] \
        == [n for n, _ in jm.named_sublayers(prefix="m", include_self=True)]
    assert len(tm.sublayers()) == len(jm.sublayers()) == 3
    assert len(tm.sublayers(include_self=True)) == 4
    assert tm.full_name() == jm.full_name() == "Sequential"


def test_registration_meta_and_hooks_as_jax():
    pt.seed(0)
    layers = {}
    for lib, L in (("jax", jnn), ("torch", tnn)):
        m = L.Layer("scope")
        m.add_sublayer("fc", L.Linear(3, 2, **({} if lib == "jax" else
                                               dict(device="cpu"))))
        m.add_parameter("scale", np.ones(2, np.float32))
        m.frozen = L.Parameter(np.zeros(3, np.float32), trainable=False,
                               partition=("tp",))
        m.register_buffer("stat", np.zeros(2, np.float32))
        m.register_buffer("scratch", np.zeros(2, np.float32),
                          persistable=False)
        m.kept = L.Buffer(np.ones(1, np.float32), persistable=True)
        layers[lib] = m
    jm, tm = layers["jax"], layers["torch"]
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert "scratch" not in tm.state_dict()
    assert tm.full_name() == jm.full_name() == "scope"
    jmeta, tmeta = jm.param_meta(), tm.param_meta()
    assert sorted(tmeta) == sorted(jmeta)
    for k in jmeta:
        assert (tmeta[k].trainable, tmeta[k].partition) == \
            (jmeta[k].trainable, jmeta[k].partition), k
    assert list(tm.trainable_parameters()) == \
        [k for k in jm.trainable_parameters()]
    assert not tm.frozen.requires_grad
    tm.stop_gradient_()
    jm.stop_gradient_()
    assert tm.trainable_parameters() == {} and \
        dict(jm.trainable_parameters()) == {}
    tm.stop_gradient_(False)
    assert len(tm.trainable_parameters()) == 4

    seen = []
    tm.fc.register_forward_pre_hook(lambda mod, args: (args[0] * 2,))
    tm.fc.register_forward_post_hook(
        lambda mod, args, out: seen.append(out.shape) or out + 1)
    x = torch.ones(1, 3)
    want = tnn.functional.linear(x * 2, tm.fc.weight, tm.fc.bias) + 1
    assert torch.allclose(tm.fc(x), want) and seen == [(1, 2)]


def test_astype_and_to_take_paddle_dtype_names():
    m = tnn.Sequential(tnn.Linear(3, 2, device="cpu"),
                       tnn.BatchNorm1D(2, device="cpu"))
    m.astype("bfloat16")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    assert m[1]._mean.dtype == torch.bfloat16
    m.to("float32")
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    m.to(dtype="float16", device="cpu")
    assert {p.dtype for p in m.parameters()} == {torch.float16}


# ------------------------------------------------------------ initializers
def _jdraw(init, shape):
    return np.asarray(init(jax.random.key(0), shape))


@pytest.mark.parametrize("name,kw,jshape", (
    ("XavierUniform", {}, (256, 128)),
    ("XavierUniform", {"gain": 2.0}, (32, 16, 3, 3)),
    ("KaimingNormal", {}, (256, 128)),
    ("KaimingNormal", {"negative_slope": 0.2, "nonlinearity": "leaky_relu"},
     (32, 16, 3, 3)),
    ("KaimingUniform", {}, (64, 512)),
    ("XavierNormal", {}, (16, 8, 5, 5)),
    ("normal", {"mean": 1.0, "std": 0.5}, (64, 64)),
    ("uniform", {"low": -0.2, "high": 0.6}, (64, 64)),
))
def test_initializer_moments_match_jax(name, kw, jshape):
    import paddle_tpu.nn.initializer as JI
    want = _jdraw(getattr(JI, name)(**kw), jshape)
    # the port's Linear stores a 2-D weight [out, in]: the JAX shape
    # reversed, its fans read from the JAX shape
    port_shape = jshape[::-1] if len(jshape) == 2 else jshape
    t = torch.empty(port_shape)
    getattr(TI, name)(**kw)(t, ptt.make_generator(0, "cpu"))
    got = t.numpy()
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.05)
    np.testing.assert_allclose(got.mean(), want.mean(), atol=0.05 * want.std()
                               + 0.01 * abs(want.mean()))
    assert abs(got.max() - want.max()) < 0.35 * want.std() or name in (
        "KaimingNormal", "XavierNormal", "normal")
    # create_parameter's tensors are in the JAX shape themselves
    t2 = torch.empty(jshape)
    getattr(TI, name)(**kw)(t2, ptt.make_generator(1, "cpu"), jax_layout=True)
    np.testing.assert_allclose(t2.numpy().std(), want.std(), rtol=0.05)


@pytest.mark.parametrize("jshape", ((64, 32), (32, 64), (8, 4, 3, 3)))
def test_orthogonal_as_jax(jshape):
    import paddle_tpu.nn.initializer as JI
    want = _jdraw(JI.Orthogonal(gain=1.5), jshape)
    t = torch.empty(jshape)
    TI.Orthogonal(gain=1.5)(t, ptt.make_generator(0, "cpu"), jax_layout=True)
    for w in (want, t.numpy()):
        m = w.reshape(-1, jshape[-1])
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)), atol=1e-4)
    if len(jshape) == 2:
        # a port Linear weight is the transposed draw
        lin = tnn.Linear(jshape[0], jshape[1], weight_attr=TI.Orthogonal(),
                         device="cpu")
        w = lin.weight.detach().numpy().T
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-4)


def test_assign_and_constant_as_jax():
    import paddle_tpu.nn.initializer as JI
    v = _x(5, 3)
    pt.seed(0)
    jl = jnn.Linear(5, 3, weight_attr=JI.Assign(v),
                    bias_attr=JI.constant(0.5))
    tl = tnn.Linear(5, 3, weight_attr=TI.Assign(v),
                    bias_attr=TI.constant(0.5), device="cpu")
    x = _x(2, 5, seed=1)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), atol=ATOL)
    with pytest.raises(ValueError, match="shape"):
        tnn.Linear(3, 5, weight_attr=TI.Assign(v), device="cpu")
    assert tnn.Linear(5, 3, bias_attr=False, device="cpu").bias is None
