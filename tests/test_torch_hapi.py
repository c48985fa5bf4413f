"""The port's ``paddle.Model`` (``hapi``), ``metric`` and the ``nn`` loss
layers against the JAX package's on the same inputs, made from a numpy
seed, with the weights crossed by ``load_jax_state_dict``.

- every loss layer of ``nn/loss.py`` and every loss function it calls,
  under each ``reduction``: within 1e-5 (fp32);
- ``Accuracy(topk=(1, 5))``, ``Precision``, ``Recall`` and ``Auc``:
  equal values (host counters over the same hits);
- ``Model.fit`` on the JAX test's ``Sequential(Linear, GELU, Linear)``
  with AdamW: the loss history within rtol 1e-5, the parameters within
  1e-5; ``evaluate`` (loss within 1e-5, accuracy equal), ``predict``
  (within 1e-5) and ``summary`` (equal text);
- the trap: a ``resnet_tiny`` ``fit`` then ``evaluate``/``predict``.
  Both packages move the parameters, keep BatchNorm's running statistics
  where they were (the JAX ``Model`` runs ``network.functional()``
  without buffers) and evaluate in eval mode: parameters within 1e-5,
  buffers equal, outputs within 1e-4;
- ``save``/``load`` round-trips the parameters and the optimizer state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.nn import functional as F

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ losses
def _inputs(name, rs):
    """(positional inputs, layer kwargs) for loss ``name``; floats fp32."""
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    sign = lambda n: np.where(rs.rand(n) > 0.5, 1.0, -1.0).astype(  # noqa
        np.float32)
    if name == "CrossEntropyLoss":
        lab = rs.randint(0, 5, 6).astype(np.int64)
        lab[2] = -100
        return [f(6, 5), lab], dict(weight=rs.rand(5).astype(np.float32),
                                    label_smoothing=0.1)
    if name in ("MSELoss", "L1Loss"):
        return [f(4, 3), f(4, 3)], {}
    if name == "SmoothL1Loss":
        return [f(4, 3), f(4, 3)], dict(delta=0.5)
    if name == "BCELoss":
        return ([1 / (1 + np.exp(-f(4, 3))),
                 (rs.rand(4, 3) > 0.5).astype(np.float32)],
                dict(weight=rs.rand(3).astype(np.float32)))
    if name == "BCEWithLogitsLoss":
        return ([f(4, 3) * 4, (rs.rand(4, 3) > 0.5).astype(np.float32)],
                dict(weight=rs.rand(3).astype(np.float32),
                     pos_weight=(rs.rand(3) + 0.5).astype(np.float32)))
    if name == "NLLLoss":
        x = f(6, 5)
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        lab = rs.randint(0, 5, 6).astype(np.int64)
        lab[0] = -100
        return [lp.astype(np.float32), lab], dict(
            weight=rs.rand(5).astype(np.float32))
    if name == "KLDivLoss":
        x = f(4, 5)
        lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
        q = rs.rand(4, 5).astype(np.float32)
        q[0, 0] = 0.0
        return [lp, q / q.sum(-1, keepdims=True)], {}
    if name == "CTCLoss":
        return [f(2, 8, 5), rs.randint(1, 5, (2, 3)).astype(np.int64),
                np.array([8, 6], np.int64), np.array([3, 2], np.int64)], \
            dict(blank=0)
    if name == "TripletMarginLoss":
        return [f(4, 6), f(4, 6), f(4, 6)], dict(margin=0.5, p=2.0)
    if name == "MarginRankingLoss":
        return [f(5), f(5), sign(5)], dict(margin=0.2)
    if name in ("SoftMarginLoss", "HingeEmbeddingLoss"):
        return [f(5), sign(5)], {}
    if name == "CosineEmbeddingLoss":
        return [f(4, 6), f(4, 6), sign(4)], dict(margin=0.1)
    if name == "PoissonNLLLoss":
        return [f(4, 3), rs.poisson(2.0, (4, 3)).astype(np.float32)], \
            dict(full=True)
    if name == "MultiLabelSoftMarginLoss":
        return [f(4, 5), (rs.rand(4, 5) > 0.5).astype(np.float32)], \
            dict(weight=rs.rand(5).astype(np.float32))
    if name == "GaussianNLLLoss":
        var = rs.rand(4, 3).astype(np.float32)
        var[0, 0] = 1e-9                 # clamped to epsilon in both
        return [f(4, 3), f(4, 3), var], dict(full=True)
    raise KeyError(name)


LAYERS = ("CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
          "BCELoss", "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss", "CTCLoss",
          "TripletMarginLoss", "MarginRankingLoss", "SoftMarginLoss",
          "HingeEmbeddingLoss", "CosineEmbeddingLoss", "PoissonNLLLoss",
          "MultiLabelSoftMarginLoss", "GaussianNLLLoss")
REDUCTIONS = ("mean", "sum", "none")


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _check(got, want):
    got = got.detach().numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=1e-5)


def test_every_jax_loss_layer_is_ported():
    from paddle_tpu.nn import loss as jloss
    names = {n for n, v in vars(jloss).items()
             if isinstance(v, type) and n.endswith("Loss")
             and not n.startswith("_")}
    assert names == set(LAYERS)
    assert all(hasattr(tnn, n) for n in names)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", LAYERS)
def test_loss_layer_matches_jax(name, reduction):
    args, kw = _inputs(name, np.random.RandomState(LAYERS.index(name)))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jl = getattr(jnn, name)(reduction=reduction, **jkw)
    tl = getattr(tnn, name)(reduction=reduction, **tkw)
    pairs = [_both(a) for a in args]
    want = jl(*[j for j, _ in pairs])
    _check(tl(*[t for _, t in pairs]), want)


FUNCTIONS = (
    ("nll_loss", "NLLLoss", ("weight",)),
    ("mse_loss", "MSELoss", ()),
    ("l1_loss", "L1Loss", ()),
    ("smooth_l1_loss", "SmoothL1Loss", ("delta",)),
    ("binary_cross_entropy", "BCELoss", ("weight",)),
    ("binary_cross_entropy_with_logits", "BCEWithLogitsLoss",
     ("weight", "pos_weight")),
    ("kl_div", "KLDivLoss", ()),
    ("poisson_nll_loss", "PoissonNLLLoss", ("full",)),
    ("hinge_embedding_loss", "HingeEmbeddingLoss", ()),
    ("margin_ranking_loss", "MarginRankingLoss", ("margin",)),
    ("soft_margin_loss", "SoftMarginLoss", ()),
    ("multi_label_soft_margin_loss", "MultiLabelSoftMarginLoss",
     ("weight",)),
    ("cosine_embedding_loss", "CosineEmbeddingLoss", ("margin",)),
    ("triplet_margin_loss", "TripletMarginLoss", ("margin", "p")),
)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("fn,layer,keys", FUNCTIONS,
                         ids=[f for f, _, _ in FUNCTIONS])
def test_loss_function_matches_jax(fn, layer, keys, reduction):
    args, kw = _inputs(layer, np.random.RandomState(100 + LAYERS.index(
        layer)))
    pairs = [_both(a) for a in args]
    for use in ((), keys):   # the defaults, then the layer's arguments
        jkw = {k: jnp.asarray(kw[k]) if isinstance(kw[k], np.ndarray)
               else kw[k] for k in use}
        tkw = {k: torch.from_numpy(kw[k]) if isinstance(kw[k], np.ndarray)
               else kw[k] for k in use}
        want = getattr(jnn.functional, fn)(*[j for j, _ in pairs],
                                           reduction=reduction, **jkw)
        _check(getattr(F, fn)(*[t for _, t in pairs], reduction=reduction,
                              **tkw), want)


def test_loss_gradients_match_jax():
    """The gradient of a mean loss through the layer, for the losses
    whose JAX form has a clamp or a branch (where a torch op could pick
    the other side at a tie)."""
    import jax
    for name in ("SmoothL1Loss", "BCEWithLogitsLoss", "TripletMarginLoss",
                 "HingeEmbeddingLoss", "MultiLabelSoftMarginLoss"):
        args, kw = _inputs(name, np.random.RandomState(7))
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jl, tl = getattr(jnn, name)(**jkw), getattr(tnn, name)(**tkw)
        rest = [jnp.asarray(a) for a in args[1:]]
        want = jax.grad(lambda x: jl(x, *rest))(jnp.asarray(args[0]))
        x = torch.from_numpy(args[0]).requires_grad_(True)
        tl(x, *[torch.from_numpy(a) for a in args[1:]]).backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-5, err_msg=name)


# ----------------------------------------------------------------- metrics
def test_metrics_match_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(20, 10).astype(np.float32)
    labels = rs.randint(0, 10, 20)
    for lab in (labels, labels[:, None], np.eye(10)[labels]):
        ja, ta = pt.metric.Accuracy(topk=(1, 5)), \
            ptt.metric.Accuracy(topk=(1, 5))
        jc = ja.compute(jnp.asarray(logits), jnp.asarray(lab))
        tc = ta.compute(torch.from_numpy(logits), torch.from_numpy(lab))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for half in (slice(0, 8), slice(8, 20)):
            assert ta.update(tc[half]) == ja.update(jc[half])
        assert ta.accumulate() == ja.accumulate() and ta.name() == "acc"
    one = ptt.metric.Accuracy()
    assert one.update(one.compute(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
        pt.metric.Accuracy().update(np.asarray(pt.metric.Accuracy().compute(
            jnp.asarray(logits), jnp.asarray(labels))))
    probs = rs.rand(50).astype(np.float32)
    truth = (rs.rand(50) > 0.4).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        jm, tm = getattr(pt.metric, cls)(), getattr(ptt.metric, cls)()
        for part in (slice(0, 20), slice(20, 50)):
            jm.update(probs[part], truth[part])
            tm.update(torch.from_numpy(probs[part]),
                      torch.from_numpy(truth[part]))
        assert tm.accumulate() == jm.accumulate(), cls
        assert tm.name() == jm.name()
    two = np.stack([1 - probs, probs], -1)
    ja, ta = pt.metric.Auc(num_thresholds=200), \
        ptt.metric.Auc(num_thresholds=200)
    ja.update(two, truth)
    ta.update(torch.from_numpy(two), torch.from_numpy(truth))
    assert ta.accumulate() == ja.accumulate() > 0.0


# ------------------------------------------------------------------- Model
def _cls_data(n=64, d=8, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(d, classes)
    x = rs.randn(n, d).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    return x, y


def _batches(x, y, bs):
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x), bs)]


def _mlp_pair(d=8, classes=4):
    pt.seed(0)
    jnet = jnn.Sequential(jnn.Linear(d, 32), jnn.GELU(),
                          jnn.Linear(32, classes))
    g = torch.Generator().manual_seed(0)
    tnet = tnn.Sequential(tnn.Linear(d, 32, generator=g, device="cpu"),
                          tnn.GELU(),
                          tnn.Linear(32, classes, generator=g, device="cpu"))
    ptt.load_jax_state_dict(tnet, {k: np.asarray(v) for k, v in
                                   jnet.state_dict().items()})
    return jnet, tnet


def _params_close(tnet, jmodel, atol=ATOL):
    want = {k: np.asarray(v) for k, v in jmodel.network.state_dict().items()}
    for k, p in tnet.state_dict().items():
        got = p.detach().numpy()
        if got.ndim == 2:            # a Linear weight: [in, out] in JAX
            got = got.T
        np.testing.assert_allclose(got, want[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("loss", ("function", "layer"))
def test_fit_matches_jax_loss_history_and_parameters(loss):
    x, y = _cls_data()
    jnet, tnet = _mlp_pair()
    jm, tm = pt.Model(jnet), ptt.Model(tnet)
    jm.prepare(pt.optimizer.AdamW(learning_rate=5e-2),
               loss=(jnn.functional.cross_entropy if loss == "function"
                     else jnn.CrossEntropyLoss()),
               metrics=pt.metric.Accuracy(topk=(1, 3)))
    tm.prepare(ptt.optimizer.AdamW(learning_rate=5e-2),
               loss=(F.cross_entropy if loss == "function"
                     else tnn.CrossEntropyLoss()),
               metrics=ptt.metric.Accuracy(topk=(1, 3)))
    kw = dict(epochs=4, log_freq=3, verbose=0)
    want = jm.fit(_batches(x, y, 16), **kw)
    got = tm.fit(_batches(x, y, 16), **kw)
    assert len(got["loss"]) == len(want["loss"]) == 8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
    assert got["loss"][-1] < got["loss"][0]
    _params_close(tnet, jm)
    jres = jm.evaluate(_batches(x, y, 16), verbose=0)
    tres = tm.evaluate(_batches(x, y, 16), verbose=0)
    assert tres.keys() == jres.keys()
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    assert tres["acc"] == jres["acc"]
    jout = jm.predict([(x[:40],), (x[40:],)])
    tout = tm.predict([(x[:40],), (x[40:],)])
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_fit_with_eval_data_and_callbacks_as_jax():
    x, y = _cls_data(seed=1)

    class Rec:
        def __init__(self):
            self.seen = []

        def on_train_batch_end(self, step, logs):
            self.seen.append(("batch", step, round(logs["loss"], 4)))

        def on_epoch_end(self, epoch, logs):
            self.seen.append(("epoch", epoch, sorted(logs)))

    runs = []
    for lib, net, opt, loss in (
            (pt, _mlp_pair()[0], pt.optimizer.AdamW, jnn.CrossEntropyLoss),
            (ptt, _mlp_pair()[1], ptt.optimizer.AdamW,
             tnn.CrossEntropyLoss)):
        m = lib.Model(net).prepare(opt(learning_rate=1e-2), loss=loss())
        rec = Rec()
        hist = m.fit(_batches(x, y, 16), eval_data=_batches(x, y, 32),
                     epochs=2, log_freq=2, verbose=0, callbacks=[rec])
        runs.append((hist, rec.seen))
    (jh, jseen), (th, tseen) = runs
    assert tseen == jseen
    for k in ("loss", "eval_loss"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-5)


def test_prepare_is_required_and_batches_are_pairs():
    _, tnet = _mlp_pair()
    m = ptt.Model(tnet)
    with pytest.raises(RuntimeError, match="prepare"):
        m.fit([])
    with pytest.raises(RuntimeError, match="prepare"):
        m.predict([])
    m.prepare(ptt.optimizer.AdamW(learning_rate=1e-3),
              loss=F.cross_entropy)
    x, y = _cls_data(n=4)
    with pytest.raises(TypeError, match="2-tuples"):
        m.fit([(x, x, y)])


def test_dataset_input_and_summary_match_jax():
    x, y = _cls_data()
    jnet, tnet = _mlp_pair()
    jm = pt.Model(jnet).prepare(pt.optimizer.AdamW(learning_rate=5e-2),
                                loss=jnn.functional.cross_entropy)
    tm = ptt.Model(tnet).prepare(ptt.optimizer.AdamW(learning_rate=5e-2),
                                 loss=F.cross_entropy)
    want = jm.fit(pt.io.TensorDataset([x, y]), batch_size=16, epochs=2,
                  shuffle=False, verbose=0)
    got = tm.fit(ptt.io.TensorDataset([x, y]), batch_size=16, epochs=2,
                 shuffle=False, verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    js, ts = pt.summary(jnet), ptt.summary(tnet)
    assert ts == js and ts["total_params"] == 8 * 32 + 32 + 32 * 4 + 4
    jr = jresnet.ResNet(jresnet.resnet_tiny())
    tr = resnet.ResNet(resnet.resnet_tiny(), device="cpu")
    assert ptt.summary(tr) == pt.summary(jr)


def _resnet_pair():
    """``resnet_tiny`` in both packages with the JAX weights plus seeded
    noise and BatchNorm variances drawn in [0.5, 1.5) (non-trivial
    running statistics), as ``tests/test_torch_vision.py`` builds it."""
    pt.seed(21)
    jnet = jresnet.ResNet(jresnet.resnet_tiny())
    rs = np.random.RandomState(121)
    sd = {}
    for k, v in jnet.state_dict().items():
        v = np.asarray(v)
        if k.endswith("_variance"):
            v = rs.uniform(0.5, 1.5, v.shape)
        elif np.issubdtype(v.dtype, np.floating):
            v = v + 0.05 * rs.randn(*v.shape)
        sd[k] = np.asarray(v, np.float32)
    jnet.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tnet = resnet.ResNet(resnet.resnet_tiny(), device="cpu")
    ptt.load_jax_state_dict(tnet, sd)
    return jnet, tnet, sd


def test_resnet_fit_keeps_buffers_and_evaluates_in_eval_mode_as_jax():
    """The trap: the JAX ``Model`` trains ``network.functional()`` without
    buffers, so BatchNorm normalises by each batch's statistics and its
    running statistics stay where they were; ``evaluate`` and
    ``predict`` run in eval mode over those running statistics, and the
    network's mode comes back after."""
    jnet, tnet, sd = _resnet_pair()
    rs = np.random.RandomState(22)
    px = rs.randn(8, 3, 32, 32).astype(np.float32)
    lab = rs.randint(0, 10, 8).astype(np.int64)
    data = [(px[:4], lab[:4]), (px[4:], lab[4:])]
    jm = pt.Model(jnet).prepare(pt.optimizer.SGD(learning_rate=0.01),
                                loss=jnn.CrossEntropyLoss(),
                                metrics=pt.metric.Accuracy(topk=(1, 5)))
    tm = ptt.Model(tnet).prepare(ptt.optimizer.SGD(learning_rate=0.01),
                                 loss=tnn.CrossEntropyLoss(),
                                 metrics=ptt.metric.Accuracy(topk=(1, 5)))
    assert tnet.training and jnet.training
    want = jm.fit(data, epochs=2, log_freq=1, verbose=0)
    got = tm.fit(data, epochs=2, log_freq=1, verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, atol=0)
    jparams = {k: np.asarray(v) for k, v in jm._params.items()}
    for k, p in tnet.named_parameters():
        got = p.detach().numpy()
        got = got.T if got.ndim == 2 else got   # the head: [in, out] in JAX
        np.testing.assert_allclose(got, jparams[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    buffers = [k for k in sd if k not in jparams]
    assert buffers and all(k.endswith(("_mean", "_variance"))
                           for k in buffers)
    for k in buffers:
        np.testing.assert_array_equal(tnet.state_dict()[k].numpy(), sd[k])
        np.testing.assert_array_equal(np.asarray(jnet.state_dict()[k]),
                                      sd[k])
    jres = jm.evaluate(data, verbose=0)
    tres = tm.evaluate(data, verbose=0)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    assert tres["acc"] == jres["acc"]
    # the port's eval forward on the JAX package's trained parameters
    # gives the JAX outputs within 1e-4; its own parameters (within 1e-5
    # of JAX's) are amplified by the eval-mode BatchNorms over running
    # statistics that do not fit the activations (logits ~20): there the
    # outputs agree within 5e-4 of the largest |logit|
    ref = resnet.ResNet(resnet.resnet_tiny(), device="cpu")
    ptt.load_jax_state_dict(ref, {**{k: sd[k] for k in buffers},
                                  **jparams})
    ref.eval()
    jout = jm.predict(data)
    for (x, _), b in zip(data, jout):
        with torch.no_grad():
            a = ref(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(tm.predict(data), jout):
        np.testing.assert_allclose(a, b, atol=5e-4 * np.abs(b).max(),
                                   rtol=0)
    assert tnet.training and jnet.training      # the mode came back
    for k in buffers:
        np.testing.assert_array_equal(tnet.state_dict()[k].numpy(), sd[k])


def test_save_load_round_trips(tmp_path):
    x, y = _cls_data()
    _, tnet = _mlp_pair()
    m = ptt.Model(tnet).prepare(ptt.optimizer.AdamW(learning_rate=5e-2),
                                loss=F.cross_entropy)
    m.fit(_batches(x, y, 16), epochs=2, verbose=0)
    path = str(tmp_path / "m")
    m.save(path)
    fresh_net = _mlp_pair()[1]
    fresh = ptt.Model(fresh_net).prepare(
        ptt.optimizer.AdamW(learning_rate=5e-2), loss=F.cross_entropy)
    fresh.load(path)
    for (k, a), (_, b) in zip(tnet.state_dict().items(),
                              fresh_net.state_dict().items()):
        assert torch.equal(a, b), k
    for k, slot in m._opt_state["slots"].items():
        for s in ("m", "v"):
            assert torch.equal(slot[s], fresh._opt_state["slots"][k][s])
    for a, b in zip(m.predict([(x,)]), fresh.predict([(x,)])):
        np.testing.assert_array_equal(a, b)
    h1 = m.fit(_batches(x, y, 16), epochs=1, verbose=0)
    h2 = fresh.fit(_batches(x, y, 16), epochs=1, verbose=0)
    assert h1 == h2
    again = ptt.Model(_mlp_pair()[1]).prepare(
        ptt.optimizer.AdamW(learning_rate=5e-2), loss=F.cross_entropy)
    again.load(path, reset_optimizer=True)
    assert again._opt_state is None
