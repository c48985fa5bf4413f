"""The rest of the port's ``nn`` against the JAX package's: every function
of ``paddle_tpu/nn/functional.py`` that the port lacked before (58) and
every layer of ``nn/common.py``, ``nn/activation.py`` and
``nn/container.py`` it lacked (50), on the same inputs made from a numpy
seed, at fp32.

- deterministic functions: values within 1e-5 (absolute and relative),
  and the gradient of sum(out * w) for a fixed numpy w within 1e-4;
- layers: outputs within 1e-5, their weights crossed from the JAX layer
  by ``load_jax_state_dict`` (``Bilinear``'s [out, in1, in2] and
  ``PReLU``'s [n] are not transposed);
- the random ones (``dropout2d``, ``dropout3d``, ``alpha_dropout``,
  ``rrelu``, ``gumbel_softmax`` and their layers): threefry has no torch
  twin, so both packages are held to the same invariants (mask shares,
  scales, eval identity), and the port's draws are pinned bit for bit
  under one seed;
- ``hsigmoid_loss`` and ``grid_sample(padding_mode="reflection")`` raise
  ``NotImplementedError`` in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _f(rs, *shape, lo=None, hi=None):
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _unpool_inputs(rs):
    x = torch.from_numpy(_f(rs, 1, 2, 8, 8))
    pooled, idx = torch.nn.functional.max_pool2d(x, 2, 2,
                                                 return_indices=True)
    return [pooled.numpy(), idx.numpy()], {}


# name -> builder(rs) -> (args, kwargs); float32 arrays are the inputs
# (the first one is differentiated), everything else passes as is
CASES = {
    "relu6": lambda rs: ([_f(rs, 4, 6) * 4], {}),
    "leaky_relu": lambda rs: ([_f(rs, 4, 6)], {"negative_slope": 0.2}),
    "prelu": lambda rs: ([_f(rs, 2, 3, 4), _f(rs, 1, 3, 1, lo=0.1,
                                             hi=0.4)], {}),
    "elu": lambda rs: ([_f(rs, 4, 6)], {"alpha": 0.7}),
    "selu": lambda rs: ([_f(rs, 4, 6)], {}),
    "celu": lambda rs: ([_f(rs, 4, 6)], {"alpha": 1.3}),
    "swish": lambda rs: ([_f(rs, 4, 6)], {}),
    "mish": lambda rs: ([_f(rs, 4, 6)], {}),
    "hardswish": lambda rs: ([_f(rs, 4, 6) * 4], {}),
    "hardsigmoid": lambda rs: ([_f(rs, 4, 6) * 4], {}),
    "hardtanh": lambda rs: ([_f(rs, 4, 6) * 2], {"min": -0.5, "max": 0.7}),
    "hardshrink": lambda rs: ([_f(rs, 4, 6)], {"threshold": 0.3}),
    "softshrink": lambda rs: ([_f(rs, 4, 6)], {"threshold": 0.3}),
    "tanhshrink": lambda rs: ([_f(rs, 4, 6)], {}),
    "softplus": lambda rs: ([_f(rs, 4, 6) * 15], {"beta": 1.5}),
    "softsign": lambda rs: ([_f(rs, 4, 6)], {}),
    "log_sigmoid": lambda rs: ([_f(rs, 4, 6) * 5], {}),
    "softmax": lambda rs: ([_f(rs, 3, 4, 5)], {"axis": 1}),
    "log_softmax": lambda rs: ([_f(rs, 3, 4, 5)], {"axis": 0}),
    "glu": lambda rs: ([_f(rs, 3, 8)], {"axis": -1}),
    "swiglu": lambda rs: ([_f(rs, 3, 8), _f(rs, 3, 8)], {}),
    "pixel_shuffle": lambda rs: ([_f(rs, 2, 8, 3, 3), 2], {}),
    "pixel_unshuffle": lambda rs: ([_f(rs, 2, 2, 6, 4), 2], {}),
    "channel_shuffle": lambda rs: ([_f(rs, 2, 6, 3, 3), 3], {}),
    "unfold": lambda rs: ([_f(rs, 2, 3, 8, 7), 3, 2, 1, 1], {}),
    "fold": lambda rs: ([_f(rs, 2, 27, 16), (8, 7), 3, 2, 1, 1], {}),
    "softmax_with_cross_entropy": lambda rs: (
        [_f(rs, 5, 7), rs.randint(0, 7, 5).astype(np.int64)], {}),
    "cosine_similarity": lambda rs: ([_f(rs, 4, 6, 3), _f(rs, 4, 6, 3)],
                                     {"axis": 1}),
    "one_hot": lambda rs: ([np.array([[0, 3], [4, 1]], np.int64), 5], {}),
    "label_smooth": lambda rs: ([np.eye(5, dtype=np.float32)[[1, 3, 0]]],
                                {"epsilon": 0.2}),
    "temporal_shift": lambda rs: ([_f(rs, 6, 8, 2, 2), 3],
                                  {"shift_ratio": 0.25}),
    "pad": lambda rs: ([_f(rs, 2, 3, 5, 6), [1, 2, 2, 1]],
                       {"mode": "reflect"}),
    "zeropad2d": lambda rs: ([_f(rs, 2, 3, 4, 5), (1, 2, 3, 4)], {}),
    "max_pool1d": lambda rs: ([_f(rs, 2, 3, 12), 3, 2, 1], {}),
    "avg_pool1d": lambda rs: ([_f(rs, 2, 3, 12), 3, 2, 1], {}),
    "max_pool3d": lambda rs: ([_f(rs, 1, 2, 6, 6, 6), 2, 2], {}),
    "avg_pool3d": lambda rs: ([_f(rs, 1, 2, 5, 6, 6), 3, 2, 1], {}),
    "adaptive_avg_pool1d": lambda rs: ([_f(rs, 2, 3, 12), 4], {}),
    "max_unpool2d": lambda rs: (_unpool_inputs(rs)[0] + [2, 2], {}),
    "affine_grid": lambda rs: ([_f(rs, 2, 2, 3), (2, 3, 5, 7)], {}),
    "grid_sample": lambda rs: ([_f(rs, 2, 3, 5, 6),
                                _f(rs, 2, 4, 3, 2, lo=-1.2, hi=1.2)], {}),
    "local_response_norm": lambda rs: ([_f(rs, 2, 7, 3, 3), 5],
                                       {"alpha": 1e-2, "beta": 0.75,
                                        "k": 1.5}),
    "sequence_mask": lambda rs: ([np.array([[1, 3], [2, 0]], np.int64)],
                                 {"maxlen": 4}),
    "bilinear": lambda rs: ([_f(rs, 3, 6), _f(rs, 3, 7), _f(rs, 5, 6, 7),
                             _f(rs, 5)], {}),
    "maxout": lambda rs: ([_f(rs, 2, 8, 3, 3), 2], {"axis": 1}),
    "thresholded_relu": lambda rs: ([_f(rs, 4, 6)], {"threshold": 0.5}),
    "square_error_cost": lambda rs: ([_f(rs, 4, 3), _f(rs, 4, 3)], {}),
    "log_loss": lambda rs: ([_f(rs, 4, 1, lo=0.05, hi=0.95),
                             (rs.rand(4, 1) > 0.5).astype(np.float32)], {}),
    "sigmoid_focal_loss": lambda rs: (
        [_f(rs, 4, 3), (rs.rand(4, 3) > 0.5).astype(np.float32)],
        {"normalizer": np.float32(3.0), "gamma": 1.5}),
    "dice_loss": lambda rs: ([_f(rs, 3, 4, 5, lo=0.01, hi=1.0),
                              rs.randint(0, 5, (3, 4, 1)).astype(np.int64)],
                             {}),
    "npair_loss": lambda rs: ([_f(rs, 6, 4), _f(rs, 6, 4),
                               np.array([0, 1, 0, 2, 1, 2], np.int64)], {}),
    "margin_cross_entropy": lambda rs: (
        [_f(rs, 5, 7, lo=-0.9, hi=0.9), rs.randint(0, 7, 5).astype(np.int64)],
        {"margin1": 1.0, "margin2": 0.3, "margin3": 0.1, "scale": 8.0}),
}
# pad: every mode and spec kind (partial innermost-first, full from dim 0)
PAD_CASES = (
    ([1, 2, 2, 1], "constant", 0.5), ([1, 2, 2, 1], "reflect", 0.0),
    ([1, 2, 2, 1], "replicate", 0.0), ([1, 2, 2, 1], "circular", 0.0),
    ([1, 1, 0, 2, 3, 0, 0, 1], "constant", 0.0), ([2, 1], "replicate", 0.0),
    (1, "constant", 0.0),
)
RANDOM = ("gumbel_softmax", "dropout2d", "alpha_dropout", "dropout3d",
          "rrelu")
RAISING = ("hsigmoid_loss",)


def _jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _torch(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def _np(out):
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    return np.asarray(out.detach() if torch.is_tensor(out) else out)


def test_every_jax_function_is_in_the_port():
    names = [n for n in vars(JF) if not n.startswith("_")
             and callable(getattr(JF, n)) and getattr(JF, n).__module__
             == JF.__name__]
    assert [n for n in names if not hasattr(TF, n)] == []
    assert set(CASES) | set(RANDOM) | set(RAISING) >= {
        "relu6", "softmax", "pad", "grid_sample", "fold", "npair_loss"}
    assert len(set(CASES) | set(RANDOM) | set(RAISING)) == 58


@pytest.mark.parametrize("name", tuple(CASES))
def test_function_matches_jax(name):
    rs = np.random.RandomState(sorted(CASES).index(name))
    args, kw = CASES[name](rs)
    want = _np(getattr(JF, name)(*map(_jax, args),
                                 **{k: _jax(v) for k, v in kw.items()}))
    targs = [_torch(a) for a in args]
    grad_in = next((a for a in targs if torch.is_tensor(a)
                    and a.is_floating_point()), None)
    if grad_in is not None:
        grad_in.requires_grad_(True)
    got = getattr(TF, name)(*targs, **{k: _torch(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(got), want, rtol=ATOL, atol=ATOL,
                               err_msg=name)
    if grad_in is None or not (torch.is_tensor(got) and
                               got.is_floating_point()):
        return
    w = np.asarray(np.random.RandomState(7).randn(*got.shape), np.float32)

    def jloss(first):
        jargs = [first] + [_jax(a) for a in args[1:]]
        out = getattr(JF, name)(*jargs, **{k: _jax(v) for k, v in
                                           kw.items()})
        return jnp.sum(out * w)
    first_idx = next(i for i, a in enumerate(args)
                     if isinstance(a, np.ndarray) and a.dtype == np.float32)
    assert first_idx == 0, name
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(args[0])))
    (tgrad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                   grad_in)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=GRAD_ATOL,
                               atol=GRAD_ATOL, err_msg=f"{name} grad")


@pytest.mark.parametrize("spec,mode,value", PAD_CASES)
def test_pad_specs_and_modes_match_jax(spec, mode, value):
    x = _f(np.random.RandomState(3), 2, 3, 5, 6)
    want = np.asarray(JF.pad(jnp.asarray(x), spec, mode=mode, value=value))
    got = TF.pad(torch.from_numpy(x), spec, mode=mode, value=value)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_channels_last_raises_as_jax():
    x = np.zeros((2, 3, 4, 5), np.float32)
    for fn, arr in ((JF.pad, jnp.asarray(x)), (TF.pad, torch.from_numpy(x))):
        with pytest.raises(NotImplementedError, match="channels-last"):
            fn(arr, [1, 1], data_format="NHWC")


@pytest.mark.parametrize("mode,align", (("bilinear", True),
                                        ("bilinear", False),
                                        ("nearest", True)))
@pytest.mark.parametrize("padding_mode", ("zeros", "border"))
def test_grid_sample_and_affine_grid_modes_match_jax(mode, align,
                                                     padding_mode):
    rs = np.random.RandomState(11)
    x = _f(rs, 2, 3, 5, 6)
    theta = _f(rs, 2, 2, 3) * 0.6
    jgrid = JF.affine_grid(jnp.asarray(theta), (2, 3, 4, 7),
                           align_corners=align)
    tgrid = TF.affine_grid(torch.from_numpy(theta), (2, 3, 4, 7),
                           align_corners=align)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), atol=ATOL)
    want = JF.grid_sample(jnp.asarray(x), jgrid, mode=mode,
                          padding_mode=padding_mode, align_corners=align)
    got = TF.grid_sample(torch.from_numpy(x), torch.from_numpy(
        np.asarray(jgrid)), mode=mode, padding_mode=padding_mode,
        align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_refusals_match_jax():
    for fn in (JF.hsigmoid_loss, TF.hsigmoid_loss):
        with pytest.raises(NotImplementedError, match="margin_cross_entropy"):
            fn()
    x = np.zeros((1, 1, 4, 4), np.float32)
    g = np.zeros((1, 2, 2, 2), np.float32)
    with pytest.raises(NotImplementedError, match="padding_mode"):
        JF.grid_sample(jnp.asarray(x), jnp.asarray(g),
                       padding_mode="reflection")
    with pytest.raises(NotImplementedError, match="padding_mode"):
        TF.grid_sample(torch.from_numpy(x), torch.from_numpy(g),
                       padding_mode="reflection")
    with pytest.raises(ValueError, match="divisible"):
        TF.adaptive_avg_pool1d(torch.zeros(1, 1, 10), 3)


def test_sequence_mask_default_maxlen_and_dtype_as_jax():
    lens = np.array([1, 3, 2], np.int64)
    want = np.asarray(JF.sequence_mask(jnp.asarray(lens)))
    got = TF.sequence_mask(torch.from_numpy(lens))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert TF.sequence_mask(torch.from_numpy(lens), 5,
                            dtype="bool").dtype == torch.bool


def test_one_hot_out_of_range_is_zeros_as_jax():
    idx = np.array([-1, 5, 2], np.int64)
    want = np.asarray(JF.one_hot(jnp.asarray(idx), 5))
    got = TF.one_hot(torch.from_numpy(idx), 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_padding_idx_as_jax():
    rs = np.random.RandomState(4)
    w = _f(rs, 6, 3)
    ids = np.array([[0, 2, 5], [2, 2, 1]], np.int64)
    want = np.asarray(JF.embedding(jnp.asarray(ids), jnp.asarray(w),
                                   padding_idx=2))
    got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                       padding_idx=2)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- random
def _gen(seed=0):
    return ptt.make_generator(seed, "cpu")


def test_random_functions_require_a_generator_in_training():
    x = torch.ones(2, 3, 4, 4)
    for fn in (TF.dropout2d, TF.dropout3d, TF.alpha_dropout, TF.rrelu):
        arg = x[..., None] if fn is TF.dropout3d else x
        with pytest.raises(ValueError, match="torch.Generator"):
            fn(arg, 0.5, True) if fn is not TF.rrelu else fn(arg)
        assert fn(arg, training=False) is not None
    with pytest.raises(ValueError, match="torch.Generator"):
        TF.gumbel_softmax(x)


@pytest.mark.parametrize("name,shape", (("dropout2d", (64, 64, 3, 3)),
                                        ("dropout3d", (64, 64, 2, 2, 2))))
def test_channel_dropouts_keep_whole_channels_at_the_jax_rate(name, shape):
    x = np.abs(_f(np.random.RandomState(0), *shape)) + 0.5
    p = 0.3
    jout = np.asarray(getattr(JF, name)(jnp.asarray(x), p, training=True,
                                        key=jax.random.key(0)))
    tout = getattr(TF, name)(torch.from_numpy(x), p, training=True,
                             generator=_gen(1)).numpy()
    for out in (jout, tout):
        chans = out.reshape(shape[0], shape[1], -1)
        dropped = (chans == 0).all(-1)
        kept = np.isclose(chans, x.reshape(chans.shape) / (1 - p),
                          rtol=1e-6).all(-1)
        assert (dropped | kept).all()
        assert abs(dropped.mean() - p) < 0.03
    again = getattr(TF, name)(torch.from_numpy(x), p, training=True,
                              generator=_gen(1)).numpy()
    np.testing.assert_array_equal(tout, again)
    for fn, arr in ((JF, jnp.asarray(x)), (TF, torch.from_numpy(x))):
        np.testing.assert_array_equal(
            np.asarray(getattr(fn, name)(arr, p, training=False)), x)


def test_alpha_dropout_keeps_selu_statistics_as_jax():
    x = _f(np.random.RandomState(2), 200, 200)
    p = 0.2
    alpha_p = -1.7580993408473766
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    jout = np.asarray(JF.alpha_dropout(jnp.asarray(x), p, training=True,
                                       key=jax.random.key(0)))
    tout = TF.alpha_dropout(torch.from_numpy(x), p, training=True,
                            generator=_gen(3)).numpy()
    for out in (jout, tout):
        dropped = np.isclose(out, a * alpha_p + b, atol=1e-6)
        np.testing.assert_allclose(out[~dropped], a * x[~dropped] + b,
                                   rtol=1e-5, atol=1e-6)
        assert abs(dropped.mean() - p) < 0.01
        assert abs(out.mean()) < 0.02 and abs(out.var() - 1.0) < 0.03
    np.testing.assert_array_equal(
        tout, TF.alpha_dropout(torch.from_numpy(x), p, training=True,
                               generator=_gen(3)).numpy())


def test_rrelu_slopes_in_range_and_eval_as_jax():
    x = _f(np.random.RandomState(5), 100, 100)
    lo, hi = 0.1, 0.3
    neg = x < 0
    jout = np.asarray(JF.rrelu(jnp.asarray(x), lo, hi, training=True,
                               key=jax.random.key(0)))
    tout = TF.rrelu(torch.from_numpy(x), lo, hi, training=True,
                    generator=_gen(4)).numpy()
    for out in (jout, tout):
        slope = out[neg] / x[neg]
        assert slope.min() >= lo - 1e-6 and slope.max() < hi + 1e-6
        assert abs(slope.mean() - (lo + hi) / 2) < 0.01
        np.testing.assert_array_equal(out[~neg], x[~neg])
    np.testing.assert_allclose(
        TF.rrelu(torch.from_numpy(x), lo, hi, training=False).numpy(),
        np.asarray(JF.rrelu(jnp.asarray(x), lo, hi, training=False)),
        rtol=1e-6)


@pytest.mark.parametrize("hard", (False, True))
def test_gumbel_softmax_samples_the_softmax_as_jax(hard):
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    x = np.tile(logits, (20000, 1))
    jout = np.asarray(JF.gumbel_softmax(jnp.asarray(x), 0.5, hard=hard,
                                        key=jax.random.key(0)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = TF.gumbel_softmax(tx, 0.5, hard=hard, generator=_gen(6))
    for out in (jout, tout.detach().numpy()):
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
        freq = np.bincount(out.argmax(-1), minlength=4) / len(out)
        np.testing.assert_allclose(freq, np.exp(logits), atol=0.015)
        if hard:   # (one_hot + y) - y: one-hot up to a rounding of y
            np.testing.assert_allclose(out, np.round(out), atol=1e-6)
            assert set(np.unique(np.round(out))) <= {0.0, 1.0}
    (g,) = torch.autograd.grad(tout[:, 0].sum(), tx)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# ------------------------------------------------------------------ layers
def _layer_cases():
    rs = np.random.RandomState(21)
    x4 = _f(rs, 2, 8, 6, 6)
    return {
        "Identity": ((), {}, [x4]),
        "Flatten": ((), {}, [x4]),
        "Upsample": ((), dict(scale_factor=2, mode="nearest"), [x4]),
        "UpsamplingBilinear2D": ((), dict(size=(9, 11)), [x4]),
        "PixelShuffle": ((2,), {}, [x4]),
        "PixelUnshuffle": ((2,), {}, [x4]),
        "ChannelShuffle": ((4,), {}, [x4]),
        "Pad2D": (([1, 2, 0, 1],), dict(mode="reflect"), [x4]),
        "Pad1D": (([2, 1],), dict(mode="replicate"), [_f(rs, 2, 3, 7)]),
        "ZeroPad2D": ((2,), {}, [x4]),
        "CosineSimilarity": ((), dict(axis=1), [x4, _f(rs, 2, 8, 6, 6)]),
        "PairwiseDistance": ((), dict(keepdim=True),
                             [_f(rs, 5, 4), _f(rs, 5, 4)]),
        "MaxPool1D": ((3, 2, 1), {}, [_f(rs, 2, 3, 12)]),
        "AvgPool1D": ((3, 2, 1), {}, [_f(rs, 2, 3, 12)]),
        "MaxPool3D": ((2,), {}, [_f(rs, 1, 2, 4, 6, 6)]),
        "AvgPool3D": ((3, 2, 1), {}, [_f(rs, 1, 2, 4, 6, 6)]),
        "AdaptiveAvgPool1D": ((3,), {}, [_f(rs, 2, 3, 12)]),
        "Fold": (((6, 6), 3), dict(paddings=1), [_f(rs, 2, 72, 36)]),
        "Unfold": ((3,), dict(paddings=1), [x4]),
        "LocalResponseNorm": ((3,), {}, [x4]),
        "Maxout": ((2,), {}, [x4]),
        "ThresholdedReLU": ((), dict(threshold=0.3), [x4]),
        "Bilinear": ((6, 7, 5), {}, [_f(rs, 3, 6), _f(rs, 3, 7)]),
        "MaxUnPool2D": ((2, 2), {}, _unpool_inputs(rs)[0]),
        "ReLU6": ((), {}, [x4 * 4]),
        "Swish": ((), {}, [x4]),
        "Mish": ((), {}, [x4]),
        "LogSigmoid": ((), {}, [x4]),
        "Tanhshrink": ((), {}, [x4]),
        "Hardswish": ((), {}, [x4 * 3]),
        "Hardsigmoid": ((), {}, [x4 * 3]),
        "Hardtanh": ((), {}, [x4 * 2]),
        "Hardshrink": ((), dict(threshold=0.4), [x4]),
        "Softshrink": ((), dict(threshold=0.4), [x4]),
        "Softplus": ((), dict(beta=2.0, threshold=5.0), [x4 * 3]),
        "Softsign": ((), {}, [x4]),
        "ELU": ((), dict(alpha=0.5), [x4]),
        "SELU": ((), {}, [x4]),
        "CELU": ((), dict(alpha=2.0), [x4]),
        "LeakyReLU": ((), dict(negative_slope=0.1), [x4]),
        "Softmax": ((), dict(axis=1), [x4]),
        "LogSoftmax": ((), dict(axis=-1), [x4]),
        "GLU": ((), dict(axis=1), [x4]),
        "PReLU": ((8,), dict(init=0.1), [x4]),
    }


LAYERS = tuple(_layer_cases())
RANDOM_LAYERS = ("Dropout2D", "Dropout3D", "AlphaDropout", "RReLU")


def test_every_jax_layer_is_in_the_port():
    import paddle_tpu.nn.activation as ja
    import paddle_tpu.nn.common as jc
    import paddle_tpu.nn.container as jk
    names = []
    for mod in (jc, ja, jk):
        names += [n for n, v in vars(mod).items() if isinstance(v, type)
                  and issubclass(v, jnn.Layer) and not n.startswith("_")
                  and v.__module__ == mod.__name__]
    assert [n for n in names if not hasattr(tnn, n)] == []
    new = set(LAYERS) | set(RANDOM_LAYERS) | {"LayerDict", "ParameterList"}
    assert len(new) == 50 and new <= set(names)


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name):
    args, kw, inputs = _layer_cases()[name]
    pt.seed(1)
    jl = getattr(jnn, name)(*args, **kw)
    extra = dict(device="cpu") if name in ("Bilinear", "PReLU") else {}
    tl = getattr(tnn, name)(*args, **kw, **extra)
    assert isinstance(tl, tnn.Layer) and isinstance(tl, torch.nn.Module)
    state = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    assert set(state) == set(tl.state_dict())
    ptt.load_jax_state_dict(tl, state)
    want = _np(jl(*map(_jax, inputs)))
    got = _np(tl(*map(_torch, inputs)))
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("name,shape", (("Dropout2D", (32, 32, 3, 3)),
                                        ("Dropout3D", (32, 32, 2, 2, 2)),
                                        ("AlphaDropout", (64, 64)),
                                        ("RReLU", (64, 64))))
def test_random_layers_as_jax_and_reproducible_under_seed(name, shape):
    x = torch.from_numpy(_f(np.random.RandomState(8), *shape))
    ptt.seed(5)
    a = getattr(tnn, name)()
    ptt.seed(5)
    b = getattr(tnn, name)()
    c = getattr(tnn, name)()
    out_a, out_b, out_c = a(x), b(x), c(x)
    np.testing.assert_array_equal(out_a.numpy(), out_b.numpy())
    assert not torch.equal(out_a, out_c)
    assert not torch.equal(out_a, x)
    # eval: the JAX layer's eval output
    jl = getattr(jnn, name)()
    jl.eval()
    a.eval()
    np.testing.assert_allclose(a(x).numpy(), np.asarray(jl(jnp.asarray(
        x.numpy()))), rtol=1e-6)
    # an explicit generator wins, and a generator context over both
    g1 = getattr(tnn, name)(generator=_gen(9))
    g2 = getattr(tnn, name)(generator=_gen(9))
    np.testing.assert_array_equal(g1(x).numpy(), g2(x).numpy())
    from paddle_tpu_torch.utils import rng
    with rng.generator_context(_gen(10)):
        in_a = a.train()(x)
    with rng.generator_context(_gen(10)):
        in_c = c(x)
    np.testing.assert_array_equal(in_a.numpy(), in_c.numpy())


def test_dropout_layer_draws_from_the_ambient_stream_without_a_generator():
    """The JAX ``Dropout`` draws ``next_key()``; the port's, built with no
    generator, takes its seed from the ambient stream (it raised before)."""
    x = torch.ones(1000)
    ptt.seed(3)
    d1 = tnn.Dropout(0.5)
    ptt.seed(3)
    d2 = tnn.Dropout(0.5)
    o1, o2 = d1(x), d2(x)
    np.testing.assert_array_equal(o1.numpy(), o2.numpy())
    assert abs(float((o1 == 0).float().mean()) - 0.5) < 0.06
    assert set(np.unique(o1.numpy())) == {0.0, 2.0}


def test_containers_as_jax():
    pt.seed(0)
    jd = jnn.LayerDict({"a": jnn.Linear(3, 4), "b": jnn.ReLU()})
    td = tnn.LayerDict({"a": tnn.Linear(3, 4, device="cpu"),
                        "b": tnn.ReLU()})
    assert list(jd.keys()) == list(td.keys()) and "a" in td and len(td) == 2
    assert set(jd.state_dict()) == set(td.state_dict())
    rs = np.random.RandomState(0)
    vals = [_f(rs, 3), _f(rs, 2, 2)]
    jp = jnn.ParameterList([jnn.Parameter(v) for v in vals])
    tp = tnn.ParameterList([tnn.Parameter(v) for v in vals])
    tp.append(torch.zeros(4))
    jp.append(np.zeros(4, np.float32))
    assert list(jp.state_dict()) == list(tp.state_dict()) == ["0", "1", "2"]
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
        assert t.requires_grad
    seq = tnn.Sequential([("fc", tnn.Linear(3, 2, device="cpu")),
                          ("act", tnn.ReLU())])
    jseq = jnn.Sequential([("fc", jnn.Linear(3, 2)), ("act", jnn.ReLU())])
    assert list(seq.state_dict()) == list(jseq.state_dict())
    assert isinstance(seq, tnn.Layer) and isinstance(td, tnn.Layer)


def test_every_nn_layer_is_a_layer():
    assert isinstance(tnn.Linear(2, 3, device="cpu"), tnn.Layer)
    for cls in (tnn.LayerNorm, tnn.RMSNorm, tnn.BatchNorm2D, tnn.Conv2D,
                tnn.MaxPool2D, tnn.CrossEntropyLoss, tnn.MultiHeadAttention,
                tnn.TransformerEncoderLayer, tnn.LayerList, tnn.Sequential,
                tnn.Embedding, tnn.Dropout, tnn.GELU):
        assert issubclass(cls, tnn.Layer), cls
