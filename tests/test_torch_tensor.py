"""The port's tensor API (``paddle_tpu_torch/tensor.py``), ``dtypes`` and
the top-level names, held to the JAX package on the CPU.

Every function of ``paddle_tpu/tensor.py`` is one case of
``test_function_matches_jax``: the same numpy inputs (from a seed) go
through the JAX function and the port's, and the results agree in shape,
in dtype through the 64-bit rule's narrowing map (int64 -> int32,
float64 -> float32, complex128 -> complex64: the JAX package runs with
x64 off, the port keeps the dtype the caller names) and in value within
``RTOL`` / ``ATOL`` (float32 math; the transcendental functions within
``RTOL_SPECIAL``). The random functions are held by shape, dtype, support
and moments (``test_random_function``), since JAX's threefry and torch's
Philox give different draws. The cases where Paddle's names, as JAX
implements them, differ from torch's each have a test of their own.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.dtypes as JD
import paddle_tpu.tensor as J
import paddle_tpu_torch as ptt
import paddle_tpu_torch.dtypes as PD
import paddle_tpu_torch.tensor as P
from tensor_cases import (ATOL, F32, RTOL, T, TENSOR_CASES, six, v, x, y)

CASES = TENSOR_CASES
NARROW = {np.dtype("int64"): np.dtype("int32"),
          np.dtype("float64"): np.dtype("float32"),
          np.dtype("complex128"): np.dtype("complex64")}


def _jax_arg(a):
    if isinstance(a, T):
        return jnp.asarray(a.a)
    if isinstance(a, list) and any(isinstance(e, T) for e in a):
        return [_jax_arg(e) for e in a]
    if isinstance(a, tuple) and any(isinstance(e, T) for e in a):
        return tuple(_jax_arg(e) for e in a)
    return a


def _port_arg(a):
    if isinstance(a, T):
        return torch.from_numpy(a.a.copy())
    if isinstance(a, list) and any(isinstance(e, T) for e in a):
        return [_port_arg(e) for e in a]
    if isinstance(a, tuple) and any(isinstance(e, T) for e in a):
        return tuple(_port_arg(e) for e in a)
    return a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(j, p, rtol=RTOL, atol=ATOL):
    """JAX result ``j`` against the port's ``p``: same structure, shape,
    dtype (narrowed) and values within the tolerance (NaNs equal)."""
    if isinstance(j, (tuple, list)):
        assert isinstance(p, (tuple, list)) and len(j) == len(p), (j, p)
        for a, b in zip(j, p):
            assert_same(a, b, rtol, atol)
        return
    if isinstance(j, (int, float, bool)) and not isinstance(p, torch.Tensor):
        assert j == p
        return
    a, b = _np(j), _np(p)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert NARROW.get(b.dtype, b.dtype) == a.dtype, (a.dtype, b.dtype)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b.astype(a.dtype), a, rtol=rtol,
                                   atol=atol, equal_nan=True)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_jax(case):
    _, name, args, kw, port_kw, rtol = case
    want = getattr(J, name)(*[_jax_arg(a) for a in args],
                            **{k: _jax_arg(a) for k, a in kw.items()})
    got = getattr(P, name)(*[_port_arg(a) for a in args],
                           **{k: _port_arg(a) for k, a in kw.items()},
                           **port_kw)
    assert_same(want, got, rtol=rtol, atol=ATOL if rtol else 0.0)


def test_every_jax_function_has_a_case_or_its_own_test():
    """Each public function of the JAX tensor module is a case above, a
    random function below, or has a test of its own in this file."""
    own = {"split", "chunk", "gather", "take", "median", "scatter",
           "rand", "randn", "standard_normal", "randint", "randperm",
           "normal", "uniform", "bernoulli", "multinomial", "poisson"}
    names = {n for n in dir(J) if not n.startswith("_")
             and callable(getattr(J, n))
             and not isinstance(getattr(J, n), types.ModuleType)
             and getattr(getattr(J, n), "__module__", "") == J.__name__}
    covered = {c[1] for c in CASES} | own
    assert names - covered == set()


# ---------------------------------------------- where Paddle differs from torch
def test_split_int_makes_equal_sections_as_jnp_split():
    a = np.arange(12, dtype=F32).reshape(6, 2)
    assert_same(J.split(jnp.asarray(a), 3), P.split(torch.from_numpy(a), 3))
    assert_same(J.split(jnp.asarray(a), [2, -1]),
                P.split(torch.from_numpy(a), [2, -1]))
    with pytest.raises(ValueError):
        J.split(jnp.asarray(a), 4)
    with pytest.raises(ValueError):
        P.split(torch.from_numpy(a), 4)


def test_chunk_is_array_split_2_2_1_1():
    want = J.chunk(jnp.asarray(six), 4)
    got = P.chunk(torch.from_numpy(six), 4)
    assert [c.shape[0] for c in got] == [2, 2, 1, 1]
    assert_same(want, got)
    assert len(torch.chunk(torch.from_numpy(six), 4)) == 3


def test_gather_out_of_range_fills_and_negatives_wrap_once():
    a = np.arange(5, dtype=F32)
    i = np.array([-1, 5, 7, -6, 2])
    got = P.gather(torch.from_numpy(a), torch.from_numpy(i))
    assert_same(J.gather(jnp.asarray(a), jnp.asarray(i)), got)
    np.testing.assert_array_equal(got.numpy()[[0, 4]], [4., 2.])
    assert np.isnan(got.numpy()[1:4]).all()
    ai = np.arange(5, dtype=np.int32)
    assert_same(J.index_select(jnp.asarray(ai), jnp.asarray(i)),
                P.index_select(torch.from_numpy(ai), torch.from_numpy(i)))


def test_take_and_gather_nd_clamp_as_jax_indexing():
    i = np.array([-1, 20, 3, -30])
    assert_same(J.take(jnp.asarray(x), jnp.asarray(i)),
                P.take(torch.from_numpy(x), torch.from_numpy(i)))
    nd = np.array([[9, 9], [-1, -1], [-9, 0]])
    assert_same(J.gather_nd(jnp.asarray(x), jnp.asarray(nd)),
                P.gather_nd(torch.from_numpy(x), torch.from_numpy(nd)))


def test_median_of_an_even_count_averages_the_middle_two():
    a = np.array([1., 2., 3., 4.], F32)
    got = P.median(torch.from_numpy(a))
    assert float(got) == 2.5
    assert_same(J.median(jnp.asarray(a)), got)
    assert float(torch.median(torch.from_numpy(a))) == 2.0
    assert_same(J.median(jnp.asarray(x)), P.median(torch.from_numpy(x)))


def test_unique_returns_first_occurrence_indices():
    a = np.array([3, 1, 3, 2, 1, 1, 0])
    want = J.unique(jnp.asarray(a), return_index=True)
    got = P.unique(torch.from_numpy(a), return_index=True)
    assert_same(want, got)
    assert got[1].tolist() == [6, 1, 3, 0]


def test_scatter_add_mode_adds_to_x():
    rows = np.array([2, 0])
    want = J.scatter(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(y[:2]),
                     overwrite=False)
    got = P.scatter(torch.from_numpy(x), torch.from_numpy(rows),
                    torch.from_numpy(y[:2]), overwrite=False)
    assert_same(want, got)
    np.testing.assert_allclose(got.numpy()[2], x[2] + y[0], rtol=1e-6)


def test_histogram_bins_values_on_the_edges_as_jnp():
    a = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.0, -0.1, 1.1], F32)
    for kw in (dict(bins=4, min=0, max=1), dict(bins=4),
               dict(bins=2, min=0, max=1, weight=np.arange(8, dtype=F32)),
               dict(bins=4, min=0, max=1, density=True)):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        want = J.histogram(jnp.asarray(a), **jkw)
        assert_same(want, P.histogram(torch.from_numpy(a), **pkw))
    assert P.histogram(torch.from_numpy(a), 4, 0, 1).tolist() == \
        [1., 1., 1., 3.]


def test_multinomial_without_replacement_refuses_more_than_the_support():
    probs = np.array([[0.5, 0.5, 0.0, 0.0], [0.2, 0.3, 0.5, 0.0]], F32)
    with pytest.raises(ValueError, match="exceeds the 2 categories"):
        J.multinomial(jnp.asarray(probs), 3)
    with pytest.raises(ValueError, match="exceeds the 2 categories"):
        P.multinomial(torch.from_numpy(probs), 3,
                      generator=torch.Generator().manual_seed(0))
    got = P.multinomial(torch.from_numpy(probs), 2,
                        generator=torch.Generator().manual_seed(0))
    assert got.shape == (2, 2)
    assert sorted(got[0].tolist()) == [0, 1]
    assert set(got[1].tolist()) <= {0, 1, 2} and len(set(got[1].tolist())) == 2


def test_view_rescales_the_last_dim_and_refuses_a_ragged_one():
    odd = np.ones((2, 3), np.float16)
    with pytest.raises(ValueError):
        J.view(jnp.asarray(odd), "float32")
    with pytest.raises(ValueError):
        P.view(torch.from_numpy(odd), "float32")


def test_flatten_of_a_0d_tensor_and_expand_refusing_a_new_minus_one():
    assert_same(J.flatten(jnp.asarray(F32(3))),
                P.flatten(torch.tensor(3.0)))
    with pytest.raises(ValueError):
        J.expand(jnp.asarray(v), [-1, 4])
    with pytest.raises(ValueError):
        P.expand(torch.from_numpy(v), [-1, 4])


def test_no_function_writes_into_its_inputs():
    t = torch.from_numpy(x.copy())
    keep = t.clone()
    rows = torch.tensor([2, 0])
    P.scatter(t, rows, torch.zeros(2, 4))
    P.scatter(t, rows, torch.ones(2, 4), overwrite=False)
    P.index_put(t, (rows, rows), torch.tensor(5.0), accumulate=True)
    P.put_along_axis(t, torch.zeros(3, 1, dtype=torch.long), 1.0, 1)
    P.index_add(t, rows, 0, torch.ones(2, 4))
    P.index_fill(t, rows, 0, 0.0)
    P.masked_fill(t, t > 0, 0.0)
    P.masked_scatter(t, t > 0, torch.zeros(12))
    P.as_strided(t, [2, 2], [1, 1])
    assert torch.equal(t, keep)


def test_numpy_reads_a_tensor_that_requires_grad():
    t = torch.from_numpy(x.copy()).requires_grad_()
    np.testing.assert_array_equal(P.numpy(t * 1), x)
    assert P.numpy(t.to(torch.bfloat16)).dtype == np.float32


def test_creation_without_a_device_lands_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert P.zeros([2]).device.type == "cuda"
    else:
        for fn in (lambda: P.zeros([2]), lambda: P.arange(3),
                   lambda: P.rand([2]), lambda: P.to_tensor([1.0])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
    # a tensor stays where it is; other functions follow their inputs
    t = torch.ones(2)
    assert P.to_tensor(t).device == t.device
    assert P.exp(t).device == t.device


# ------------------------------------------------------------------ random
def _g(seed=0):
    return torch.Generator().manual_seed(seed)


N = 20000
RANDOM = (
    ("rand", lambda: P.rand([N], generator=_g(1)),
     lambda a: a.min() >= 0 and a.max() < 1 and abs(a.mean() - 0.5) < 0.01),
    ("randn", lambda: P.randn([N], generator=_g(2)),
     lambda a: abs(a.mean()) < 0.03 and abs(a.std() - 1) < 0.03),
    ("standard_normal", lambda: P.standard_normal([N], generator=_g(3)),
     lambda a: abs(a.mean()) < 0.03 and abs(a.std() - 1) < 0.03),
    ("randint", lambda: P.randint(2, 7, [N], generator=_g(4)),
     lambda a: a.min() == 2 and a.max() == 6
     and abs(a.mean() - 4) < 0.05),
    ("randperm", lambda: P.randperm(50, generator=_g(5)),
     lambda a: sorted(a.tolist()) == list(range(50))),
    ("normal", lambda: P.normal(2.0, 3.0, [N], generator=_g(6)),
     lambda a: abs(a.mean() - 2) < 0.1 and abs(a.std() - 3) < 0.1),
    ("uniform", lambda: P.uniform([N], min=-2.0, max=4.0, generator=_g(7)),
     lambda a: a.min() >= -2 and a.max() < 4 and abs(a.mean() - 1) < 0.06),
    ("bernoulli", lambda: P.bernoulli(torch.full([N], 0.3),
                                      generator=_g(8)),
     lambda a: set(np.unique(a).tolist()) <= {0.0, 1.0}
     and abs(a.mean() - 0.3) < 0.015),
    ("multinomial-replacement", lambda: P.multinomial(
        torch.tensor([[1., 0., 3.]]), N, replacement=True, generator=_g(9)),
     lambda a: a.shape == (1, N) and set(np.unique(a).tolist()) == {0, 2}
     and abs((a == 2).mean() - 0.75) < 0.015),
    ("multinomial", lambda: P.multinomial(torch.tensor([1., 1., 2., 0.]), 3,
                                          generator=_g(10)),
     lambda a: sorted(a.tolist()) == [0, 1, 2]),
    ("poisson", lambda: P.poisson(torch.full([N], 4.0), generator=_g(11)),
     lambda a: a.dtype == np.float32 and a.min() >= 0
     and np.all(a == np.floor(a)) and abs(a.mean() - 4) < 0.08),
)

JAX_RANDOM = {
    "rand": lambda: J.rand([8]), "randn": lambda: J.randn([8]),
    "standard_normal": lambda: J.standard_normal([8]),
    "randint": lambda: J.randint(2, 7, [8]),
    "randperm": lambda: J.randperm(8), "normal": lambda: J.normal(shape=[8]),
    "uniform": lambda: J.uniform([8]),
    "bernoulli": lambda: J.bernoulli(jnp.full([8], 0.3)),
    "multinomial-replacement": lambda: J.multinomial(
        jnp.asarray([[1., 0., 3.]]), 8, replacement=True),
    "multinomial": lambda: J.multinomial(jnp.asarray([1., 1., 2., 0.]), 3),
    "poisson": lambda: J.poisson(jnp.full([8], 4.0)),
}


@pytest.mark.parametrize("case", RANDOM, ids=[c[0] for c in RANDOM])
def test_random_function(case):
    """Held by dtype (the JAX function's, through the narrowing map),
    support and moments over a large draw (the bounds are > 4 standard
    errors), and reproducible from its generator."""
    name, draw, ok = case
    got = draw()
    want = JAX_RANDOM[name]()
    assert NARROW.get(_np(got).dtype, _np(got).dtype) == np.asarray(want).dtype
    assert ok(_np(got))
    assert torch.equal(draw(), got)


def test_random_draws_from_the_ambient_stream_without_a_generator():
    ptt.seed(5)
    a = P.randn([4], device="cpu")
    b = P.randn([4], device="cpu")
    ptt.seed(5)
    assert torch.equal(P.randn([4], device="cpu"), a)
    assert not torch.equal(a, b)


# ---------------------------------------------------- dtypes and top level
def test_dtypes_names_and_to_dtype():
    for name in ("float16", "bfloat16", "float32", "float64", "int8",
                 "int16", "int32", "int64", "uint8", "bool_", "complex64"):
        assert np.dtype(getattr(JD, name)).itemsize == \
            torch.empty((), dtype=getattr(PD, name)).element_size()
    for alias, want in JD._DTYPE_ALIASES.items():
        got = PD.to_dtype(alias)
        assert torch.empty((), dtype=got).element_size() == \
            np.dtype(want).itemsize, alias
    assert PD.to_dtype(np.float32) is torch.float32
    assert PD.to_dtype(None) is None
    with pytest.raises(ValueError):
        PD.to_dtype("float8")
    assert PD.default_float() is torch.float32
    from paddle_tpu_torch import amp
    assert amp.to_dtype is PD.to_dtype


def test_the_64bit_rule_differs_in_dtype_only():
    """The JAX package (x64 off) gives int32 where the port keeps Paddle's
    and torch's int64; the values are equal."""
    pairs = ((J.to_tensor([1, 2]), P.to_tensor([1, 2], device="cpu")),
             (J.arange(3), P.arange(3, device="cpu")))
    for want, got in pairs:
        assert np.asarray(want).dtype == np.int32
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(J.randint(0, 5, (2,))).dtype == np.int32
    assert P.randint(0, 5, (2,), device="cpu").dtype == torch.int64
    assert P.zeros([2], "int64", device="cpu").dtype == torch.int64


def test_default_dtype_is_float32_and_setting_it_changes_nothing():
    assert pt.get_default_dtype() == jnp.float32
    assert ptt.get_default_dtype() is torch.float32
    assert ptt.set_default_dtype("float64") is torch.float64
    assert ptt.get_default_dtype() is torch.float32
    assert P.zeros([1], device="cpu").dtype == torch.float32


def test_the_port_exports_every_top_level_name_of_the_jax_package():
    """Apart from ``jit`` and ``static`` (A5) and ``is_compiled_with_xpu``
    (JAX-only), and the modules the JAX files import by accident
    (``jnp``, ``np``, ...)."""
    skip = {"jit", "static", "is_compiled_with_xpu", "annotations"}
    names = {n for n in dir(pt) if not n.startswith("_")
             and not (isinstance(getattr(pt, n), types.ModuleType)
                      and not getattr(pt, n).__name__.startswith(
                          "paddle_tpu."))} - skip
    assert sorted(n for n in names if not hasattr(ptt, n)) == []
    for sub in ("autograd", "linalg", "fft", "signal", "sparse",
                "distribution", "audio", "dtypes", "serving"):
        assert isinstance(getattr(ptt, sub), types.ModuleType)
    assert ptt.Tensor is torch.Tensor
    assert ptt.no_grad is ptt.autograd.no_grad


@pytest.mark.parametrize("mod", ("tensor", "dtypes", "autograd", "linalg",
                                 "fft", "signal", "audio", "sparse",
                                 "distribution"))
def test_every_public_name_of_the_jax_module_is_in_the_port(mod):
    import importlib
    jm = importlib.import_module(f"paddle_tpu.{mod}")
    tm = importlib.import_module(f"paddle_tpu_torch.{mod}")
    names = {n for n in dir(jm) if not n.startswith("_")
             and not isinstance(getattr(jm, n), types.ModuleType)
             and n not in ("annotations", "Any", "Callable", "Optional",
                           "Sequence", "Union")}
    assert sorted(n for n in names if not hasattr(tm, n)) == []
