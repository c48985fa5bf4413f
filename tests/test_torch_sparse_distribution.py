"""The port's ``sparse`` and ``distribution`` held to the JAX package on
the CPU (inputs from a seed with numpy).

Sparse results are compared densified, with the stored-entry count
(``nnz``, duplicates included until ``coalesce``, as BCOO's ``nse``) and
the format (an op on CSR gives CSR). Distributions: ``log_prob``,
``prob``, ``entropy``, ``mean``, ``variance``, ``cdf`` and the registered
KLs against the JAX formulas within ``RTOL`` (fp32; ``lgamma`` and
``digamma`` within ``RTOL_SPECIAL``). Samples match in distribution only
(JAX keys against torch generators): each family's draws are held by
shape, dtype, support and moments over ``N`` draws, with bounds of more
than four standard errors.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.distribution as JD
import paddle_tpu.sparse as JS
import paddle_tpu_torch.distribution as PD
import paddle_tpu_torch.sparse as PS
from tensor_cases import (CONC, IDX, IDX2, KL_PAIRS, LOC, SCALE, SPARSE_OPS,
                          TRIL, VAL, VAL2, coo, csr, dists)

RTOL, ATOL = 1e-5, 1e-6
RTOL_SPECIAL = 5e-5
N = 40000
J, Tt = jnp.asarray, torch.from_numpy


def same(j, p, rtol=RTOL, atol=ATOL):
    a = np.asarray(j)
    b = p.detach().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# ------------------------------------------------------------------- sparse
def _coo(mod, idx=IDX, val=VAL, shape=None):
    return coo(mod, J if mod is JS else Tt, idx, val, shape)


def _csr(mod):
    return csr(mod, J if mod is JS else Tt)


def same_sparse(j, p):
    assert type(j).__name__ == type(p).__name__
    assert j.shape == p.shape and j.nnz == p.nnz
    same(j.to_dense(), p.to_dense())


def test_coo_keeps_duplicates_until_coalesce_and_infers_its_shape():
    j, p = _coo(JS), _coo(PS)
    assert p.shape == j.shape == (3, 4)
    assert p.nnz == j.nnz == 5
    np.testing.assert_array_equal(p.indices.numpy(), np.asarray(j.indices))
    same(j.values, p.values)
    same(j.to_dense(), p.to_dense())
    same(j.dense, p.dense)
    np.testing.assert_allclose(p.numpy(), j.numpy(), rtol=RTOL)
    jc, pc = j.coalesce(), JS.coalesce(j)
    assert PS.coalesce(p).nnz == pc.nnz == jc.nnz == 4
    same_sparse(jc, p.coalesce())
    assert "nnz=5" in repr(p)


def test_csr_and_conversions():
    j, p = _csr(JS), _csr(PS)
    same_sparse(j, p)
    for a, b in ((j.crows, p.crows), (j.cols, p.cols)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    same(j.values, p.values)
    same_sparse(j.to_sparse_coo(), p.to_sparse_coo())
    same_sparse(_coo(JS).to_sparse_csr(), _coo(PS).to_sparse_csr())


def _both(fn):
    return fn(JS, J), fn(PS, Tt)


def _dists(m, c):
    return dists(m, c)


@pytest.mark.parametrize("case", SPARSE_OPS, ids=[c[0] for c in SPARSE_OPS])
def test_sparse_op_matches_jax(case):
    want, got = _both(case[1])
    if isinstance(want, (JS.SparseCooTensor, JS.SparseCsrTensor)):
        same_sparse(want, got)
        assert got.dtype == {np.dtype("float16"): torch.float16}.get(
            np.dtype(want.dtype), torch.float32)
    else:
        same(want, got, atol=1e-5)


def test_add_refuses_a_shape_mismatch_and_is_same_shape():
    for m, c in ((JS, J), (PS, Tt)):
        a, b = _coo(m), _coo(m, IDX2, VAL2, (3, 5))
        assert not m.is_same_shape(a, b)
        assert m.is_same_shape(a, _coo(m))
        with pytest.raises(ValueError):
            m.add(a, b)


def test_every_sparse_name_is_held():
    held = {c[0].split("-")[0] for c in SPARSE_OPS} | {
        "SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
        "sparse_csr_tensor", "is_same_shape"}
    assert set(JS.__all__) - held == set()


# ------------------------------------------------------------- distribution
DIST_NAMES = tuple(d[0] for d in _dists(PD, Tt))
METHODS = ("log_prob", "prob", "entropy", "mean", "variance", "cdf")


@pytest.mark.parametrize("name", DIST_NAMES)
def test_distribution_formulas_match_jax(name):
    jd, jv = next((d, v) for n, d, v in _dists(JD, J) if n == name)
    pd, pv = next((d, v) for n, d, v in _dists(PD, Tt) if n == name)
    checked = 0
    for meth in METHODS:
        try:
            want = getattr(jd, meth)
            want = want(jv) if meth in ("log_prob", "prob", "cdf") else \
                (want() if meth == "entropy" else want)
        except (NotImplementedError, AttributeError):
            with pytest.raises((NotImplementedError, AttributeError)):
                got = getattr(pd, meth)
                got(pv) if meth in ("log_prob", "prob", "cdf") else \
                    (got() if meth == "entropy" else got)
            continue
        got = getattr(pd, meth)
        got = got(pv) if meth in ("log_prob", "prob", "cdf") else \
            (got() if meth == "entropy" else got)
        same(want, got, rtol=RTOL_SPECIAL, atol=1e-5)
        checked += 1
    assert checked >= 1


@pytest.mark.parametrize("case", KL_PAIRS, ids=[k[0] for k in KL_PAIRS])
def test_registered_kl_matches_jax(case):
    same(JD.kl_divergence(*case[1](JD, J)),
         PD.kl_divergence(*case[1](PD, Tt)), rtol=RTOL_SPECIAL, atol=1e-5)


def test_kl_registry():
    with pytest.raises(NotImplementedError):
        PD.kl_divergence(PD.Normal(Tt(LOC), Tt(SCALE)),
                         PD.Laplace(Tt(LOC), Tt(SCALE)))

    @PD.register_kl(PD.Laplace, PD.Laplace)
    def _kl(p, q):
        return torch.zeros(())
    assert float(PD.kl_divergence(PD.Laplace(Tt(LOC), Tt(SCALE)),
                                  PD.Laplace(Tt(LOC), Tt(SCALE)))) == 0.0
    PD._KL_REGISTRY.pop((PD.Laplace, PD.Laplace))


def test_transforms_match_jax():
    r = np.random.RandomState(1)
    x = r.randn(4).astype(np.float32)
    y = (r.rand(4) * 0.8 + 0.1).astype(np.float32)
    pairs = ((JD.AffineTransform(J(LOC[:1]), J(SCALE[:1])),
              PD.AffineTransform(Tt(LOC[:1]), Tt(SCALE[:1]))),
             (JD.AbsTransform(), PD.AbsTransform()),
             (JD.ExpTransform(), PD.ExpTransform()),
             (JD.SigmoidTransform(), PD.SigmoidTransform()))
    for jt, pt_ in pairs:
        same(jt(J(x)), pt_(Tt(x)))
        same(jt.forward_log_det_jacobian(J(x)),
             pt_.forward_log_det_jacobian(Tt(x)))
        same(jt.inverse(J(y)), pt_.inverse(Tt(y)))
        same(jt.inverse_log_det_jacobian(J(y)),
             pt_.inverse_log_det_jacobian(Tt(y)), atol=1e-5)
    with pytest.raises(NotImplementedError):
        PD.Transform().forward(Tt(x))


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _moments(name):
    """(distribution, its mean, its variance, support check) for the
    sampling test, from the formulas (never from a sample)."""
    t = lambda a: torch.tensor(a, dtype=torch.float32)   # noqa: E731
    return {
        "Normal": (PD.Normal(t(1.5), t(2.0)), 1.5, 4.0, None),
        "LogNormal": (PD.LogNormal(t(0.0), t(0.5)), math.exp(0.125),
                      (math.exp(0.25) - 1) * math.exp(0.25), "positive"),
        "Uniform": (PD.Uniform(t(-1.0), t(3.0)), 1.0, 16 / 12, "uniform"),
        "Bernoulli": (PD.Bernoulli(t(0.3)), 0.3, 0.21, "binary"),
        "Beta": (PD.Beta(t(2.0), t(3.0)), 0.4, 6 / (25 * 6), "unit"),
        "Gamma": (PD.Gamma(t(3.0), t(2.0)), 1.5, 0.75, "positive"),
        "Exponential": (PD.Exponential(t(2.0)), 0.5, 0.25, "positive"),
        "Laplace": (PD.Laplace(t(1.0), t(0.5)), 1.0, 0.5, None),
        "Gumbel": (PD.Gumbel(t(1.0), t(2.0)), 1.0 + 2 * 0.5772156649015329,
                   math.pi ** 2 / 6 * 4, None),
        "Geometric": (PD.Geometric(t(0.4)), 1.5, 0.6 / 0.16, "counts"),
        "Poisson": (PD.Poisson(t(3.5)), 3.5, 3.5, "counts"),
        "Binomial": (PD.Binomial(t(10.0), t(0.3)), 3.0, 2.1, "counts"),
        "Chi2": (PD.Chi2(t(4.0)), 4.0, 8.0, "positive"),
        "StudentT": (PD.StudentT(t(6.0), t(1.0), t(2.0)), 1.0,
                     4 * 6 / 4, None),
        "ContinuousBernoulli": (PD.ContinuousBernoulli(t(0.5)), 0.5,
                                1 / 12, "unit"),
    }[name]


SAMPLED = ("Normal", "LogNormal", "Uniform", "Bernoulli", "Beta", "Gamma",
           "Exponential", "Laplace", "Gumbel", "Geometric", "Poisson",
           "Binomial", "Chi2", "StudentT", "ContinuousBernoulli")


@pytest.mark.parametrize("name", SAMPLED)
def test_samples_match_in_distribution(name):
    d, mean, var, support = _moments(name)
    a = d.sample((N,), generator=_g(3)).double()
    assert a.shape == (N,) and a.dtype == torch.float64
    assert torch.equal(d.sample((N,), generator=_g(3)).double(), a)
    se = math.sqrt(var / N)
    assert abs(float(a.mean()) - mean) < 5 * se, (float(a.mean()), mean)
    if name != "StudentT":      # heavy tails: the variance's error is wide
        assert abs(float(a.var()) / var - 1) < 0.06
    if support == "positive":
        assert float(a.min()) > 0
    elif support in ("unit", "uniform"):
        lo, hi = (0.0, 1.0) if support == "unit" else (-1.0, 3.0)
        assert float(a.min()) >= lo and float(a.max()) <= hi
    elif support == "binary":
        assert set(a.unique().tolist()) == {0.0, 1.0}
    elif support == "counts":
        assert float(a.min()) >= 0 and torch.equal(a, a.floor())


def test_sample_shapes_follow_jax():
    for n, jd, _ in _dists(JD, J):
        pd = next(d for m, d, _ in _dists(PD, Tt) if m == n)
        if n in ("Uniform",):
            continue
        want = jd.sample((5,), key=jax.random.PRNGKey(0))
        got = pd.sample((5,), generator=_g(1))
        assert tuple(got.shape) == tuple(np.shape(want)), n
    # Uniform's bounds broadcast to the sample's trailing shape
    assert tuple(PD.Uniform(Tt(LOC), Tt(LOC + 1)).sample(
        (5,), generator=_g(2)).shape) == (5, 3)


def test_categorical_and_multinomial_frequencies():
    probs = np.array([0.1, 0.6, 0.3], np.float32)
    c = PD.Categorical(probs=Tt(probs)).sample((N,), generator=_g(4))
    freq = np.bincount(c.numpy(), minlength=3) / N
    np.testing.assert_allclose(freq, probs, atol=0.012)
    mult = PD.Multinomial(5, Tt(probs)).sample((N,), generator=_g(5))
    assert mult.shape == (N, 3) and torch.all(mult.sum(-1) == 5)
    np.testing.assert_allclose(mult.mean(0).numpy(), 5 * probs, atol=0.04)
    mvn = PD.MultivariateNormal(Tt(LOC), scale_tril=Tt(TRIL))
    s = mvn.sample((N,), generator=_g(6)).double()
    np.testing.assert_allclose(s.mean(0).numpy(), LOC, atol=0.06)
    np.testing.assert_allclose(np.cov(s.numpy().T), TRIL @ TRIL.T,
                               rtol=0.06, atol=0.06)
    d = PD.Dirichlet(Tt(CONC)).sample((N,), generator=_g(7)).double()
    np.testing.assert_allclose(d.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(d.mean(0).numpy(), CONC / CONC.sum(),
                               atol=0.01)


def test_sampling_without_a_generator_draws_from_the_ambient_stream():
    import paddle_tpu_torch as ptt
    d = PD.Normal(torch.zeros(3), torch.ones(3))
    ptt.seed(9)
    a = d.sample((2,))
    ptt.seed(9)
    assert torch.equal(d.sample((2,)), a)


def test_rsample_is_differentiable_where_jax_is():
    """Normal through its noise; Gamma through the implicit gradient of
    its draw (E[d x / d alpha] = 1 / rate), as JAX's ``random.gamma``."""
    loc = torch.tensor(0.5, requires_grad=True)
    scale = torch.tensor(2.0, requires_grad=True)
    x = PD.Normal(loc, scale).rsample((N,), generator=_g(8))
    x.mean().backward()
    assert abs(float(loc.grad) - 1.0) < 1e-6
    assert abs(float(scale.grad)) < 0.03

    conc = torch.tensor(3.0, requires_grad=True)
    g = PD.Gamma(conc, torch.tensor(2.0)).rsample((N,), generator=_g(9))
    g.mean().backward()
    assert abs(float(conc.grad) - 0.5) < 0.02

    def jmean(c):
        return jnp.mean(JD.Gamma(c, 2.0).rsample((N,),
                                                  key=jax.random.PRNGKey(0)))
    assert abs(float(jax.grad(jmean)(3.0)) - 0.5) < 0.02
