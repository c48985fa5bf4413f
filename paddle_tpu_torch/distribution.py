"""paddle.distribution (counterpart of ``paddle_tpu/distribution.py``;
reference: python/paddle/distribution/ — the Distribution base, the
families, the transforms and the ``kl_divergence`` registry).

``log_prob``, ``entropy``, ``mean``, ``variance`` and the registered KLs
are the JAX package's formulas, in torch. ``sample`` and ``rsample`` take
a ``torch.Generator`` where the JAX methods take a key, and draw from the
ambient stream without one (``utils.rng.next_generator``), so samples
match the JAX package's in distribution only. ``rsample`` is
differentiable where the JAX one is: the location-scale families through
their noise, and Gamma, Beta, Dirichlet, Chi2 and StudentT through
``torch._standard_gamma``'s implicit gradient (JAX's ``random.gamma`` has
one too), drawn under a seed taken from the generator.

Parameters are tensors on the device of the first tensor given (the
card when none is), in float32 where the JAX class casts to float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .device import resolve_device

__all__ = [
    "Distribution", "Normal", "LogNormal", "Uniform", "Categorical",
    "Bernoulli", "Beta", "Dirichlet", "Gamma", "Exponential", "Laplace",
    "kl_divergence", "register_kl",
    "Gumbel", "Cauchy", "Geometric", "Poisson", "Binomial", "Multinomial",
    "MultivariateNormal", "Chi2", "StudentT", "Transform",
    "AffineTransform", "AbsTransform", "ExpTransform", "SigmoidTransform",
    "TransformedDistribution", "Independent", "ContinuousBernoulli",
]

_EULER = 0.5772156649015329


def _params(*vals, dtype=torch.float32):
    """The parameters as tensors on one device (the first tensor's, else
    the card); ``dtype`` None keeps a tensor's own dtype."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    dev = dev if dev is not None else resolve_device(None)
    out = [torch.as_tensor(v, device=dev) for v in vals]
    if dtype is not None:
        out = [t.to(dtype) for t in out]
    return out if len(out) > 1 else out[0]


def _gen(generator, device):
    if generator is not None:
        return generator
    from .utils.rng import next_generator
    return next_generator(device)


def _uniform(shape, device, generator, low=0.0, high=1.0):
    u = torch.rand(tuple(shape), generator=_gen(generator, device),
                   device=device)
    return low + (high - low) * u


def _normal(shape, device, generator, dtype=torch.float32):
    return torch.randn(tuple(shape), generator=_gen(generator, device),
                       device=device, dtype=dtype)


def _standard_gamma(alpha, generator):
    """Gamma(alpha, 1) draws of ``alpha``'s shape, differentiable in alpha
    (implicit gradient), under a seed drawn from ``generator``."""
    gen = _gen(generator, alpha.device)
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                             device=gen.device))
    devices = [alpha.device] if alpha.device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices,
                               device_type=alpha.device.type):
        torch.manual_seed(seed)
        return torch._standard_gamma(alpha)


def _bshape(*ts):
    return torch.broadcast_shapes(*(t.shape for t in ts))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Distribution:
    def sample(self, shape=(), generator=None):
        raise NotImplementedError

    def rsample(self, shape=(), generator=None):
        """A reparameterized sample (differentiable where defined)."""
        return self.sample(shape, generator=generator)

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale, dtype=None)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale ** 2

    def sample(self, shape=(), generator=None):
        dt = self.loc.dtype if self.loc.is_floating_point() \
            else torch.float32
        eps = _normal(tuple(shape) + _bshape(self.loc, self.scale),
                      self.loc.device, generator, dt)
        return self.loc + self.scale * eps

    rsample = sample

    def log_prob(self, value):
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def cdf(self, value):
        return 0.5 * (1 + torch.erf((value - self.loc)
                                    / (self.scale * math.sqrt(2))))


class LogNormal(Distribution):
    def __init__(self, loc, scale):
        self.base = Normal(loc, scale)

    @property
    def mean(self):
        return torch.exp(self.base.loc + self.base.scale ** 2 / 2)

    def sample(self, shape=(), generator=None):
        return torch.exp(self.base.sample(shape, generator=generator))

    rsample = sample

    def log_prob(self, value):
        return self.base.log_prob(torch.log(value)) - torch.log(value)

    def entropy(self):
        return self.base.entropy() + self.base.loc


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low, self.high = _params(low, high)

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + _bshape(self.low, self.high),
                     self.low.device, generator)
        return self.low + (self.high - self.low) * u

    rsample = sample

    def log_prob(self, value):
        inside = (value >= self.low) & (value < self.high)
        return torch.where(inside, -torch.log(self.high - self.low),
                           float("-inf"))

    def entropy(self):
        return torch.log(self.high - self.low)


def _categorical(logits, shape, generator):
    """Draws of shape ``shape + logits.shape[:-1]`` from softmax(logits)."""
    k = logits.shape[-1]
    batch = logits.shape[:-1]
    n = math.prod(shape) if shape else 1
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, k)
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=_gen(generator, logits.device))
    return draws.T.reshape(tuple(shape) + tuple(batch))


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None):
        if (logits is None) == (probs is None):
            raise ValueError("pass exactly one of logits/probs")
        self.logits = (_params(logits, dtype=None) if logits is not None
                       else torch.log(_params(probs, dtype=None)))

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=(), generator=None):
        return _categorical(self.logits, tuple(shape), generator)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        idx = value.long()[..., None]
        logp = logp.expand(idx.shape[:-1] + logp.shape[-1:])
        return torch.gather(logp, -1, idx)[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)


class Bernoulli(Distribution):
    def __init__(self, probs):
        self.probs = _params(probs, dtype=None)

    @property
    def mean(self):
        return self.probs

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + self.probs.shape, self.probs.device,
                     generator)
        return (u < self.probs).to(torch.float32)

    def log_prob(self, value):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return value * torch.log(p) + (1 - value) * torch.log1p(-p)

    def entropy(self):
        p = torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha, self.beta = _params(alpha, beta)

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.alpha, self.beta)
        gen = _gen(generator, self.alpha.device)
        ga = _standard_gamma(self.alpha.expand(shape), gen)
        gb = _standard_gamma(self.beta.expand(shape), gen)
        return ga / (ga + gb)

    rsample = sample

    def log_prob(self, value):
        return ((self.alpha - 1) * torch.log(value)
                + (self.beta - 1) * torch.log1p(-value)
                - _betaln(self.alpha, self.beta))

    def entropy(self):
        a, b = self.alpha, self.beta
        return (_betaln(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(Distribution):
    def __init__(self, concentration):
        self.concentration = _params(concentration)

    @property
    def mean(self):
        c = self.concentration
        return c / torch.sum(c, dim=-1, keepdim=True)

    def sample(self, shape=(), generator=None):
        c = self.concentration
        g = _standard_gamma(c.expand(tuple(shape) + c.shape), generator)
        return g / g.sum(-1, keepdim=True)

    rsample = sample

    def log_prob(self, value):
        c = self.concentration
        norm = (torch.sum(torch.lgamma(c), dim=-1)
                - torch.lgamma(torch.sum(c, dim=-1)))
        return torch.sum((c - 1) * torch.log(value), dim=-1) - norm


class Gamma(Distribution):
    def __init__(self, concentration, rate):
        self.concentration, self.rate = _params(concentration, rate)

    @property
    def mean(self):
        return self.concentration / self.rate

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.concentration, self.rate)
        return _standard_gamma(self.concentration.expand(shape),
                               generator) / self.rate

    rsample = sample

    def log_prob(self, value):
        c, r = self.concentration, self.rate
        return (c * torch.log(r) + (c - 1) * torch.log(value) - r * value
                - torch.lgamma(c))

    def entropy(self):
        c, r = self.concentration, self.rate
        return c - torch.log(r) + torch.lgamma(c) + (1 - c) * torch.digamma(c)


class Exponential(Distribution):
    def __init__(self, rate):
        self.rate = _params(rate)

    @property
    def mean(self):
        return 1.0 / self.rate

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + self.rate.shape, self.rate.device,
                     generator)
        return -torch.log1p(-u) / self.rate

    rsample = sample

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * value

    def entropy(self):
        return 1.0 - torch.log(self.rate)


class Laplace(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self):
        return self.loc

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + _bshape(self.loc, self.scale),
                     self.loc.device, generator, -1.0, 1.0)
        return self.loc - self.scale * torch.sign(u) * torch.log1p(-u.abs())

    rsample = sample

    def log_prob(self, value):
        return (-torch.abs(value - self.loc) / self.scale
                - torch.log(2 * self.scale))

    def entropy(self):
        return 1.0 + torch.log(2 * self.scale)


# --------------------------------------------------------------------- KL
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    fn = _KL_REGISTRY.get((type(p), type(q)))
    if fn is None:
        raise NotImplementedError(
            f"no KL registered for ({type(p).__name__}, {type(q).__name__})")
    return fn(p, q)


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    logp = torch.log_softmax(p.logits, dim=-1)
    logq = torch.log_softmax(q.logits, dim=-1)
    return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    pp = torch.clamp(p.probs, 1e-7, 1 - 1e-7)
    qq = torch.clamp(q.probs, 1e-7, 1 - 1e-7)
    return (pp * (torch.log(pp) - torch.log(qq))
            + (1 - pp) * (torch.log1p(-pp) - torch.log1p(-qq)))


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    return torch.log((q.high - q.low) / (p.high - p.low))


class Gumbel(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    @property
    def mean(self):
        return self.loc + self.scale * _EULER

    @property
    def variance(self):
        return (math.pi ** 2 / 6) * self.scale ** 2

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + _bshape(self.loc, self.scale),
                     self.loc.device, generator)
        tiny = torch.finfo(torch.float32).tiny
        g = -torch.log(-torch.log(u.clamp_min(tiny)))
        return self.loc + self.scale * g

    rsample = sample

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    def entropy(self):
        return torch.log(self.scale) + 1.0 + _EULER

    def cdf(self, value):
        return torch.exp(-torch.exp(-(value - self.loc) / self.scale))


class Cauchy(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + _bshape(self.loc, self.scale),
                     self.loc.device, generator)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    rsample = sample

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -torch.log(math.pi * self.scale * (1 + z ** 2))

    def entropy(self):
        return torch.log(4 * math.pi * self.scale)

    def cdf(self, value):
        return torch.atan((value - self.loc) / self.scale) / math.pi + 0.5


class Geometric(Distribution):
    """P(X = k) = (1 - p)^k p, k >= 0 failures before the first success."""

    def __init__(self, probs):
        self.probs = _params(probs)

    @property
    def mean(self):
        return (1 - self.probs) / self.probs

    @property
    def variance(self):
        return (1 - self.probs) / self.probs ** 2

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + self.probs.shape, self.probs.device,
                     generator, 1e-7, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-self.probs))

    def log_prob(self, value):
        return value * torch.log1p(-self.probs) + torch.log(self.probs)

    def entropy(self):
        p = self.probs
        return (-(1 - p) * torch.log1p(-p) - p * torch.log(p)) / p


class Poisson(Distribution):
    def __init__(self, rate):
        self.rate = _params(rate)

    mean = property(lambda self: self.rate)
    variance = property(lambda self: self.rate)

    def sample(self, shape=(), generator=None):
        rate = self.rate.expand(tuple(shape) + self.rate.shape)
        return torch.poisson(rate, generator=_gen(generator,
                                                  self.rate.device))

    def log_prob(self, value):
        return value * torch.log(self.rate) - self.rate \
            - torch.lgamma(value + 1.0)


class Binomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count, self.probs = _params(total_count, probs)

    mean = property(lambda self: self.total_count * self.probs)
    variance = property(
        lambda self: self.total_count * self.probs * (1 - self.probs))

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.total_count, self.probs)
        return torch.binomial(self.total_count.expand(shape),
                              self.probs.expand(shape),
                              generator=_gen(generator, self.probs.device))

    def log_prob(self, value):
        n, p = self.total_count, torch.clamp(self.probs, 1e-7, 1 - 1e-7)
        comb = (torch.lgamma(n + 1) - torch.lgamma(value + 1)
                - torch.lgamma(n - value + 1))
        return comb + value * torch.log(p) + (n - value) * torch.log1p(-p)


class Multinomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count = int(total_count)
        self.probs = _params(probs)

    @property
    def mean(self):
        return self.total_count * self.probs

    def sample(self, shape=(), generator=None):
        """Counts of shape ``shape + batch + (K,)``: each batch lane draws
        ``total_count`` categories of its own."""
        shape = tuple(shape)
        cat = _categorical(torch.log(self.probs),
                           shape + (self.total_count,), generator)
        onehot = (cat[..., None] == torch.arange(
            self.probs.shape[-1], device=cat.device)).to(torch.float32)
        return onehot.sum(dim=len(shape))

    def log_prob(self, value):
        p = torch.clamp(self.probs, 1e-12, 1.0)
        return (math.lgamma(self.total_count + 1.0)
                - torch.sum(torch.lgamma(value + 1.0), dim=-1)
                + torch.sum(value * torch.log(p), dim=-1))


def _diag_log_sum(tril):
    return torch.sum(torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)),
                     dim=-1)


class MultivariateNormal(Distribution):
    def __init__(self, loc, covariance_matrix=None, scale_tril=None):
        if scale_tril is None:
            if covariance_matrix is None:
                raise ValueError("need covariance_matrix or scale_tril")
            self.loc, cov = _params(loc, covariance_matrix)
            scale_tril = torch.linalg.cholesky(cov)
        else:
            self.loc, scale_tril = _params(loc, scale_tril)
        self.scale_tril = scale_tril

    mean = property(lambda self: self.loc)

    @property
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.transpose(-1, -2)

    def sample(self, shape=(), generator=None):
        eps = _normal(tuple(shape) + self.loc.shape, self.loc.device,
                      generator)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril,
                                       eps)

    rsample = sample

    def log_prob(self, value):
        d = self.loc.shape[-1]
        diff = value - self.loc
        tril = self.scale_tril.expand(diff.shape[:-1] + (d, d))
        sol = torch.linalg.solve_triangular(tril, diff[..., None],
                                            upper=False)[..., 0]
        return (-0.5 * torch.sum(sol ** 2, dim=-1)
                - _diag_log_sum(self.scale_tril)
                - 0.5 * d * math.log(2 * math.pi))

    def entropy(self):
        d = self.loc.shape[-1]
        return (0.5 * d * (1 + math.log(2 * math.pi))
                + _diag_log_sum(self.scale_tril))


class Chi2(Distribution):
    def __init__(self, df):
        self.df = _params(df)
        self._gamma = Gamma(self.df / 2.0, torch.full_like(self.df, 0.5))

    mean = property(lambda self: self.df)
    variance = property(lambda self: 2.0 * self.df)

    def sample(self, shape=(), generator=None):
        return self._gamma.sample(shape, generator)

    def log_prob(self, value):
        return self._gamma.log_prob(value)


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = _params(df, loc, scale)

    @property
    def mean(self):
        return torch.where(self.df > 1, self.loc, float("nan"))

    @property
    def variance(self):
        return torch.where(self.df > 2, self.scale ** 2 * self.df
                           / (self.df - 2), float("nan"))

    def sample(self, shape=(), generator=None):
        shape = tuple(shape) + _bshape(self.df, self.loc, self.scale)
        gen = _gen(generator, self.df.device)
        z = _normal(shape, self.df.device, gen)
        chi2 = 2.0 * _standard_gamma((self.df / 2.0).expand(shape), gen)
        return self.loc + self.scale * z * torch.sqrt(self.df / chi2)

    rsample = sample

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        d = self.df
        return (torch.lgamma((d + 1) / 2) - torch.lgamma(d / 2)
                - 0.5 * torch.log(d * math.pi) - torch.log(self.scale)
                - (d + 1) / 2 * torch.log1p(z ** 2 / d))


# ------------------------------------------------------------- transforms
class Transform:
    """A bijector (reference: paddle.distribution.Transform)."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def __call__(self, x):
        return self.forward(x)


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc, self.scale = _params(loc, scale)

    def forward(self, x):
        return self.loc + self.scale * x

    def inverse(self, y):
        return (y - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.scale)).expand(x.shape)


class AbsTransform(Transform):
    """y = |x| (not bijective: the inverse is the positive branch)."""

    def forward(self, x):
        return torch.abs(x)

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class ExpTransform(Transform):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return x


class SigmoidTransform(Transform):
    def forward(self, x):
        return torch.sigmoid(x)

    def inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def forward_log_det_jacobian(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TransformedDistribution(Distribution):
    """A base distribution pushed through a chain of transforms."""

    def __init__(self, base, transforms):
        self.base = base
        self.transforms = list(transforms)

    def sample(self, shape=(), generator=None):
        x = self.base.sample(shape, generator)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        lp = torch.zeros_like(torch.as_tensor(value, dtype=torch.float32))
        y = value
        for t in reversed(self.transforms):
            x = t.inverse(y)
            lp = lp - t.forward_log_det_jacobian(x)
            y = x
        return lp + self.base.log_prob(y)


class Independent(Distribution):
    """The rightmost ``reinterpreted_batch_rank`` batch dims read as event
    dims (``log_prob`` and ``entropy`` summed over them)."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)

    def sample(self, shape=(), generator=None):
        return self.base.sample(shape, generator)

    rsample = sample

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        return torch.sum(lp, dim=tuple(range(-self.rank, 0)))

    def entropy(self):
        return torch.sum(self.base.entropy(), dim=tuple(range(-self.rank, 0)))


class ContinuousBernoulli(Distribution):
    """Loaiza-Ganem & Cunningham 2019 (reference:
    paddle.distribution.ContinuousBernoulli)."""

    def __init__(self, probs):
        self.probs = torch.clamp(_params(probs), 1e-6, 1 - 1e-6)

    def _near_half(self):
        p = self.probs
        near = torch.abs(p - 0.5) < 1e-3
        return near, torch.where(near, torch.full_like(p, 0.25), p)

    def _log_norm(self):
        near, safe = self._near_half()
        c = (torch.log(torch.abs(2.0 * torch.atanh(1.0 - 2.0 * safe)))
             - torch.log(torch.abs(1.0 - 2.0 * safe)))
        return torch.where(near, torch.full_like(c, math.log(2.0)), c)

    def log_prob(self, value):
        p = self.probs
        return (value * torch.log(p) + (1 - value) * torch.log1p(-p)
                + self._log_norm())

    def sample(self, shape=(), generator=None):
        """By the inverse CDF."""
        u = _uniform(tuple(shape) + self.probs.shape, self.probs.device,
                     generator, 1e-6, 1 - 1e-6)
        near, safe = self._near_half()
        x = (torch.log1p(u * (2 * safe - 1) / (1 - safe))
             / (torch.log(safe) - torch.log1p(-safe)))
        return torch.where(near, u, x)


@register_kl(Gumbel, Gumbel)
def _kl_gumbel(p, q):
    return (torch.log(q.scale) - torch.log(p.scale)
            + _EULER * (p.scale / q.scale - 1.0)
            + torch.expm1((q.loc - p.loc) / q.scale
                          + torch.lgamma(1.0 + p.scale / q.scale))
            - (q.loc - p.loc) / q.scale)


@register_kl(MultivariateNormal, MultivariateNormal)
def _kl_mvn(p, q):
    d = p.loc.shape[-1]
    eye = torch.eye(d, dtype=q.scale_tril.dtype,
                    device=q.scale_tril.device).expand(q.scale_tril.shape)
    qinv = torch.linalg.solve_triangular(q.scale_tril, eye, upper=False)
    m = qinv @ p.scale_tril
    tr = torch.sum(m ** 2, dim=(-2, -1))
    diff = q.loc - p.loc
    maha = torch.sum((qinv @ diff[..., None])[..., 0] ** 2, dim=-1)
    logdet = _diag_log_sum(q.scale_tril) - _diag_log_sum(p.scale_tril)
    return 0.5 * (tr + maha - d) + logdet
