"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``:
``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierNormal``, ``XavierUniform``, ``KaimingNormal``,
``KaimingUniform``, ``Orthogonal``, ``Assign`` and the short names
``constant``, ``normal``, ``uniform``).

Each initializer fills a tensor in place from an explicit
``torch.Generator``. The draw is made in fp32 on the tensor's device and
then cast, as the JAX initializers draw in fp32 and ``astype``.

Layouts. The fans, an ``Assign`` value and an ``Orthogonal`` draw are
those of the JAX package's shape. By default a 2-D tensor is a port
``Linear`` weight, stored [out, in], the transpose of the JAX [in, out]:
its fans are read from the JAX shape, and a value made in the JAX shape
is stored transposed. ``jax_layout=True`` says the tensor has the JAX
package's own shape (a parameter used as ``x @ w``, which
``Layer.create_parameter`` makes); nothing is transposed then.
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    """fan_in, fan_out of a JAX-layout shape (the JAX ``_fans``): [in,
    out] for 2-D, [out, in, *kernel] for a conv kernel."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _jax_shape(tensor, jax_layout):
    shape = tuple(tensor.shape)
    return shape if jax_layout or len(shape) != 2 else shape[::-1]


def _store(tensor, value, jax_layout):
    """Copy ``value`` (in the JAX shape) into ``tensor``."""
    if not jax_layout and tensor.dim() == 2:
        value = value.T
    return tensor.copy_(value)


def _draw(tensor):
    return torch.empty(tensor.shape, dtype=torch.float32,
                       device=tensor.device)


class Initializer:
    def __call__(self, tensor: torch.Tensor, generator: torch.Generator,
                 jax_layout: bool = False):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    @torch.no_grad()
    def __call__(self, tensor, generator=None, jax_layout=False):
        return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    @torch.no_grad()
    def __call__(self, tensor, generator, jax_layout=False):
        draw = _draw(tensor).normal_(self.mean, self.std, generator=generator)
        return tensor.copy_(draw)


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) truncated to [a, b] (the JAX initializer's
    defaults: a = -2, b = 2)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    @torch.no_grad()
    def __call__(self, tensor, generator, jax_layout=False):
        draw = _draw(tensor)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return tensor.copy_(self.mean + self.std * draw)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    @torch.no_grad()
    def __call__(self, tensor, generator, jax_layout=False):
        draw = _draw(tensor).uniform_(self.low, self.high,
                                      generator=generator)
        return tensor.copy_(draw)


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, tensor, generator, jax_layout=False):
        fan_in, fan_out = _fans(_jax_shape(tensor, jax_layout))
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std)(tensor, generator)


class XavierUniform(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, tensor, generator, jax_layout=False):
        fan_in, fan_out = _fans(_jax_shape(tensor, jax_layout))
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return Uniform(-limit, limit)(tensor, generator)


def _kaiming_gain(slope, nonlinearity):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    """N(0, gain / sqrt(fan_in)), gain sqrt(2) (relu) or sqrt(2 / (1 +
    slope^2)) for ``leaky_relu``; fan_in given (a conv's) or the JAX
    shape's."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, tensor, generator, jax_layout=False):
        fan_in = self.fan_in or _fans(_jax_shape(tensor, jax_layout))[0]
        std = _kaiming_gain(self.slope, self.nonlinearity) / math.sqrt(fan_in)
        return Normal(0.0, std)(tensor, generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in) (relu gain by
    default, as :class:`KaimingNormal`), with fan_in given (a conv's in /
    groups x kernel size) or else the JAX shape's in dim (a [out, in] or
    [r, in] port weight's in)."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, tensor, generator, jax_layout=False):
        fan_in = self.fan_in or _fans(_jax_shape(tensor, jax_layout))[0]
        limit = _kaiming_gain(self.slope, self.nonlinearity) \
            * math.sqrt(3.0 / fan_in)
        return Uniform(-limit, limit)(tensor, generator)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns, made in
    the JAX shape as ``jax.nn.initializers.orthogonal()`` makes it: the
    shape read as [prod(shape[:-1]), shape[-1]], the Q of a Gaussian's QR
    (signs fixed by R's diagonal), transposed when it has fewer rows than
    columns."""

    def __init__(self, gain=1.0):
        self.gain = gain

    @torch.no_grad()
    def __call__(self, tensor, generator, jax_layout=False):
        shape = _jax_shape(tensor, jax_layout)
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        wide = n_rows < n_cols
        a = torch.empty((n_cols, n_rows) if wide else (n_rows, n_cols),
                        dtype=torch.float32, device=tensor.device)
        a.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return _store(tensor, self.gain * q.reshape(shape), jax_layout)


class Assign(Initializer):
    """The given value, whose shape is the JAX shape."""

    def __init__(self, value):
        self.value = value

    @torch.no_grad()
    def __call__(self, tensor, generator=None, jax_layout=False):
        value = torch.as_tensor(self.value, device=tensor.device)
        shape = _jax_shape(tensor, jax_layout)
        if tuple(value.shape) != shape:
            raise ValueError(f"Assign value of shape {tuple(value.shape)} "
                             f"for a parameter of shape {shape}")
        return _store(tensor, value.to(tensor.dtype), jax_layout)


# Paddle's short names
constant = Constant
normal = Normal
uniform = Uniform
