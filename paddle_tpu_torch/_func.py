"""The JAX package's top-level functional transforms (``grad``,
``value_and_grad``, ``vjp``, ``jvp``, ``vmap``, ``stop_gradient``) on
``torch.func``, with JAX's signatures and return order.

``torch.func.grad_and_value`` returns (grad, value); ``value_and_grad``
returns JAX's (value, grad), and ((value, aux), grad) with ``has_aux``.
``argnums`` is JAX's keyword. Inside the function a transform runs,
``no_grad`` cuts no gradient (:func:`in_transform`), as the JAX
package's ``no_grad`` is a no-op marker there.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

_depth: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_transform_depth", default=0)


def in_transform() -> bool:
    """Whether the caller runs inside a function one of these transforms
    (or ``autograd``'s) is tracing."""
    return _depth.get() > 0


@contextlib.contextmanager
def _inside():
    token = _depth.set(_depth.get() + 1)
    try:
        yield
    finally:
        _depth.reset(token)


def traced(fn):
    """``fn`` run with :func:`in_transform` true."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with _inside():
            return fn(*args, **kwargs)
    return inner


def untaped(fn):
    """``fn`` run under ``torch.no_grad`` at the top level, so the result
    holds no eager autograd graph, as a JAX transform's result holds
    none; ``torch.func`` transforms ignore an outer ``no_grad``. Nested in
    another transform it runs as it is."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if in_transform():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return run


def _argnums(argnums):
    return tuple(argnums) if isinstance(argnums, list) else argnums


def grad(fun, argnums=0, has_aux=False):
    """``jax.grad``: the gradient of a scalar ``fun`` w.r.t. the
    arguments ``argnums`` (with ``has_aux``, (grad, aux))."""
    return untaped(torch.func.grad(traced(fun), argnums=_argnums(argnums),
                                    has_aux=has_aux))


def value_and_grad(fun, argnums=0, has_aux=False):
    """``jax.value_and_grad``: (value, grad), or ((value, aux), grad)."""
    gv = torch.func.grad_and_value(traced(fun), argnums=_argnums(argnums),
                                   has_aux=has_aux)

    @untaped
    @functools.wraps(fun)
    def value_grad(*args, **kwargs):
        g, value = gv(*args, **kwargs)
        return value, g
    return value_grad


def vjp(fun, *primals, has_aux=False):
    """``jax.vjp``: (out, vjp_fn) or (out, vjp_fn, aux); ``vjp_fn(ct)``
    returns a tuple, one cotangent a primal."""
    out = untaped(torch.func.vjp)(traced(fun), *primals, has_aux=has_aux)
    return (out[0], untaped(out[1])) + tuple(out[2:])


def jvp(fun, primals, tangents, has_aux=False):
    """``jax.jvp``: (out, tangent_out), with ``has_aux`` (out,
    tangent_out, aux). Through a function with no forward rule (the flash
    kernels') it raises, as in JAX."""
    return untaped(torch.func.jvp)(traced(fun), tuple(primals),
                                    tuple(tangents), has_aux=has_aux)


def vmap(fun, in_axes=0, out_axes=0):
    """``jax.vmap`` over ``in_axes`` / ``out_axes``. A random draw inside
    gives every mapped slice the same values (``randomness="same"``), as
    an unmapped JAX key does."""
    in_axes = tuple(in_axes) if isinstance(in_axes, list) else in_axes
    return torch.func.vmap(traced(fun), in_dims=in_axes, out_dims=out_axes,
                           randomness="same")


def stop_gradient(x):
    return x.detach()
