"""paddle.autograd (counterpart of ``paddle_tpu/autograd.py``; reference:
python/paddle/autograd/ — grad, the functional jacobian / hessian / vjp /
jvp, and PyLayer custom ops).

The JAX package's autograd is functional, so these are ``torch.func``
with Paddle's calling conventions, as the JAX ones are ``jax``'s:
``grad`` takes the loss *function*, ``jacobian`` and ``hessian`` take
``batch_axis`` through ``vmap``. ``PyLayer`` (a forward and a
hand-written backward) maps onto a ``torch.autograd.Function`` in the
form ``torch.func`` takes, built once a subclass, as the JAX one maps
onto ``jax.custom_vjp``: it composes with ``grad``, ``vjp`` and ``vmap``.

``no_grad`` is ``torch.no_grad`` in eager code, and cuts no gradient
inside a function a transform of the port runs (``_func.in_transform``),
where the JAX package is comparable: there its ``no_grad`` is a no-op
marker.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ._func import in_transform, traced, untaped

__all__ = ["grad", "jacobian", "hessian", "vjp", "jvp", "PyLayer",
           "no_grad"]


@untaped
def grad(outputs, inputs, grad_outputs=None, create_graph=False,
         retain_graph=None, allow_unused=False):
    """The gradient of ``outputs(*inputs)`` w.r.t. ``inputs``. As in the
    JAX package, ``outputs`` is the loss FUNCTION, not a tensor (a tensor
    raises ``TypeError``); without ``grad_outputs`` the output is summed
    first."""
    if not callable(outputs):
        raise TypeError(
            "paddle_tpu_torch.autograd.grad takes the loss FUNCTION, not a "
            "tensor: autograd here is functional. Migrate "
            "`paddle.grad(loss, xs)` to `autograd.grad(loss_fn, xs)`.")
    fn = outputs
    single = not isinstance(inputs, (tuple, list))
    xs = (inputs,) if single else tuple(inputs)
    if grad_outputs is None:
        g = torch.func.grad(traced(lambda *a: torch.sum(fn(*a))),
                            argnums=tuple(range(len(xs))))(*xs)
    else:
        out, pull = torch.func.vjp(traced(fn), *xs)
        if (isinstance(grad_outputs, (list, tuple))
                and len(grad_outputs) == 1
                and not isinstance(out, (list, tuple))):
            grad_outputs = grad_outputs[0]  # paddle's [g] for one output
        g = pull(grad_outputs)
    return g[0] if single else list(g)


def _batched(transform, func, xs, batch_axis):
    if batch_axis is not None:
        if isinstance(xs, (tuple, list)):
            raise NotImplementedError(
                "batch_axis with multiple inputs is not supported")
        return torch.func.vmap(transform(traced(func)),
                               in_dims=batch_axis)(xs)
    if not isinstance(xs, (tuple, list)):
        return transform(traced(func))(xs)
    args = tuple(xs)
    return list(transform(traced(func),
                          argnums=tuple(range(len(args))))(*args))


@untaped
def jacobian(func: Callable, xs, batch_axis: Optional[int] = None):
    """Reverse-mode rows (``jacrev``); with ``batch_axis``, one jacobian
    a sample through ``vmap`` (no cross-sample zero blocks)."""
    return _batched(torch.func.jacrev, func, xs, batch_axis)


@untaped
def hessian(func: Callable, xs, batch_axis: Optional[int] = None):
    """``jacfwd(jacrev)``: forward mode over reverse, so it raises through
    a function with no forward rule (the flash kernels'), as in JAX."""
    return _batched(torch.func.hessian, func, xs, batch_axis)


@untaped
def vjp(func: Callable, xs, v=None):
    """(outputs, vjp of ``v``), ``v`` ones by default
    (paddle.incubate.autograd.vjp)."""
    single = not isinstance(xs, (tuple, list))
    args = (xs,) if single else tuple(xs)
    out, pull = torch.func.vjp(traced(func), *args)
    if v is None:
        v = pytree.tree_map(torch.ones_like, out)
    g = pull(v)
    return out, (g[0] if single else list(g))


@untaped
def jvp(func: Callable, xs, v=None):
    """(outputs, jvp along ``v``), ``v`` ones by default."""
    single = not isinstance(xs, (tuple, list))
    args = (xs,) if single else tuple(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in args)
    else:
        tangents = (v,) if single else tuple(v)
    return torch.func.jvp(traced(func), args, tangents)


class _PyLayerContext:
    """The ``ctx`` a PyLayer's forward and backward get: Paddle's
    ``save_for_backward`` and ``saved_tensor()``. The backward's ctx holds
    what the forward saved, and nothing else (as in the JAX package)."""

    def __init__(self, saved=()):
        self._saved = tuple(saved)

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class _Layout:
    """How one ``apply`` laid its forward out as the Function's flat
    outputs: the user's outputs first, then the saved tensors (None
    ones kept out), so that ``setup_context`` can save them."""

    def __init__(self):
        self.n_out = self.tuple_out = self.saved_at = self.n_saved = None


_layouts = threading.local()


def _layout_stack():
    stack = getattr(_layouts, "stack", None)
    if stack is None:
        stack = _layouts.stack = []
    return stack


def _make_op(cls):
    """The ``torch.autograd.Function`` of one PyLayer subclass."""

    def forward(*args):
        layout = _layout_stack()[-1]
        ctx = _PyLayerContext()
        out = cls.forward(ctx, *args)
        layout.tuple_out = isinstance(out, tuple)
        outs = out if layout.tuple_out else (out,)
        layout.n_out = len(outs)
        layout.saved_at = [i for i, s in enumerate(ctx._saved)
                           if s is not None]
        layout.n_saved = len(ctx._saved)
        saved = tuple(ctx._saved[i].detach() for i in layout.saved_at)
        return tuple(outs) + saved

    def setup_context(ctx, inputs, output):
        layout = _layout_stack()[-1]
        saved = output[layout.n_out:]
        ctx.mark_non_differentiable(*saved)
        ctx.save_for_backward(*saved)
        ctx.layout = (layout.n_out, layout.tuple_out, layout.saved_at,
                      layout.n_saved)
        ctx.n_args = len(inputs)

    def backward(ctx, *grads):
        n_out, tuple_out, saved_at, n_saved = ctx.layout
        saved = [None] * n_saved
        for i, t in zip(saved_at, ctx.saved_tensors):
            saved[i] = t
        g = tuple(grads[:n_out]) if tuple_out else grads[0]
        out = cls.backward(_PyLayerContext(saved), g)
        if not isinstance(out, tuple):
            out = (out,)
        # pad: no gradient for the arguments the backward left out
        return tuple(out[i] if i < len(out) else None
                     for i in range(ctx.n_args))

    return type(f"{cls.__name__}Function", (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "setup_context": staticmethod(setup_context),
                 "backward": staticmethod(backward),
                 "generate_vmap_rule": True})


class PyLayerMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)
        # rebuild the op whenever the class (re)defines forward OR
        # backward: a subclass overriding only backward must not keep the
        # parent's rule
        if name == "PyLayer" or not (
                ("forward" in ns or "backward" in ns)
                and hasattr(cls, "forward") and hasattr(cls, "backward")):
            return
        cls._op = _make_op(cls)


class PyLayer(metaclass=PyLayerMeta):
    """A custom op with a hand-written backward (reference:
    paddle.autograd.PyLayer). Subclass with ``@staticmethod forward(ctx,
    *x)`` and ``backward(ctx, grad)`` (``grad`` a tuple when forward
    returns one); call ``MyOp.apply(*x)``. Eager ``.backward()`` and the
    ``torch.func`` transforms both run your backward."""

    @classmethod
    def apply(cls, *args):
        stack = _layout_stack()
        layout = _Layout()
        stack.append(layout)
        try:
            flat = cls._op.apply(*args)
        finally:
            stack.pop()
        outs = flat[:layout.n_out]
        return tuple(outs) if layout.tuple_out else outs[0]


class no_grad:
    """``no_grad()`` (a context) or ``no_grad(fn)`` / ``@no_grad()`` (a
    decorator): ``torch.no_grad`` in eager code; inside a function a
    transform of the port runs it cuts nothing, as the JAX package's
    no-op marker does there."""

    def __new__(cls, fn=None):
        if callable(fn):
            return super().__new__(cls)(fn)
        return super().__new__(cls)

    def __init__(self, fn=None):
        self._ctx = []

    def __enter__(self):
        ctx = contextlib.nullcontext() if in_transform() else torch.no_grad()
        ctx.__enter__()
        self._ctx.append(ctx)
        return self

    def __exit__(self, *exc):
        return self._ctx.pop().__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)
        return wrapped
