"""Paddle's tensor API (counterpart of ``paddle_tpu/tensor.py``; reference:
paddle/tensor/{creation,manipulation,math,linalg,search,logic,stat,
random}.py).

A tensor *is* a ``torch.Tensor`` (``Tensor = torch.Tensor``), as the JAX
package's is a ``jax.Array``. The functions keep the JAX package's
semantics where Paddle's names, as JAX implements them, differ from
torch's: ``transpose`` permutes, ``split(x, n)`` makes ``n`` equal
sections, ``chunk`` is ``array_split``, ``gather`` fills out-of-range
indices (``jnp.take``) while ``gather_nd`` and ``take`` clamp them (JAX
indexing), ``median`` averages the two middle values, ``max`` / ``min`` /
``sort`` return values only, ``pad`` is ``jnp.pad``'s, and so on. Each
such case is held to the JAX function by ``tests/test_torch_tensor.py``.

Devices: the creation and random functions take ``device=None``, which
means the CUDA card (``device.resolve_device``); ``device="cpu"`` asks
for the CPU. Every other function follows its inputs' device.

Purity: JAX arrays are immutable, so no function here writes into its
inputs (``index_put``, ``scatter``, ``index_add`` and ``masked_fill`` are
the out-of-place torch forms). A result may share its input's storage
where torch returns a view (``reshape``, ``transpose``), as a JAX result
may alias its operand; ``as_strided`` returns a copy.

Random draws take a ``torch.Generator`` where the JAX function takes a
key; without one they draw from the ambient stream
(``utils.rng.next_generator``), as JAX draws ``next_key()``. Values
match the JAX package's in distribution only.

The module shadows ``max``, ``min``, ``sum``, ``abs``, ``round``,
``slice``, ``all``, ``any`` and ``pow``; inside it the builtins are
reached as ``builtins.*``.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .device import resolve_device
from .dtypes import to_dtype

Tensor = torch.Tensor


# ------------------------------------------------------------------ helpers
def _t(x, like=None):
    """``x`` as a tensor, on ``like``'s device when it is not one."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple))
                           else x, device=dev)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dev(device, generator=None):
    if device is None and generator is not None:
        return generator.device
    return resolve_device(device)


def _axes(x, axis):
    """``axis`` (None, an int or a sequence) as a tuple of dims of x."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(a % builtins.max(x.dim(), 1) for a in axis)
    return (axis % builtins.max(x.dim(), 1),)


def _float(x):
    """Integers and bools as float32, as ``jnp``'s inexact promotion."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _promote(*xs):
    """The operands as tensors of one dtype on the first tensor's device:
    tensors (and arrays) promote as ``jnp`` does, a Python number is weak
    (an fp16 tensor plus 2.0 stays fp16)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    ts = [x if isinstance(x, (bool, int, float, complex)) else _t(x, like)
          for x in xs]
    dt = None
    for t in ts:
        if isinstance(t, torch.Tensor):
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    for t in ts:
        if not isinstance(t, torch.Tensor):
            dt = torch.as_tensor(t).dtype if dt is None else \
                torch.result_type(torch.empty(1, dtype=dt), t)
    dev = like.device if like is not None else None
    return [t.to(dt) if isinstance(t, torch.Tensor)
            else torch.as_tensor(t, dtype=dt, device=dev) for t in ts]


def _reduce(fn, x, axis, keepdim, **kw):
    """``fn(x, dim=dims, keepdim=keepdim)`` over ``axis`` (None: every
    dim; an empty tuple: none, as in ``jnp``)."""
    if isinstance(axis, (list, tuple)) and len(axis) == 0:
        return x
    if x.dim() == 0:
        return fn(x, **kw)
    return fn(x, dim=_axes(x, axis), keepdim=keepdim, **kw)


def _to_last(x, axis):
    """x with the dims of ``axis`` moved last and flattened into one,
    and a function that puts a reduced result's kept dims back."""
    dims = _axes(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])

    def keep(out, keepdim):
        if not keepdim:
            return out
        shape = list(out.shape[:out.dim() - len(rest)])
        full = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        return out.reshape(shape + full)
    return y, keep


def _fill_value(dtype):
    """``jnp.take``'s fill for an out-of-range index: NaN for inexact
    types, the minimum of a signed type, the maximum of an unsigned one,
    True for bools."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if dtype == torch.uint8 else info.min


def _wrap_clamp(idx, n):
    """JAX indexing: negatives wrap once, then out-of-range clamps."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, builtins.max(n - 1, 0))


# ---------------------------------------------------------------- creation
def to_tensor(data, dtype=None, stop_gradient=True, device=None):
    """A tensor of ``data`` on ``device`` (the card by default; a tensor
    stays on its own device unless one is named). ``stop_gradient=False``
    makes a floating result require gradients."""
    dt = to_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.to(device=data.device if device is None
                      else resolve_device(device), dtype=dt)
    else:
        if isinstance(data, (list, tuple)):
            data = np.asarray(data)
        out = torch.as_tensor(data, dtype=dt, device=resolve_device(device))
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out = out.detach().requires_grad_(True)
    return out


def zeros(shape, dtype="float32", device=None):
    return torch.zeros(_shape(shape), dtype=to_dtype(dtype),
                       device=resolve_device(device))


def ones(shape, dtype="float32", device=None):
    return torch.ones(_shape(shape), dtype=to_dtype(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype="float32", device=None):
    return torch.full(_shape(shape), fill_value, dtype=to_dtype(dtype),
                      device=resolve_device(device))


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=to_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=to_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=to_dtype(dtype))


def arange(start, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=to_dtype(dtype),
                        device=resolve_device(device))


def _linspace(start, stop, num, dtype, device):
    """``jnp.linspace``'s arithmetic: start * (1 - t) + stop * t with t =
    i / (num - 1), the last point ``stop`` exactly."""
    ct = dtype if dtype is not None and dtype.is_floating_point \
        else torch.float32
    start = torch.as_tensor(start, dtype=ct, device=device)
    stop = torch.as_tensor(stop, dtype=ct, device=device)
    if num > 1:
        t = torch.arange(num - 1, dtype=ct, device=device) / (num - 1)
        out = torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if dtype is not None and not dtype.is_floating_point:
        out = out.floor()
    return out.to(dtype or ct)


def linspace(start, stop, num, dtype=None, device=None):
    return _linspace(start, stop, int(num), to_dtype(dtype),
                     resolve_device(device))


def eye(num_rows, num_columns=None, dtype="float32", device=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=to_dtype(dtype),
                     device=resolve_device(device))


def empty(shape, dtype="float32", device=None):
    """Zeros, as the JAX package's ``empty`` gives."""
    return zeros(shape, dtype, device)


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def diag(x, offset=0):
    return torch.diag(x, offset)


def meshgrid(*args, **kwargs):
    return list(torch.meshgrid(*args, indexing=kwargs.get("indexing",
                                                          "ij")))


def clone(x):
    return _t(x).clone()


def numpy(x):
    """A numpy array of ``x``'s values, from any device and whether it
    requires gradients (bf16 comes back as float32: numpy has no bf16)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ------------------------------------------------------------ manipulation
def reshape(x, shape):
    return torch.reshape(x, _shape(shape))


def transpose(x, perm):
    """Paddle's transpose: a permutation of every dim (``permute``)."""
    return x.permute(tuple(perm))


def concat(xs, axis=0):
    return torch.cat(_promote(*xs), dim=axis)


def stack(xs, axis=0):
    return torch.stack(_promote(*xs), dim=axis)


def split(x, num_or_sections, axis=0):
    """An int makes that many equal sections (``jnp.split``; a size it
    does not divide raises); a list gives section sizes, one of them -1
    for the rest."""
    if isinstance(num_or_sections, int):
        n = x.shape[axis]
        if n % num_or_sections:
            raise ValueError("array split does not result in an equal "
                             f"division: {n} into {num_or_sections}")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    sizes = list(num_or_sections)
    if -1 in sizes:
        known = builtins.sum(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = x.shape[axis] - known
    cuts = np.cumsum(sizes)[:-1].tolist()
    return list(torch.tensor_split(x, cuts, dim=axis))


def chunk(x, chunks, axis=0):
    """``jnp.array_split``: ``chunks`` sections, the first ones a row
    longer where the size does not divide (6 rows into 4: 2, 2, 1, 1)."""
    return list(torch.tensor_split(x, chunks, dim=axis))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    dims = _axes(x, axis)
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one: dim {d} of "
                             f"{tuple(x.shape)}")
    return torch.squeeze(x, dims)


def unsqueeze(x, axis):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def expand(x, shape):
    """-1 keeps a dim; dims align from the right, so -1 for a new
    leading dim raises."""
    shape = list(_shape(shape))
    offset = len(shape) - x.dim()
    out = []
    for i, s in enumerate(shape):
        if s == -1:
            if i < offset:
                raise ValueError("expand: -1 not allowed for a new leading "
                                 "dim")
            out.append(x.shape[i - offset])
        else:
            out.append(s)
    return torch.broadcast_to(x, out)


def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


def broadcast_to(x, shape):
    return torch.broadcast_to(x, _shape(shape))


def tile(x, repeat_times):
    return torch.tile(x, _shape(repeat_times))


def flatten(x, start_axis=0, stop_axis=-1):
    """Dims ``start_axis`` .. ``stop_axis`` as one; a 0-d tensor gives
    shape [1]."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, dims=axis)


def flip(x, axis):
    return torch.flip(x, _axes(x, axis))


def gather(x, index, axis=0):
    """``jnp.take``: an index in [-n, n) picks (a negative one wraps
    once); any other index fills (NaN for floats, the dtype's minimum for
    signed ints). ``axis=None`` takes from the flattened tensor."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    idx = _t(index, x).to(x.device).long()
    n = x.shape[axis]
    ok = (idx >= -n) & (idx < n)
    flat = _wrap_clamp(idx, n).reshape(-1)
    out = x.index_select(axis, flat).reshape(
        x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    ok = ok.reshape((1,) * axis + idx.shape + (1,) * (x.dim() - axis - 1))
    return torch.where(ok, out, torch.full((), _fill_value(x.dtype),
                                           dtype=x.dtype, device=x.device))


index_select = gather


def gather_nd(x, index):
    """``x[tuple(index[..., i])]`` as JAX indexes: negatives wrap once and
    out-of-range indices clamp; nothing raises."""
    idx = _t(index, x).to(x.device).long()
    parts = tuple(_wrap_clamp(idx[..., i], x.shape[i])
                  for i in range(idx.shape[-1]))
    return x[parts]


def take_along_axis(x, indices, axis):
    """``jnp.take_along_axis``: indices broadcast against x off the axis;
    a negative one wraps once, an out-of-range one fills."""
    idx = _t(indices, x).to(x.device).long()
    axis %= x.dim()
    n = x.shape[axis]
    shape = list(torch.broadcast_shapes(
        tuple(1 if d == axis else s for d, s in enumerate(x.shape)),
        tuple(1 if d == axis else s for d, s in enumerate(idx.shape))))
    xs, ishape = list(shape), list(shape)
    xs[axis], ishape[axis] = n, idx.shape[axis]
    idx = idx.expand(ishape)
    out = torch.gather(x.expand(xs), axis, _wrap_clamp(idx, n))
    ok = (idx >= -n) & (idx < n)
    return torch.where(ok, out, torch.full((), _fill_value(x.dtype),
                                           dtype=x.dtype, device=x.device))


def put_along_axis(x, indices, values, axis):
    """``jnp.put_along_axis(..., inplace=False)``: a copy of x with
    ``values`` set at ``indices`` along ``axis``."""
    idx = _t(indices, x).to(x.device).long()
    axis %= x.dim()
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx).expand(shape)
    vals = _t(values, x).to(x.device, x.dtype).expand(shape)
    return x.scatter(axis, idx, vals)


def _rows(x, index):
    """An axis-0 index of x (an int, a list or a tensor) as a tensor,
    negatives wrapped."""
    idx = _t(index, x).to(x.device).long()
    return torch.where(idx < 0, idx + x.shape[0], idx)


def scatter(x, index, updates, overwrite=True):
    """x with ``updates`` at rows ``index``: set (``overwrite``), or
    **added to x** (``x.at[index].add``), as the JAX package does."""
    idx = _rows(x, index)
    upd = _t(updates, x).to(x.device, x.dtype)
    return x.index_put((idx,), upd, accumulate=not overwrite)


def slice(x, axes, starts, ends):  # noqa: A001 (paddle name)
    out = x
    for ax, s, e in zip(axes, starts, ends):
        idx = [builtins.slice(None)] * out.dim()
        idx[ax] = builtins.slice(s, builtins.min(e, out.shape[ax]))
        out = out[tuple(idx)]
    return out


def strided_slice(x, axes, starts, ends, strides):
    """Python slicing per axis, negative strides included."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        rng = range(*builtins.slice(s, e, st).indices(out.shape[ax]))
        out = out.index_select(ax, torch.tensor(list(rng), dtype=torch.long,
                                                device=out.device))
    return out


def cast(x, dtype):
    return x.to(to_dtype(dtype))


astype = cast


def masked_select(x, mask):
    return x[mask]


def masked_fill(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = torch.as_tensor(x, device=condition.device)
    return torch.where(condition, x, y)


def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def unbind(x, axis=0):
    return list(torch.unbind(x, axis))


def _pad_index(n, lo, hi, mode, device):
    """Source indices of a dim of size ``n`` padded by (lo, hi) in a
    ``jnp.pad`` mode: ``edge``, ``wrap``, ``reflect`` (no edge repeat) or
    ``symmetric`` (edge repeated), any pad width."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        i = i % (2 * n - 2)
        return torch.where(i >= n, 2 * n - 2 - i, i)
    if mode == "symmetric":
        i = i % (2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    raise ValueError(f"unknown pad mode {mode!r}")


_STAT_MODES = {"maximum": lambda v, d: v.amax(d, keepdim=True),
               "minimum": lambda v, d: v.amin(d, keepdim=True),
               "mean": lambda v, d: _float(v).mean(d, keepdim=True),
               "median": lambda v, d: median(v, d, keepdim=True)}


def _pad_stat(x, d, lo, hi, mode, value):
    """One dim of a ``jnp.pad`` whose pad is built from values: a
    constant, a statistic of the whole dim, or a linear ramp from the
    edge to 0 (``linear_ramp``)."""
    n = x.shape[d]
    if mode in _STAT_MODES:
        fill = _STAT_MODES[mode](x, d).to(x.dtype)
        left = fill.expand(*x.shape[:d], lo, *x.shape[d + 1:])
        right = fill.expand(*x.shape[:d], hi, *x.shape[d + 1:])
    elif mode == "linear_ramp":
        def ramp(edge, w, rev):
            t = torch.arange(w, device=x.device, dtype=torch.float32) / w
            shape = [1] * x.dim()
            shape[d] = w
            t = t.reshape(shape)
            r = (_float(edge) * t).to(x.dtype)
            return r.flip(d) if rev else r
        left = ramp(x.narrow(d, 0, 1), lo, False) if lo else \
            x.narrow(d, 0, 0)
        right = ramp(x.narrow(d, n - 1, 1), hi, True) if hi else \
            x.narrow(d, 0, 0)
    else:
        fill = 0 if mode == "empty" else value
        left = torch.full((*x.shape[:d], lo, *x.shape[d + 1:]), fill,
                          dtype=x.dtype, device=x.device)
        right = torch.full((*x.shape[:d], hi, *x.shape[d + 1:]), fill,
                           dtype=x.dtype, device=x.device)
    return torch.cat([left, x, right], dim=d)


def _pad_pairs(x, pad_width):
    """``pad_width`` as one (lo, hi) pair a dim: Paddle's flat [lo0, hi0,
    lo1, hi1, ...] pads the trailing dims in order (pair 0 on the first
    of them); otherwise ``jnp.pad``'s int, pair or pair-per-dim forms."""
    if isinstance(pad_width, (list, tuple)) and pad_width \
            and isinstance(pad_width[0], (int, np.integer)):
        pairs = [(int(pad_width[i]), int(pad_width[i + 1]))
                 for i in range(0, len(pad_width), 2)]
        return [(0, 0)] * (x.dim() - len(pairs)) + pairs
    arr = np.broadcast_to(np.asarray(pad_width, dtype=np.int64),
                          (x.dim(), 2))
    return [(int(a), int(b)) for a, b in arr]


def pad(x, pad_width, mode="constant", value=0.0):
    """``jnp.pad``'s semantics and mode names (``constant``, ``edge``,
    ``reflect``, ``symmetric``, ``wrap``, ``maximum``, ``minimum``,
    ``mean``, ``median``, ``linear_ramp``, ``empty``): not
    ``torch.nn.functional.pad``'s. A reflect pad wider than the dim
    reflects again, as numpy does."""
    for d, (lo, hi) in enumerate(_pad_pairs(x, pad_width)):
        if not (lo or hi):
            continue
        if mode in ("edge", "wrap", "reflect", "symmetric"):
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
        elif mode in ("constant", "empty", "linear_ramp") \
                or mode in _STAT_MODES:
            x = _pad_stat(x, d, lo, hi, mode, value)
        else:
            raise ValueError(f"unknown pad mode {mode!r}")
    return x


# ------------------------------------------------------------------- math
def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = _promote(x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y):
    return torch.matmul(*_promote(x, y))


bmm = mm


def dot(x, y):
    return torch.sum(x * y, dim=-1)


def einsum(eq, *operands):
    return torch.einsum(eq, *_promote(*operands))


def add(x, y):
    return torch.add(*_promote(x, y))


def subtract(x, y):
    return torch.sub(*_promote(x, y))


def multiply(x, y):
    return torch.mul(*_promote(x, y))


def divide(x, y):
    return torch.true_divide(*_promote(x, y))


def floor_divide(x, y):
    return torch.floor_divide(*_promote(x, y))


def remainder(x, y):
    return torch.remainder(*_promote(x, y))


mod = remainder


def pow(x, y):  # noqa: A001
    return torch.pow(x, y)


def sqrt(x):
    return torch.sqrt(x)


def rsqrt(x):
    return torch.rsqrt(_float(x))


def square(x):
    return torch.square(x)


def abs(x):  # noqa: A001
    return torch.abs(x)


def sign(x):
    return torch.sign(x)


def exp(x):
    return torch.exp(x)


def expm1(x):
    return torch.expm1(x)


def log(x):
    return torch.log(x)


def log2(x):
    return torch.log2(x)


def log10(x):
    return torch.log10(x)


def log1p(x):
    return torch.log1p(x)


def sin(x):
    return torch.sin(x)


def cos(x):
    return torch.cos(x)


def tan(x):
    return torch.tan(x)


def asin(x):
    return torch.asin(x)


def acos(x):
    return torch.acos(x)


def atan(x):
    return torch.atan(x)


def atan2(x, y):
    return torch.atan2(*_promote(x, y))


def sinh(x):
    return torch.sinh(x)


def cosh(x):
    return torch.cosh(x)


def tanh(x):
    return torch.tanh(x)


def erf(x):
    return torch.erf(x)


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def round(x):  # noqa: A001
    """Half to even, as ``jnp.round``."""
    return torch.round(x)


def trunc(x):
    return torch.trunc(x)


def clip(x, min=None, max=None):  # noqa: A002
    return torch.clamp(x, min, max)


def maximum(x, y):
    return torch.maximum(*_promote(x, y))


def minimum(x, y):
    return torch.minimum(*_promote(x, y))


def reciprocal(x):
    return torch.reciprocal(x)


def neg(x):
    return torch.neg(x)


def lerp(x, y, weight):
    return x + weight * (y - x)


def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * matmul(x, y)


def outer(x, y):
    x, y = _promote(x, y)
    return x.reshape(-1)[:, None] * y.reshape(-1)[None, :]


def cross(x, y, axis=-1):
    return torch.linalg.cross(*_promote(x, y), dim=axis)


def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, axis, dtype=to_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim, dtype=to_dtype(dtype))


def logcumsumexp(x, axis=None):
    """Along ``axis`` (0 when None, as the JAX function has it)."""
    return torch.logcumsumexp(_float(x), axis if axis is not None else 0)


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# -------------------------------------------------------------- reduction
def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    return _reduce(torch.sum, x, axis, keepdim, dtype=to_dtype(dtype))


def mean(x, axis=None, keepdim=False):
    return _reduce(torch.mean, _float(x), axis, keepdim)


def max(x, axis=None, keepdim=False):  # noqa: A001
    """Values only, over ``axis`` (None: every dim)."""
    return _reduce(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    return _reduce(torch.amin, x, axis, keepdim)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None):
    dt = to_dtype(dtype)
    if isinstance(axis, (list, tuple)) and len(axis) == 0:
        return x if dt is None else x.to(dt)
    y, keep = _to_last(x, axis)
    return keep(torch.prod(y, -1, dtype=dt), keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    return _reduce(torch.std, _float(x), axis, keepdim,
                   correction=1 if unbiased else 0)


def var(x, axis=None, unbiased=True, keepdim=False):
    return _reduce(torch.var, _float(x), axis, keepdim,
                   correction=1 if unbiased else 0)


def _quantiles(x, q, axis, keepdim, ignore_nan):
    """``jnp.quantile`` / ``nanquantile`` (linear interpolation) of x over
    ``axis``: q a scalar or a 1-D list (a leading dim of the result)."""
    y, keep = _to_last(_float(x), axis)
    qs = torch.as_tensor(q, dtype=y.dtype, device=y.device)
    s = torch.sort(y, dim=-1).values              # NaNs sort last
    nan = torch.isnan(y)
    if ignore_nan:
        n = (~nan).sum(-1, keepdim=True)
    else:
        n = torch.full(y.shape[:-1] + (1,), y.shape[-1], device=y.device)
    pos = qs.reshape(-1, *([1] * y.dim())) * (n - 1).to(y.dtype)
    lo = pos.floor().clamp_min(0)
    hi = pos.ceil().clamp_min(0)
    w = pos - lo
    take = s.expand(qs.numel(), *s.shape)
    a = take.gather(-1, lo.long().expand(qs.numel(), *lo.shape[1:]))
    b = take.gather(-1, hi.long().expand(qs.numel(), *hi.shape[1:]))
    out = (a * (1 - w) + b * w)[..., 0]
    if ignore_nan:
        out = torch.where(n[..., 0] == 0, float("nan"), out)
    else:
        out = torch.where(nan.any(-1), float("nan"), out)
    out = keep(out, keepdim) if qs.dim() == 0 else \
        torch.stack([keep(o, keepdim) for o in out])
    return out[0] if qs.dim() == 0 else out


def median(x, axis=None, keepdim=False):
    """``jnp.median``: an even count averages the two middle values."""
    return _quantiles(x, 0.5, axis, keepdim, False)


def quantile(x, q, axis=None, keepdim=False):
    return _quantiles(x, q, axis, keepdim, False)


def logsumexp(x, axis=None, keepdim=False):
    return _reduce(torch.logsumexp, _float(x), axis, keepdim)


def _bool_reduce(fn, x, axis, keepdim):
    y, keep = _to_last(x.bool(), axis)
    return keep(fn(y, -1), keepdim)


def all(x, axis=None, keepdim=False):  # noqa: A001
    return _bool_reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return _bool_reduce(torch.any, x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False):
    y, keep = _to_last(x != 0, axis)
    return keep(y.sum(-1), keepdim)


# ----------------------------------------------------------------- search
def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(to_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False):
    """Stable: ties keep their order, ascending or descending."""
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    """(values, indices) of the ``k`` largest (smallest) along ``axis``;
    ties go to the lower index, as ``lax.top_k``."""
    idx = torch.argsort(x, dim=axis, descending=largest,
                        stable=True).narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx


def kthvalue(x, k, axis=-1):
    vals = torch.sort(x, dim=axis, stable=True).values.select(axis, k - 1)
    idx = torch.argsort(x, dim=axis, stable=True).select(axis, k - 1)
    return vals, idx


def unique(x, return_index=False, return_inverse=False, return_counts=False):
    """``jnp.unique`` of the flattened x: the sorted values and, asked
    for, the index of each one's first occurrence, the inverse (x's
    shape) and the counts."""
    flat = x.reshape(-1)
    u, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                  return_counts=True)
    res = [u]
    if return_index:
        pos = torch.arange(flat.numel(), device=x.device)
        first = torch.full((u.numel(),), flat.numel(), dtype=torch.long,
                           device=x.device)
        res.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        res.append(inv.reshape(x.shape))
    if return_counts:
        res.append(counts)
    return tuple(res) if len(res) > 1 else u


def nonzero(x, as_tuple=False):
    """[N, ndim] indices of the nonzero entries (a tuple of ndim [N]
    tensors with ``as_tuple``)."""
    return torch.nonzero(x, as_tuple=as_tuple)


def searchsorted(sorted_sequence, values, right=False):
    s, v = _promote(sorted_sequence, values)
    return torch.searchsorted(s, v, right=right)


def bucketize(x, sorted_sequence, right=False):
    return searchsorted(sorted_sequence, x, right=right)


# ------------------------------------------------------------------ logic
def equal(x, y):
    return torch.eq(*_promote(x, y))


def not_equal(x, y):
    return torch.ne(*_promote(x, y))


def greater_than(x, y):
    return torch.gt(*_promote(x, y))


def greater_equal(x, y):
    return torch.ge(*_promote(x, y))


def less_than(x, y):
    return torch.lt(*_promote(x, y))


def less_equal(x, y):
    return torch.le(*_promote(x, y))


def logical_and(x, y):
    return torch.logical_and(x, y)


def logical_or(x, y):
    return torch.logical_or(x, y)


def logical_not(x):
    return torch.logical_not(x)


def logical_xor(x, y):
    return torch.logical_xor(x, y)


def equal_all(x, y):
    """A 0-d bool tensor: same shape and equal everywhere."""
    x, y = _promote(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(*_promote(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


def bitwise_not(x):
    return torch.bitwise_not(x)


def norm(x, p=2, axis=None, keepdim=False):
    """The flat namespace's norm: ``fro`` (or 2 over every dim) is the
    root of the sum of squares; inf the max of |x|; 1 the sum of |x|;
    else (sum |x|^p)^(1/p). (``linalg.norm`` is the full one.)"""
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(sum(torch.square(x), axis=axis, keepdim=keepdim))
    if p == float("inf"):
        return max(torch.abs(x), axis=axis, keepdim=keepdim)
    if p == 1:
        return sum(torch.abs(x), axis=axis, keepdim=keepdim)
    return torch.pow(sum(torch.pow(torch.abs(x), p), axis=axis,
                         keepdim=keepdim), 1.0 / p)


def histogram(x, bins=100, min=0, max=0, weight=None,  # noqa: A002
              density=False):
    """``jnp.histogram``'s counts: ``bins`` equal bins over [min, max]
    (``min == max == 0``: the data's range; an empty range widens by 0.5
    each way), a value on the last edge in the last bin, values outside
    dropped; ``weight`` sums weights, ``density`` normalises by the bin
    width and the total. Edges and ``searchsorted``, as numpy, on any
    device."""
    a = _float(x).reshape(-1)
    w = torch.ones_like(a) if weight is None else \
        _t(weight, a).to(a.device).reshape(-1)
    a, w = _promote(a, w)
    if min == 0 and max == 0:
        lo, hi = a.min(), a.max()
    else:
        lo = torch.as_tensor(min, dtype=a.dtype, device=a.device)
        hi = torch.as_tensor(max, dtype=a.dtype, device=a.device)
    empty_range = hi == lo
    lo = torch.where(empty_range, lo - 0.5, lo)
    hi = torch.where(empty_range, hi + 0.5, hi)
    edges = _linspace(lo, hi, int(bins) + 1, a.dtype, a.device)
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], edges.numel() - 1, idx)
    keep = idx < edges.numel()
    counts = torch.zeros(edges.numel(), dtype=w.dtype, device=a.device)
    counts = counts.index_add(0, torch.where(keep, idx, 0),
                              torch.where(keep, w, 0))[1:]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts


def bincount(x, weights=None, minlength=0):
    x = x.reshape(-1).long()
    n = builtins.max(int(x.max()) + 1 if x.numel() else 0, int(minlength))
    if weights is None:
        w = torch.ones_like(x)
    else:
        w = _t(weights, x).to(x.device).reshape(-1)
    return torch.zeros(n, dtype=w.dtype, device=x.device).index_add(0, x, w)


def one_hot(x, num_classes):
    """float32 one-hot rows; an index outside [0, num_classes) gives a
    row of zeros, as ``jax.nn.one_hot``."""
    return (x[..., None] == torch.arange(num_classes, device=x.device)
            ).to(torch.float32)


def numel(x):
    return x.numel()


def shape(x):
    return list(x.shape)


# ----------------------------------------------------------------- random
def _gen(generator, device):
    if generator is not None:
        return generator
    from .utils.rng import next_generator
    return next_generator(device)


def rand(shape, dtype="float32", generator=None, device=None):
    dev = _dev(device, generator)
    return torch.rand(_shape(shape), generator=_gen(generator, dev),
                      dtype=to_dtype(dtype), device=dev)


def randn(shape, dtype="float32", generator=None, device=None):
    dev = _dev(device, generator)
    return torch.randn(_shape(shape), generator=_gen(generator, dev),
                       dtype=to_dtype(dtype), device=dev)


standard_normal = randn


def randint(low, high=None, shape=(1,), dtype="int64", generator=None,
            device=None):
    if high is None:
        low, high = 0, low
    dev = _dev(device, generator)
    return torch.randint(low, high, _shape(shape),
                         generator=_gen(generator, dev),
                         dtype=to_dtype(dtype), device=dev)


def randperm(n, dtype="int64", generator=None, device=None):
    dev = _dev(device, generator)
    return torch.randperm(n, generator=_gen(generator, dev),
                          dtype=to_dtype(dtype), device=dev)


def normal(mean=0.0, std=1.0, shape=(1,), generator=None,  # noqa: A002
           device=None):
    return mean + std * randn(shape, generator=generator, device=device)


def uniform(shape, dtype="float32", min=-1.0, max=1.0,  # noqa: A002
            generator=None, device=None):
    return min + (max - min) * rand(shape, dtype, generator, device)


def bernoulli(x, generator=None):
    u = torch.rand(x.shape, generator=_gen(generator, x.device),
                   device=x.device)
    return (u < x).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, generator=None):
    """Category indices drawn from unnormalised probabilities [.., k].
    Without replacement it draws by Gumbel top-k and raises when
    ``num_samples`` exceeds the categories of nonzero probability."""
    probs = x.float()
    gen = _gen(generator, x.device)
    if replacement:
        flat = probs.reshape(-1, probs.shape[-1])
        out = torch.multinomial(flat, num_samples, replacement=True,
                                generator=gen)
        return out.reshape(probs.shape[:-1] + (num_samples,))
    n_support = int((probs > 0).sum(-1).min())
    if num_samples > n_support:
        raise ValueError(
            f"multinomial(replacement=False): num_samples={num_samples} "
            f"exceeds the {n_support} categories with non-zero "
            f"probability")
    logits = torch.where(probs > 0, torch.log(probs.clamp_min(1e-30)),
                         float("-inf"))
    u = torch.rand(logits.shape, generator=gen, device=x.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
    return torch.argsort(logits + g, dim=-1, descending=True,
                         stable=True)[..., :num_samples]


def poisson(x, generator=None):
    """Draws of Poisson(x), as float32."""
    return torch.poisson(x.float(), generator=_gen(generator, x.device))


# ------------------------------------------------- manipulation/math (cont.)
def nanmedian(x, axis=None, keepdim=False):
    return _quantiles(x, 0.5, axis, keepdim, True)


def diff(x, n=1, axis=-1, prepend=None, append=None):
    def edge(v):
        if v is None:
            return None
        v = _t(v, x).to(x.device, x.dtype)
        if v.dim() == 0:
            shape = list(x.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v
    return torch.diff(x, n, axis, edge(prepend), edge(append))


def trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def _along(x, index, axis):
    idx = _t(index, x).to(x.device).long()
    n = x.shape[axis]
    return torch.where(idx < 0, idx + n, idx)


def index_add(x, index, axis, value):
    """x with ``value`` rows added at ``index`` along ``axis``."""
    idx = _along(x, index, axis)
    shape = list(x.shape)
    shape[axis] = idx.numel()
    val = _t(value, x).to(x.device, x.dtype).expand(shape)
    return x.index_add(axis, idx.reshape(-1), val)


def index_fill(x, index, axis, value):
    idx = _along(x, index, axis).reshape(-1)
    shape = list(x.shape)
    shape[axis] = idx.numel()
    val = _t(value, x).to(x.device, x.dtype).expand(shape)
    return x.index_copy(axis, idx, val.contiguous())


def masked_scatter(x, mask, value):
    """The True positions of ``mask`` (row-major) filled with consecutive
    elements of ``value``."""
    flat_m = mask.reshape(-1)
    n_true = int(flat_m.sum())
    if value.numel() < n_true:
        raise ValueError(f"masked_scatter: value has {value.numel()} "
                         f"elements but mask selects {n_true}")
    slot = torch.cumsum(flat_m.long(), 0) - 1
    take = slot.clamp(0, builtins.max(value.numel() - 1, 0))
    filled = torch.where(flat_m, value.reshape(-1)[take].to(x.dtype),
                         x.reshape(-1))
    return filled.reshape(x.shape)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def as_strided(x, shape, stride, offset=0):
    """A copy of the strided view of x's flattened values (the JAX
    gather: an index past the end clamps)."""
    flat = x.reshape(-1)
    idx = torch.as_tensor(offset, device=x.device)
    for dim, (s, st) in enumerate(zip(shape, stride)):
        r = torch.arange(s, device=x.device) * st
        idx = idx[..., None] + r.reshape((1,) * dim + (s,))
    return flat[idx.clamp(0, flat.numel() - 1)]


def view(x, shape_or_dtype):
    """A reshape (a list or tuple), or the bits reinterpreted as another
    dtype with the last dim rescaled: a (2, 4) float32 as float16 is (2,
    8), as float64 (2, 2), which needs the last dim to divide."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(shape_or_dtype)
    target = to_dtype(shape_or_dtype)
    inw, outw = x.element_size(), torch.empty((), dtype=target).element_size()
    if outw > inw and x.shape[-1] % (outw // inw):
        raise ValueError(f"view: last dim {x.shape[-1]} not divisible by "
                         f"width ratio {outw // inw} ({x.dtype} -> "
                         f"{target})")
    return x.contiguous().view(target)


def unflatten(x, axis, shape):
    return torch.unflatten(x, axis, tuple(shape))


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def renorm(x, p, axis, max_norm):
    """Each sub-tensor along ``axis`` scaled so its p-norm <= max_norm."""
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp_min(norms, 1e-12),
                         torch.ones_like(norms))
    return x * factor


def inner(x, y):
    return torch.inner(*_promote(x, y))


def cdist(x, y, p=2.0):
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, dim=-1))
    if p == float("inf"):
        return torch.amax(torch.abs(d), dim=-1)
    if p == 0:
        return torch.sum(d != 0, dim=-1).to(x.dtype)
    if p < 0:
        raise ValueError(f"cdist requires p >= 0, got {p}")
    return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)


def block_diag(inputs):
    return torch.block_diag(*_promote(*inputs))


def acosh(x):
    return torch.acosh(x)


def asinh(x):
    return torch.asinh(x)


def atanh(x):
    return torch.atanh(x)


def conj(x):
    return torch.conj_physical(x)


def angle(x):
    return torch.angle(x)


def deg2rad(x):
    return torch.deg2rad(_float(x))


def rad2deg(x):
    return torch.rad2deg(_float(x))


def digamma(x):
    return torch.special.digamma(x)


def lgamma(x):
    return torch.lgamma(x)


def erfinv(x):
    return torch.erfinv(x)


def signbit(x):
    return torch.signbit(x)


def sgn(x):
    """x / |x| for complex x (0 at 0), ``sign`` otherwise."""
    return torch.sgn(x)


def frac(x):
    return x - torch.trunc(x)


def heaviside(x, y):
    return torch.heaviside(*_promote(x, y))


def hypot(x, y):
    return torch.hypot(*_promote(x, y))


def ldexp(x, y):
    return torch.ldexp(_float(x), _t(y, x))


def nextafter(x, y):
    return torch.nextafter(*_promote(x, y))


def logaddexp(x, y):
    return torch.logaddexp(*_promote(x, y))


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def gcd(x, y):
    return torch.gcd(*_promote(x, y))


def lcm(x, y):
    return torch.lcm(*_promote(x, y))


def kron(x, y):
    return torch.kron(*_promote(x, y))


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def t(x):
    if x.dim() > 2:
        raise ValueError(f"paddle.t expects ndim <= 2, got {x.dim()}")
    return x.t() if x.dim() == 2 else x


def mv(x, vec):
    return matmul(x, vec)


def permute(x, *perm):
    if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
        perm = tuple(perm[0])
    return x.permute(perm)


def rank(x):
    return torch.tensor(x.dim(), device=x.device)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def _cum_extreme(x, axis, fn):
    """(values, indices) of a running max / min; on ties the LAST
    occurrence (torch/paddle). A position's index is the last j <= i
    where x[j] equals the running value there."""
    axis %= x.dim()
    v = fn(x, axis).values
    pos = torch.arange(x.shape[axis], device=x.device).reshape(
        [-1 if d == axis else 1 for d in range(x.dim())]).expand(x.shape)
    hit = torch.where(x == v, pos, torch.full_like(pos, -1))
    return v, torch.cummax(hit, axis).values


def cummax(x, axis=-1):
    return _cum_extreme(x, axis, torch.cummax)


def cummin(x, axis=-1):
    return _cum_extreme(x, axis, torch.cummin)


def dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def _np_split(fn):
    def split_(x, num_or_indices):
        arg = num_or_indices if isinstance(num_or_indices, int) \
            else list(num_or_indices)
        return list(fn(x, arg))
    return split_


dsplit = _np_split(torch.dsplit)
hsplit = _np_split(torch.hsplit)
vsplit = _np_split(torch.vsplit)


def fmax(x, y):
    return torch.fmax(*_promote(x, y))


def fmin(x, y):
    return torch.fmin(*_promote(x, y))


def inverse(x):
    return torch.linalg.inv(x)


def logspace(start, stop, num, base=10.0, dtype=None, device=None):
    e = _linspace(start, stop, int(num), None, resolve_device(device))
    out = torch.pow(torch.as_tensor(base, dtype=e.dtype, device=e.device), e)
    return out if dtype is None else out.to(to_dtype(dtype))


def mode(x, axis=-1, keepdim=False):
    """The most frequent value of each slice along ``axis`` (on a count
    tie the largest value) and the last index holding it."""
    axis %= x.dim()
    xm = torch.movedim(x, axis, -1)
    counts = (xm[..., :, None] == xm[..., None, :]).sum(-1)
    n = xm.shape[-1]
    vrank = torch.argsort(torch.argsort(xm, dim=-1, stable=True), dim=-1)
    order = counts.long() * (n + 1) + vrank
    pos = torch.argmax(order, dim=-1)
    vals = torch.gather(xm, -1, pos[..., None])[..., 0]
    is_mode = xm == vals[..., None]
    idx = torch.where(is_mode, torch.arange(n, device=x.device),
                      -1).amax(-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def nansum(x, axis=None, keepdim=False, dtype=None):
    return _reduce(torch.nansum, x, axis, keepdim, dtype=to_dtype(dtype))


def nanmean(x, axis=None, keepdim=False):
    return _reduce(torch.nanmean, _float(x), axis, keepdim)


def index_put(x, indices, value, accumulate=False):
    idx = tuple(_t(i, x).to(x.device) for i in indices)
    val = _t(value, x).to(x.device, x.dtype)
    return x.index_put(idx, val, accumulate=accumulate)


def index_sample(x, index):
    """x [b, n], index [b, k] -> [b, k]: a gather per row."""
    return take_along_axis(x, index, 1)


def scatter_nd(index, updates, shape):
    idx = _t(index, updates).to(updates.device).long()
    out = torch.zeros(_shape(shape), dtype=updates.dtype,
                      device=updates.device)
    parts = tuple(torch.where(idx[..., i] < 0, idx[..., i] + out.shape[i],
                              idx[..., i]) for i in range(idx.shape[-1]))
    return out.index_put(parts, updates, accumulate=True)


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids as shard-local ones; ids outside this shard become
    ``ignore_value``."""
    per = (index_num + nshards - 1) // nshards
    lo = shard_id * per
    ok = (x >= lo) & (x < lo + per)
    return torch.where(ok, x - lo, torch.full_like(x, ignore_value))


def take(x, index, mode="raise"):
    """The flattened x at ``index``: ``wrap`` takes it modulo the size,
    ``clip`` clamps, ``raise`` wraps a negative index once and clamps the
    rest (JAX indexing: nothing raises)."""
    flat = x.reshape(-1)
    n = flat.numel()
    idx = _t(index, x).to(x.device).long()
    if mode == "wrap":
        idx = idx % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        idx = _wrap_clamp(idx, n)
    return flat[idx]


def tensordot(x, y, axes=2):
    return torch.tensordot(*_promote(x, y), dims=axes)


def unfold(x, axis, size, step):
    """Sliding windows along ``axis``, the window dim appended last."""
    return x.unfold(axis % x.dim(), size, step)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Consecutive duplicates collapsed; the inverse is over the flattened
    x when ``axis`` is None, as in the JAX function."""
    out = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not (return_inverse or return_counts):
        return out
    out = list(out)
    if return_inverse and axis is None:
        out[1] = out[1].reshape(-1)
    return tuple(out)


def unstack(x, axis=0, num=None):
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num {num} != size {x.shape[axis]} of "
                         f"axis {axis}")
    return list(torch.unbind(x, axis))


def vander(x, n=None, increasing=False):
    return torch.vander(x, N=n, increasing=increasing)


def polar(abs_, angle_):
    return torch.complex(abs_ * torch.cos(angle_), abs_ * torch.sin(angle_))


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "builtins", "np", "torch",
                         "resolve_device")]
