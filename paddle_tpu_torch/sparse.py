"""paddle.sparse (counterpart of ``paddle_tpu/sparse.py``; reference:
python/paddle/sparse — SparseCooTensor / SparseCsrTensor creation,
conversion, the elementwise, matmul and activation ops).

``SparseCooTensor`` and ``SparseCsrTensor`` wrap ``torch.sparse_coo_tensor``
and ``torch.sparse_csr_tensor``, as the JAX classes wrap BCOO and BCSR.
As there: ``indices`` is [ndim, nnz]; ``nnz`` counts the stored entries,
duplicates included, until ``coalesce`` (BCOO's ``nse``); ``shape=None``
is inferred from the indices; an op on a CSR tensor returns CSR; a
sparse @ dense product is dense. A COO tensor's indices are int64, which
torch requires (``cast``'s ``index_dtype`` applies to CSR ones).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .device import resolve_device
from .dtypes import to_dtype

__all__ = [
    "SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
    "sparse_csr_tensor", "is_same_shape", "add", "subtract", "multiply",
    "divide", "matmul", "masked_matmul", "relu", "tanh", "sqrt", "sin",
    "abs", "pow", "neg", "cast", "transpose", "coalesce",
    "multiply_scalar",
]


class _SparseBase:
    """The surface both formats share, over a torch sparse tensor."""

    def __init__(self, mat):
        self._mat = mat

    @property
    def shape(self):
        return tuple(self._mat.shape)

    @property
    def dtype(self):
        return self._mat.dtype

    @property
    def device(self):
        return self._mat.device

    @property
    def nnz(self) -> int:
        return int(self._mat._nnz())

    def to_dense(self):
        return self._mat.to_dense()

    dense = property(to_dense)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self.shape}, "
                f"nnz={self.nnz}, dtype={self.dtype})")


class SparseCooTensor(_SparseBase):
    """A COO sparse tensor; duplicates stay stored until ``coalesce``."""

    @property
    def indices(self):
        return self._mat._indices()                     # [ndim, nnz]

    @property
    def values(self):
        return self._mat._values()

    def to_sparse_csr(self) -> "SparseCsrTensor":
        """The same stored entries in CSR, duplicates kept (as
        ``BCSR.from_bcoo``), in row-major order."""
        rows, cols = self.indices
        n_rows, n_cols = self.shape
        order = torch.argsort(rows * n_cols + cols, stable=True)
        counts = torch.bincount(rows, minlength=n_rows)
        crows = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return SparseCsrTensor(torch.sparse_csr_tensor(
            crows, cols[order], self.values[order], self.shape))

    def coalesce(self) -> "SparseCooTensor":
        return SparseCooTensor(self._mat.coalesce())


class SparseCsrTensor(_SparseBase):
    """A CSR sparse tensor."""

    @property
    def crows(self):
        return self._mat.crow_indices()

    @property
    def cols(self):
        return self._mat.col_indices()

    @property
    def values(self):
        return self._mat.values()

    def to_sparse_coo(self, sparse_dim: int = 2) -> SparseCooTensor:
        return SparseCooTensor(self._mat.to_sparse_coo())


def _device(place, *xs):
    if place is not None:
        return resolve_device(place)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def sparse_coo_tensor(indices, values, shape: Optional[Sequence[int]] = None,
                      dtype=None, place=None, stop_gradient=True):
    """indices [ndim, nnz] and values [nnz] as a :class:`SparseCooTensor`
    (on ``place``, else the inputs' device, else the card)."""
    dev = _device(place, values, indices)
    indices = torch.as_tensor(indices, device=dev).long()
    values = torch.as_tensor(values, dtype=to_dtype(dtype), device=dev)
    if shape is None:
        shape = tuple(int(i) + 1 for i in indices.amax(dim=1))
    return SparseCooTensor(torch.sparse_coo_tensor(indices, values,
                                                   tuple(shape)))


def sparse_csr_tensor(crows, cols, values, shape: Sequence[int],
                      dtype=None, place=None, stop_gradient=True):
    dev = _device(place, values, cols)
    crows = torch.as_tensor(crows, device=dev).to(torch.int32)
    cols = torch.as_tensor(cols, device=dev).to(torch.int32)
    values = torch.as_tensor(values, dtype=to_dtype(dtype), device=dev)
    return SparseCsrTensor(torch.sparse_csr_tensor(crows, cols, values,
                                                   tuple(shape)))


def _coo(x):
    """The COO tensor of a sparse operand (CSR converts)."""
    m = x._mat
    return m.to_sparse_coo() if m.layout == torch.sparse_csr else m


def _dense(y):
    return y.to_dense() if isinstance(y, _SparseBase) else y


def _rewrap(mat, like):
    """A COO result in the format of the input ``like``."""
    if isinstance(like, SparseCsrTensor):
        return SparseCsrTensor(mat.coalesce().to_sparse_csr())
    return SparseCooTensor(mat)


def _with_values(m, values):
    return torch.sparse_coo_tensor(m._indices(), values, m.shape)


def is_same_shape(x, y) -> bool:
    return tuple(x.shape) == tuple(y.shape)


def add(x, y):
    """sparse + sparse (same shape: the stored entries merged, duplicates
    summed); with a dense operand, dense."""
    if isinstance(x, _SparseBase) and isinstance(y, _SparseBase):
        if not is_same_shape(x, y):
            raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")
        a, b = _coo(x), _coo(y)
        merged = torch.sparse_coo_tensor(
            torch.cat([a._indices(), b._indices()], 1),
            torch.cat([a._values(), b._values()]), a.shape)
        return _rewrap(merged.coalesce(), x)
    return _dense(x) + _dense(y)


def subtract(x, y):
    if isinstance(y, _SparseBase):
        return add(x, multiply_scalar(y, -1.0))
    return _dense(x) - y


def multiply_scalar(x, s: float):
    m = _coo(x)
    return _rewrap(_with_values(m, m._values() * s), x)


def _picked(x, y):
    m = _coo(x)
    return m, _dense(y)[tuple(m._indices())]


def multiply(x, y):
    """Elementwise: y (a scalar, dense or sparse) read at x's entries."""
    if isinstance(y, (int, float)):
        return multiply_scalar(x, float(y))
    m, picked = _picked(x, y)
    return _rewrap(_with_values(m, m._values() * picked), x)


def divide(x, y):
    if isinstance(y, (int, float)):
        return multiply_scalar(x, 1.0 / float(y))
    m, picked = _picked(x, y)
    return _rewrap(_with_values(m, m._values() / picked), x)


def matmul(x, y):
    """sparse @ dense (or sparse) -> dense."""
    a = x._mat if isinstance(x, _SparseBase) else x
    b = y._mat if isinstance(y, _SparseBase) else y
    out = a @ b
    return out.to_dense() if out.layout != torch.strided else out


def masked_matmul(x, y, mask):
    """(x @ y) at ``mask``'s stored entries only (SDDMM): a COO tensor
    with the mask's indices."""
    m = _coo(mask)
    rows, cols = m._indices()[0], m._indices()[1]
    vals = torch.einsum("nk,nk->n", x[rows, :], y[:, cols].T)
    return SparseCooTensor(_with_values(m, vals.to(x.dtype)))


def _value_op(fn, name):
    def op(x):
        m = _coo(x)
        return _rewrap(_with_values(m, fn(m._values())), x)
    op.__name__ = name
    op.__doc__ = f"``{name}`` of the stored values."
    return op


relu = _value_op(lambda v: torch.clamp_min(v, 0), "relu")
tanh = _value_op(torch.tanh, "tanh")
sqrt = _value_op(torch.sqrt, "sqrt")
sin = _value_op(torch.sin, "sin")
abs = _value_op(torch.abs, "abs")  # noqa: A001 (paddle name)
neg = _value_op(torch.neg, "neg")


def pow(x, factor):  # noqa: A001 (paddle name)
    return _value_op(lambda v: torch.pow(v, factor), "pow")(x)


def cast(x, index_dtype=None, value_dtype=None):
    """The values (and a CSR tensor's indices) cast."""
    vt, it = to_dtype(value_dtype), to_dtype(index_dtype)
    if isinstance(x, SparseCsrTensor):
        m = x._mat
        return SparseCsrTensor(torch.sparse_csr_tensor(
            m.crow_indices().to(it or m.crow_indices().dtype),
            m.col_indices().to(it or m.col_indices().dtype),
            m.values().to(vt or m.dtype), m.shape))
    m = _coo(x)
    return SparseCooTensor(_with_values(m, m._values().to(vt or m.dtype)))


def transpose(x, perm: Sequence[int]):
    m = _coo(x)
    perm = list(perm)
    return _rewrap(torch.sparse_coo_tensor(
        m._indices()[perm], m._values(), [m.shape[p] for p in perm]), x)


def coalesce(x: SparseCooTensor) -> SparseCooTensor:
    return x.coalesce()
