"""paddle.linalg (counterpart of ``paddle_tpu/linalg.py``; reference:
python/paddle/tensor/linalg.py).

``torch.linalg`` with Paddle's signatures and the JAX package's quirks:
``norm``'s ``fro`` default, ``matrix_rank``'s absolute ``tol``,
``cholesky_solve``'s (B, L) order, ``lu``'s 1-based pivots (torch's are
1-based already, so nothing is added), ``slogdet`` stacked. Every
function runs on the inputs' device, the card included: ``eig`` runs on
both (``jnp.linalg.eig`` runs only on the CPU), and ``lstsq`` returns
``jnp.linalg.lstsq``'s four outputs from an SVD, since torch's CUDA
``lstsq`` has only the full-rank ``gels`` solver, which gives no rank
and no singular values.
"""
from __future__ import annotations

import torch

__all__ = [
    "matmul", "norm", "cond", "cov", "corrcoef", "cholesky",
    "cholesky_solve", "svd", "svdvals", "qr", "eig", "eigh", "eigvals",
    "eigvalsh", "inv", "pinv", "det", "slogdet", "solve",
    "triangular_solve", "lstsq", "lu", "lu_unpack", "matrix_power",
    "vector_norm", "matrix_norm", "matrix_exp", "solve_triangular",
    "householder_product", "pca_lowrank", "svd_lowrank", "ormqr",
    "matrix_rank", "multi_dot", "matrix_transpose", "dot", "cross",
    "bmm",
]


def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return x @ y


def matrix_transpose(x):
    return x.transpose(-1, -2)


def dot(x, y):
    return torch.sum(x * y, dim=-1)


def cross(x, y, axis=None):
    """Along ``axis``; None means the first axis of length 3 (none is an
    error)."""
    if axis is None:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if axis is None:
            raise ValueError(f"cross: no axis of length 3 in shape "
                             f"{tuple(x.shape)}")
    return torch.linalg.cross(x, y, dim=axis)


def bmm(x, y):
    return torch.matmul(x, y)


def _ord(p):
    return {"fro": "fro", "nuc": "nuc"}.get(p, p) if isinstance(p, str) \
        else p


def norm(x, p=None, axis=None, keepdim=False):
    """p=None: ``fro`` over a matrix (every dim) or 2 for a vector.
    ``axis=None`` reduces every dim; ``keepdim`` then keeps each at 1."""
    if p is None:
        p = "fro" if axis is None and x.dim() >= 2 else 2
    if axis is None:
        out = (torch.sqrt(torch.sum(torch.square(x.abs()))) if p == "fro"
               else torch.linalg.vector_norm(x.reshape(-1), ord=p))
        return out.reshape((1,) * x.dim()) if keepdim else out
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=_ord(p), dim=tuple(axis),
                                        keepdim=keepdim)
    if p == "fro":
        p = 2
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


def cond(x, p=None):
    return torch.linalg.cond(x, p=_ord(p))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = x if rowvar else x.transpose(-1, -2)
    return torch.cov(x, correction=int(bool(ddof)), fweights=fweights,
                     aweights=aweights)


def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False):
    """Solve A X = B given ``y``, the Cholesky factor of A (Paddle's
    argument order: B, then the factor)."""
    return torch.cholesky_solve(x, y, upper=upper)


def svd(x, full_matrices=False):
    """(U, S, Vh), as ``jnp.linalg.svd``."""
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def svdvals(x):
    return torch.linalg.svdvals(x)


def qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r").R
    return tuple(torch.linalg.qr(x, mode=mode))


def eig(x):
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvals(x):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def inv(x):
    return torch.linalg.inv(x)


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def det(x):
    return torch.linalg.det(x)


def slogdet(x):
    """[sign, log|det|] stacked, as Paddle returns them."""
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def solve(x, y):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """Solve op(x) out = y for triangular x (op the transpose when
    ``transpose``)."""
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


solve_triangular = triangular_solve


def lstsq(x, y, rcond=None, driver=None):
    """(solution, residuals, rank, singular_values) of min ||x s - y||, as
    ``jnp.linalg.lstsq`` forms them through the SVD: the singular values
    that are positive and at least ``rcond`` (None: eps * max(m, n))
    times the largest count; the residuals are the squared norms of each
    column's misfit ([1] for a vector ``y``), always returned. On any
    device; the LAPACK routine is not selectable (the last argument is
    Paddle's and is not read)."""
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(s.dtype).eps
    mask = (s > 0) & (s >= rcond * s[..., :1])
    safe = torch.where(mask, s, torch.ones_like(s)).to(x.dtype)
    inv_s = torch.where(mask, 1 / safe, torch.zeros_like(safe))
    uTb = u.transpose(-1, -2).conj() @ b
    sol = vh.transpose(-1, -2).conj() @ (inv_s[..., None] * uTb)
    resid = torch.linalg.vector_norm(b - x @ sol, dim=-2) ** 2
    if vec:
        sol = sol[:, 0]
    return sol, resid, mask.sum(-1), s


def lu(x, pivot=True):
    """(LU, pivots): the packed factors and LAPACK's 1-based pivots
    (``torch.linalg.lu_factor``'s are 1-based already)."""
    lu_mat, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_mat, piv


def lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) from :func:`lu`'s factors: ``P @ L @ U`` is the matrix;
    P replays the pivots' row swaps."""
    P, L, U = torch.lu_unpack(lu_mat, pivots.to(torch.int32))
    return P, L, U


def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False):
    """Paddle's ``tol`` is an ABSOLUTE threshold on the singular values
    (eigenvalue magnitudes when ``hermitian``), one a matrix of a batch;
    None means max(sv) * max(m, n) * eps."""
    sv = (torch.linalg.eigvalsh(x).abs() if hermitian
          else torch.linalg.svdvals(x))
    if tol is None:
        eps = torch.finfo(sv.dtype).eps
        thresh = sv.amax(-1, keepdim=True) * max(x.shape[-2:]) * eps
    else:
        thresh = torch.as_tensor(tol, dtype=sv.dtype, device=sv.device)
        if thresh.dim():
            thresh = thresh[..., None]
    return (sv > thresh).sum(-1)


def multi_dot(mats):
    return torch.linalg.multi_dot(list(mats))


def vector_norm(x, p=2.0, axis=None, keepdim=False):
    if p == float("inf"):
        return torch.amax(x.abs(), dim=axis, keepdim=keepdim) \
            if axis is not None else x.abs().amax()
    if p == float("-inf"):
        return torch.amin(x.abs(), dim=axis, keepdim=keepdim) \
            if axis is not None else x.abs().amin()
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(x.abs() ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=_ord(p), dim=tuple(axis),
                                    keepdim=keepdim)


def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


def _apply_reflectors(a, tau, y, adjoint):
    """Q (adjoint=False) or Q^H (adjoint=True) of geqrf's reflectors H_i =
    I - tau_i v_i v_i^H applied to y [m, cols], never forming Q."""
    m = a.shape[0]
    k = tau.shape[0]
    rows = torch.arange(m, device=a.device)
    order = range(k) if adjoint else range(k - 1, -1, -1)
    for i in order:
        v = torch.where(rows == i, torch.ones_like(a[:, i]),
                        torch.where(rows > i, a[:, i],
                                    torch.zeros_like(a[:, i])))
        t = tau[i].conj() if adjoint else tau[i]
        y = y - t * v[:, None] * (v.conj() @ y)[None, :]
    return y


def householder_product(x, tau):
    """Q's first n columns from geqrf's reflectors, Q = H_0 ... H_{k-1}."""
    m, n = x.shape[-2], x.shape[-1]
    eye = torch.eye(m, n, dtype=x.dtype, device=x.device)
    if x.dim() == 2:
        return _apply_reflectors(x, tau, eye, adjoint=False)
    flat = [_apply_reflectors(a, t, eye, adjoint=False)
            for a, t in zip(x.reshape(-1, m, n),
                            tau.reshape(-1, tau.shape[-1]))]
    return torch.stack(flat).reshape(x.shape[:-2] + (m, n))


# the range finder's draw is fixed, as the JAX function's key is
_PCA_SEED = 0


def pca_lowrank(x, q=None, center=True, niter=2):
    """Randomized PCA (Halko et al. 2011 subspace iteration, QR
    re-orthonormalized every step): (U, S, V). The range finder's draw
    comes from a generator with a fixed seed, as the JAX function's key
    is fixed; the result does not depend on it where x's rank is <= q."""
    m, n = x.shape[-2], x.shape[-1]
    q = q if q is not None else min(6, m, n)
    a = x - x.mean(dim=-2, keepdim=True) if center else x
    a_h = a.transpose(-1, -2).conj()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(_PCA_SEED)
    omega = torch.randn((n, q), generator=gen, device=x.device,
                        dtype=a.dtype)
    y = torch.linalg.qr(a @ omega).Q
    for _ in range(niter):
        z = torch.linalg.qr(a_h @ y).Q
        y = torch.linalg.qr(a @ z).Q
    b = y.transpose(-1, -2).conj() @ a
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    return y @ u_b, s, vt.transpose(-1, -2).conj()


def svd_lowrank(x, q=6, niter=2):
    return pca_lowrank(x, q=q, center=False, niter=niter)


def ormqr(x, tau, y, left=True, transpose=False):
    """y multiplied by Q (Q^H with ``transpose``) from geqrf's reflectors,
    on the left or the right, without forming Q."""
    if left:
        return _apply_reflectors(x, tau, y, adjoint=transpose)
    yh = y.transpose(-1, -2).conj()
    out = _apply_reflectors(x, tau, yh, adjoint=not transpose)
    return out.transpose(-1, -2).conj()
