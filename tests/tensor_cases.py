"""Inputs for the tensor-level API's sweeps, free of JAX: the CPU tests
(``tests/test_torch_tensor.py``, ``test_torch_linalg_fft.py``,
``test_torch_sparse_distribution.py``) run each case through the JAX
function and the port's, and ``chip_smoke.py``'s ``[tensor]`` phase
runs each through the port on the card and on the CPU.

A case's tensor arguments are :class:`T`-wrapped numpy arrays (from
seeds); every other argument is passed as it is. ``port_kw`` are the
port's own keywords (``device`` for a creation function).
"""
import numpy as np

RTOL, ATOL = 1e-5, 1e-6
RTOL_SPECIAL = 2e-5          # lgamma, digamma, erfinv, the hyperbolics


class T:
    """A tensor argument: a jnp array for JAX, a CPU tensor for the port."""

    def __init__(self, a):
        self.a = np.asarray(a)



rs = np.random.RandomState(0)
F32 = np.float32
x = rs.randn(3, 4).astype(F32)
y = rs.randn(3, 4).astype(F32)
pos = (rs.rand(3, 4) + 0.5).astype(F32)
unit = rs.uniform(-0.9, 0.9, (3, 4)).astype(F32)
ii = rs.randint(-5, 6, (3, 4)).astype(np.int32)
ipos = rs.randint(1, 9, (3, 4)).astype(np.int32)
b = x > 0
v = rs.randn(4).astype(F32)
m = (rs.randn(4, 4) + 4 * np.eye(4)).astype(F32)
x3 = rs.randn(2, 3, 4).astype(F32)
nans = x.copy()
nans[0, 1] = nans[2, 3] = np.nan
ties = np.array([[1., 3., 3., 2., 3.], [0., 0., 5., 5., 1.]], F32)
cplx = (rs.randn(3, 4) + 1j * rs.randn(3, 4)).astype(np.complex64)
small = rs.randint(0, 4, (3, 5)).astype(np.int32)
idx = np.array([[1, 0, 3], [2, 2, 0], [3, 1, 1]], np.int32)
six = rs.randn(6, 2).astype(F32)
INF = float("inf")
CPU = {"device": "cpu"}

# (case id, function, args, kwargs, port-only kwargs, rtol)
TENSOR_CASES = (
    # creation
    ("to_tensor-list", "to_tensor", ([1, 2, 3],), {}, CPU, RTOL),
    ("to_tensor-array", "to_tensor", (x,), {}, CPU, RTOL),
    ("zeros", "zeros", ([2, 3],), {}, CPU, RTOL),
    ("ones-int32", "ones", ((2, 3), "int32"), {}, CPU, RTOL),
    ("full", "full", ([2, 2], 3.5), {}, CPU, RTOL),
    ("zeros_like", "zeros_like", (T(x),), {}, {}, RTOL),
    ("ones_like", "ones_like", (T(x), "int32"), {}, {}, RTOL),
    ("full_like", "full_like", (T(x), 2.0), {}, {}, RTOL),
    ("arange", "arange", (5,), {}, CPU, RTOL),
    ("arange-step", "arange", (1, 10, 2), {}, CPU, RTOL),
    ("arange-float", "arange", (0.0, 1.0, 0.25), {}, CPU, RTOL),
    ("linspace", "linspace", (0, 1, 7), {}, CPU, RTOL),
    ("eye", "eye", (3, 4), {}, CPU, RTOL),
    ("empty", "empty", ([2, 2],), {}, CPU, RTOL),
    ("tril", "tril", (T(m),), {}, {}, RTOL),
    ("triu", "triu", (T(m), 1), {}, {}, RTOL),
    ("diag-vector", "diag", (T(v),), {}, {}, RTOL),
    ("diag-matrix", "diag", (T(m), 1), {}, {}, RTOL),
    ("meshgrid", "meshgrid", (T(v[:3]), T(v)), {}, {}, RTOL),
    ("clone", "clone", (T(x),), {}, {}, RTOL),
    ("numpy", "numpy", (T(x),), {}, {}, RTOL),
    # manipulation
    ("reshape", "reshape", (T(x), [4, 3]), {}, {}, RTOL),
    ("transpose", "transpose", (T(x3), [2, 0, 1]), {}, {}, RTOL),
    ("concat", "concat", ([T(x), T(y)], 1), {}, {}, RTOL),
    ("stack", "stack", ([T(x), T(y)],), {}, {}, RTOL),
    ("split-sections", "split", (T(x), [1, -1, 1]), {"axis": 1}, {}, RTOL),
    ("squeeze-axis", "squeeze", (T(x[None, :, None]), 0), {}, {}, RTOL),
    ("squeeze-all", "squeeze", (T(x[None, :, None]),), {}, {}, RTOL),
    ("unsqueeze", "unsqueeze", (T(x), (0, 3)), {}, {}, RTOL),
    ("expand", "expand", (T(v), [3, 4]), {}, {}, RTOL),
    ("expand-keep", "expand", (T(x[:, :1]), [2, -1, 4]), {}, {}, RTOL),
    ("expand_as", "expand_as", (T(v), T(x)), {}, {}, RTOL),
    ("broadcast_to", "broadcast_to", (T(v), [2, 4]), {}, {}, RTOL),
    ("tile", "tile", (T(v), [2, 1]), {}, {}, RTOL),
    ("flatten", "flatten", (T(x3), 1), {}, {}, RTOL),
    ("roll", "roll", (T(x), 1, 1), {}, {}, RTOL),
    ("roll-flat", "roll", (T(x), 2), {}, {}, RTOL),
    ("flip", "flip", (T(x), [0, 1]), {}, {}, RTOL),
    ("gather-axis1", "gather", (T(x), T(np.array([2, 0, -1]))), {"axis": 1},
     {}, RTOL),
    ("index_select", "index_select", (T(x), T(np.array([1, 0]))), {}, {},
     RTOL),
    ("gather_nd", "gather_nd", (T(x), T(np.array([[0, 1], [5, -1],
                                                  [-7, 2]]))), {}, {}, RTOL),
    ("take_along_axis", "take_along_axis", (T(x), T(idx), 1), {}, {}, RTOL),
    ("put_along_axis", "put_along_axis", (T(x), T(idx[:, :1]), 9.0, 1), {},
     {}, RTOL),
    ("scatter-set", "scatter", (T(x), T(np.array([2, 0])), T(y[:2])), {},
     {}, RTOL),
    ("slice", "slice", (T(x3), [1, 2], [0, 1], [2, 100]), {}, {}, RTOL),
    ("strided_slice", "strided_slice", (T(x3), [2, 0], [3, 0], [0, 2],
                                        [-1, 1]), {}, {}, RTOL),
    ("cast", "cast", (T(x * 3), "int32"), {}, {}, RTOL),
    ("astype", "astype", (T(x), "float16"), {}, {}, RTOL),
    ("masked_select", "masked_select", (T(x), T(b)), {}, {}, RTOL),
    ("masked_fill", "masked_fill", (T(x), T(b), 0.5), {}, {}, RTOL),
    ("where", "where", (T(b), T(x), T(y)), {}, {}, RTOL),
    ("where-indices", "where", (T(b),), {}, {}, RTOL),
    ("repeat_interleave", "repeat_interleave", (T(x), 2, 1), {}, {}, RTOL),
    ("repeat_interleave-flat", "repeat_interleave", (T(x), 2), {}, {}, RTOL),
    ("unbind", "unbind", (T(x), 1), {}, {}, RTOL),
    ("pad-flat", "pad", (T(x), [1, 2]), {}, {}, RTOL),
    ("pad-value", "pad", (T(x), [1, 0, 0, 2]), {"value": 3.0}, {}, RTOL),
    ("pad-reflect", "pad", (T(x), [(1, 1), (2, 0)], "reflect"), {}, {}, RTOL),
    ("pad-reflect-wide", "pad", (T(v), [(9, 7)], "reflect"), {}, {}, RTOL),
    ("pad-symmetric", "pad", (T(x), [(2, 1), (5, 3)], "symmetric"), {}, {},
     RTOL),
    ("pad-wrap", "pad", (T(x), [(0, 0), (3, 6)], "wrap"), {}, {}, RTOL),
    ("pad-edge", "pad", (T(x), 2, "edge"), {}, {}, RTOL),
    ("pad-maximum", "pad", (T(x), [(1, 1), (0, 2)], "maximum"), {}, {}, RTOL),
    ("pad-mean", "pad", (T(x), [(1, 0), (2, 2)], "mean"), {}, {}, RTOL),
    ("pad-median", "pad", (T(x), [(1, 2), (1, 0)], "median"), {}, {}, RTOL),
    ("pad-minimum", "pad", (T(x), 1, "minimum"), {}, {}, RTOL),
    ("pad-linear_ramp", "pad", (T(x), [(3, 1), (2, 2)], "linear_ramp"), {},
     {}, RTOL),
    # math
    ("matmul", "matmul", (T(x), T(y)), {"transpose_y": True}, {}, RTOL),
    ("mm", "mm", (T(x), T(m)), {}, {}, RTOL),
    ("bmm", "bmm", (T(x3), T(rs.randn(2, 4, 5).astype(F32))), {}, {}, RTOL),
    ("dot", "dot", (T(x), T(y)), {}, {}, RTOL),
    ("einsum", "einsum", ("ij,kj->ik", T(x), T(y)), {}, {}, RTOL),
    ("add", "add", (T(x), T(y)), {}, {}, RTOL),
    ("subtract", "subtract", (T(x), T(y)), {}, {}, RTOL),
    ("multiply", "multiply", (T(x), T(y)), {}, {}, RTOL),
    ("divide", "divide", (T(x), T(pos)), {}, {}, RTOL),
    ("divide-int", "divide", (T(ii), T(ipos)), {}, {}, RTOL),
    ("floor_divide", "floor_divide", (T(ii), T(ipos)), {}, {}, RTOL),
    ("remainder", "remainder", (T(ii), T(ipos)), {}, {}, RTOL),
    ("mod", "mod", (T(x), T(pos)), {}, {}, RTOL),
    ("pow", "pow", (T(pos), 1.5), {}, {}, RTOL),
    ("sqrt", "sqrt", (T(pos),), {}, {}, RTOL),
    ("rsqrt", "rsqrt", (T(pos),), {}, {}, RTOL),
    ("square", "square", (T(x),), {}, {}, RTOL),
    ("abs", "abs", (T(x),), {}, {}, RTOL),
    ("sign", "sign", (T(x),), {}, {}, RTOL),
    ("exp", "exp", (T(x),), {}, {}, RTOL),
    ("expm1", "expm1", (T(x),), {}, {}, RTOL),
    ("log", "log", (T(pos),), {}, {}, RTOL),
    ("log2", "log2", (T(pos),), {}, {}, RTOL),
    ("log10", "log10", (T(pos),), {}, {}, RTOL),
    ("log1p", "log1p", (T(pos),), {}, {}, RTOL),
    ("sin", "sin", (T(x),), {}, {}, RTOL),
    ("cos", "cos", (T(x),), {}, {}, RTOL),
    ("tan", "tan", (T(unit),), {}, {}, RTOL),
    ("asin", "asin", (T(unit),), {}, {}, RTOL),
    ("acos", "acos", (T(unit),), {}, {}, RTOL),
    ("atan", "atan", (T(x),), {}, {}, RTOL),
    ("atan2", "atan2", (T(x), T(y)), {}, {}, RTOL),
    ("sinh", "sinh", (T(x),), {}, {}, RTOL_SPECIAL),
    ("cosh", "cosh", (T(x),), {}, {}, RTOL_SPECIAL),
    ("tanh", "tanh", (T(x),), {}, {}, RTOL_SPECIAL),
    ("erf", "erf", (T(x),), {}, {}, RTOL_SPECIAL),
    ("floor", "floor", (T(x * 3),), {}, {}, RTOL),
    ("ceil", "ceil", (T(x * 3),), {}, {}, RTOL),
    ("round-half-even", "round", (T(np.array([0.5, 1.5, 2.5, -0.5, -1.5,
                                               0.49], F32)),), {}, {}, RTOL),
    ("trunc", "trunc", (T(x * 3),), {}, {}, RTOL),
    ("clip", "clip", (T(x), -0.5, 0.5), {}, {}, RTOL),
    ("maximum", "maximum", (T(x), T(y)), {}, {}, RTOL),
    ("minimum", "minimum", (T(x), T(y)), {}, {}, RTOL),
    ("reciprocal", "reciprocal", (T(pos),), {}, {}, RTOL),
    ("neg", "neg", (T(x),), {}, {}, RTOL),
    ("lerp", "lerp", (T(x), T(y), 0.3), {}, {}, RTOL),
    ("addmm", "addmm", (T(m), T(m), T(m), 0.5, 2.0), {}, {}, RTOL),
    ("outer", "outer", (T(v), T(x)), {}, {}, RTOL),
    ("cross", "cross", (T(rs.randn(4, 3).astype(F32)),
                        T(rs.randn(4, 3).astype(F32))), {}, {}, RTOL),
    ("cumsum", "cumsum", (T(x), 1), {}, {}, RTOL),
    ("cumsum-flat", "cumsum", (T(x),), {}, {}, RTOL),
    ("cumsum-int", "cumsum", (T(ii), 0), {}, {}, RTOL),
    ("cumprod", "cumprod", (T(x), 1), {}, {}, RTOL),
    ("logcumsumexp", "logcumsumexp", (T(x), 1), {}, {}, RTOL),
    ("logcumsumexp-axis0", "logcumsumexp", (T(x),), {}, {}, RTOL),
    ("isnan", "isnan", (T(nans),), {}, {}, RTOL),
    ("isinf", "isinf", (T(np.array([1., INF, -INF], F32)),), {}, {}, RTOL),
    ("isfinite", "isfinite", (T(nans),), {}, {}, RTOL),
    ("nan_to_num", "nan_to_num", (T(np.array([np.nan, INF, -INF, 1.],
                                              F32)),), {}, {}, RTOL),
    # reductions
    ("sum", "sum", (T(x),), {}, {}, RTOL),
    ("sum-axis-keepdim", "sum", (T(x), 1), {"keepdim": True}, {}, RTOL),
    ("sum-axes", "sum", (T(x3), (0, 2)), {}, {}, RTOL),
    ("sum-bool", "sum", (T(b),), {}, {}, RTOL),
    ("mean", "mean", (T(x), 0), {}, {}, RTOL),
    ("mean-int", "mean", (T(ii),), {}, {}, RTOL),
    ("max", "max", (T(x), 1), {}, {}, RTOL),
    ("min", "min", (T(x),), {}, {}, RTOL),
    ("max-keepdim", "max", (T(x),), {"keepdim": True}, {}, RTOL),
    ("prod", "prod", (T(x), [0, 1]), {}, {}, RTOL),
    ("prod-keepdim", "prod", (T(x3), 1), {"keepdim": True}, {}, RTOL),
    ("std", "std", (T(x), 1), {}, {}, RTOL),
    ("var-biased", "var", (T(x),), {"unbiased": False}, {}, RTOL),
    ("median-axis", "median", (T(x), 1), {}, {}, RTOL),
    ("median-keepdim", "median", (T(x3), 2), {"keepdim": True}, {}, RTOL),
    ("median-nan", "median", (T(nans), 1), {}, {}, RTOL),
    ("quantile", "quantile", (T(x), 0.3, 1), {}, {}, RTOL),
    ("quantile-list", "quantile", (T(x), T(np.array([0.1, 0.9], F32))), {},
     {}, RTOL),
    ("logsumexp", "logsumexp", (T(x), 1), {}, {}, RTOL),
    ("amax", "amax", (T(x3), (0, 1)), {}, {}, RTOL),
    ("amin", "amin", (T(x), 0), {}, {}, RTOL),
    ("all", "all", (T(b), 1), {}, {}, RTOL),
    ("any", "any", (T(b),), {}, {}, RTOL),
    ("any-keepdim", "any", (T(b), 0), {"keepdim": True}, {}, RTOL),
    ("count_nonzero", "count_nonzero", (T(ii), 1), {}, {}, RTOL),
    # search
    ("argmax", "argmax", (T(x), 1), {}, {}, RTOL),
    ("argmax-flat", "argmax", (T(x),), {}, {}, RTOL),
    ("argmin-keepdim", "argmin", (T(x), 0), {"keepdim": True}, {}, RTOL),
    ("argsort", "argsort", (T(ties),), {}, {}, RTOL),
    ("argsort-descending", "argsort", (T(ties),), {"descending": True}, {},
     RTOL),
    ("sort", "sort", (T(x), 1, True), {}, {}, RTOL),
    ("topk", "topk", (T(ties), 2), {}, {}, RTOL),
    ("topk-smallest-axis0", "topk", (T(x), 2), {"axis": 0, "largest": False},
     {}, RTOL),
    ("kthvalue", "kthvalue", (T(x), 2, 1), {}, {}, RTOL),
    ("unique", "unique", (T(small),), {}, {}, RTOL),
    ("unique-all", "unique", (T(small), True, True, True), {}, {}, RTOL),
    ("nonzero", "nonzero", (T(b),), {}, {}, RTOL),
    ("nonzero-tuple", "nonzero", (T(b), True), {}, {}, RTOL),
    ("searchsorted", "searchsorted", (T(np.sort(v)), T(x)), {}, {}, RTOL),
    ("searchsorted-right", "searchsorted", (T(np.array([1., 2., 2., 3.],
                                                       F32)),
                                            T(np.array([2., 0., 3.5], F32))),
     {"right": True}, {}, RTOL),
    ("bucketize", "bucketize", (T(x), T(np.sort(v))), {}, {}, RTOL),
    # logic
    ("equal", "equal", (T(small), T(small.T[:3, :3].repeat(2, 1)[:, :5])),
     {}, {}, RTOL),
    ("not_equal", "not_equal", (T(x), T(y)), {}, {}, RTOL),
    ("greater_than", "greater_than", (T(x), T(y)), {}, {}, RTOL),
    ("greater_equal", "greater_equal", (T(ii), T(ipos)), {}, {}, RTOL),
    ("less_than", "less_than", (T(x), 0.0), {}, {}, RTOL),
    ("less_equal", "less_equal", (T(ii), T(ipos)), {}, {}, RTOL),
    ("logical_and", "logical_and", (T(b), T(x > 0.5)), {}, {}, RTOL),
    ("logical_or", "logical_or", (T(b), T(x > 0.5)), {}, {}, RTOL),
    ("logical_not", "logical_not", (T(b),), {}, {}, RTOL),
    ("logical_xor", "logical_xor", (T(b), T(y > 0)), {}, {}, RTOL),
    ("equal_all", "equal_all", (T(x), T(x.copy())), {}, {}, RTOL),
    ("equal_all-shape", "equal_all", (T(x), T(x[:2])), {}, {}, RTOL),
    ("allclose", "allclose", (T(x), T(x + 1e-7)), {}, {}, RTOL),
    ("isclose", "isclose", (T(x), T(y)), {"atol": 0.5}, {}, RTOL),
    ("bitwise_and", "bitwise_and", (T(ii), T(ipos)), {}, {}, RTOL),
    ("bitwise_or", "bitwise_or", (T(ii), T(ipos)), {}, {}, RTOL),
    ("bitwise_xor", "bitwise_xor", (T(ii), T(ipos)), {}, {}, RTOL),
    ("bitwise_not", "bitwise_not", (T(ii),), {}, {}, RTOL),
    ("norm", "norm", (T(x),), {}, {}, RTOL),
    ("norm-1", "norm", (T(x), 1, 1), {}, {}, RTOL),
    ("norm-inf", "norm", (T(x), INF, 0), {}, {}, RTOL),
    ("norm-3", "norm", (T(x), 3, 1), {}, {}, RTOL),
    ("norm-fro", "norm", (T(x3), "fro", (1, 2)), {}, {}, RTOL),
    ("histogram", "histogram", (T(x),), {"bins": 5}, {}, RTOL),
    ("histogram-weights-density", "histogram", (T(x), 4, -1, 1),
     {"weight": T(pos), "density": True}, {}, RTOL),
    ("histogram-empty-range", "histogram", (T(x), 3, 0.5, 0.5), {}, {}, RTOL),
    ("bincount", "bincount", (T(small.reshape(-1)),), {}, {}, RTOL),
    ("bincount-weights", "bincount", (T(small.reshape(-1)),),
     {"weights": T(np.linspace(0.5, 2, 15, dtype=F32)), "minlength": 7}, {},
     RTOL),
    ("one_hot", "one_hot", (T(np.array([-1, 0, 3, 4, 2])), 4), {}, {}, RTOL),
    ("numel", "numel", (T(x3),), {}, {}, RTOL),
    ("shape", "shape", (T(x3),), {}, {}, RTOL),
    # manipulation / math (cont.)
    ("nanmedian", "nanmedian", (T(nans), 1), {}, {}, RTOL),
    ("nanmedian-all", "nanmedian", (T(nans),), {}, {}, RTOL),
    ("diff", "diff", (T(x),), {}, {}, RTOL),
    ("diff-prepend", "diff", (T(x), 2, 0), {"prepend": T(y[:1])}, {}, RTOL),
    ("trapezoid", "trapezoid", (T(x),), {"dx": 0.5}, {}, RTOL),
    ("trapezoid-x", "trapezoid", (T(x),), {"x": T(np.cumsum(pos, 1))}, {},
     RTOL),
    ("index_add", "index_add", (T(x), T(np.array([0, 2, 0])), 1,
                                T(y[:, :3])), {}, {}, RTOL),
    ("index_fill", "index_fill", (T(x), T(np.array([1, -1])), 0, 7.0), {}, {},
     RTOL),
    ("masked_scatter", "masked_scatter", (T(x), T(b), T(rs.randn(12)
                                                        .astype(F32))), {},
     {}, RTOL),
    ("diag_embed", "diag_embed", (T(x),), {}, {}, RTOL),
    ("diag_embed-offset", "diag_embed", (T(v), 1), {}, {}, RTOL),
    ("diagflat", "diagflat", (T(v), -1), {}, {}, RTOL),
    ("rot90", "rot90", (T(x),), {}, {}, RTOL),
    ("rot90-axes", "rot90", (T(x3), 2, (1, 2)), {}, {}, RTOL),
    ("as_strided", "as_strided", (T(x), [2, 2], [4, 1], 1), {}, {}, RTOL),
    ("view-shape", "view", (T(x), [2, 6]), {}, {}, RTOL),
    ("view-narrower", "view", (T(x), "float16"), {}, {}, RTOL),
    ("view-same-width", "view", (T(x), "int32"), {}, {}, RTOL),
    ("view-wider", "view", (T(x.astype(np.float16)), "float32"), {}, {},
     RTOL),
    ("unflatten", "unflatten", (T(x), 1, [2, 2]), {}, {}, RTOL),
    ("moveaxis", "moveaxis", (T(x3), 0, -1), {}, {}, RTOL),
    ("renorm", "renorm", (T(x), 2, 0, 1.0), {}, {}, RTOL),
    ("inner", "inner", (T(x), T(y)), {}, {}, RTOL),
    ("cdist", "cdist", (T(x), T(y)), {}, {}, RTOL),
    ("cdist-inf", "cdist", (T(x), T(y), INF), {}, {}, RTOL),
    ("cdist-0", "cdist", (T(x), T(y), 0), {}, {}, RTOL),
    ("cdist-1.5", "cdist", (T(x), T(y), 1.5), {}, {}, RTOL),
    ("block_diag", "block_diag", ([T(m), T(x)],), {}, {}, RTOL),
    ("acosh", "acosh", (T(pos + 1),), {}, {}, RTOL_SPECIAL),
    ("asinh", "asinh", (T(x),), {}, {}, RTOL_SPECIAL),
    ("atanh", "atanh", (T(unit),), {}, {}, RTOL_SPECIAL),
    ("conj", "conj", (T(cplx),), {}, {}, RTOL),
    ("angle", "angle", (T(cplx),), {}, {}, RTOL),
    ("deg2rad", "deg2rad", (T(x * 90),), {}, {}, RTOL),
    ("rad2deg", "rad2deg", (T(x),), {}, {}, RTOL),
    ("digamma", "digamma", (T(pos),), {}, {}, RTOL_SPECIAL),
    ("lgamma", "lgamma", (T(pos * 3),), {}, {}, RTOL_SPECIAL),
    ("erfinv", "erfinv", (T(unit),), {}, {}, RTOL_SPECIAL),
    ("signbit", "signbit", (T(np.array([-0.0, 0.0, -1.0, 2.0], F32)),), {},
     {}, RTOL),
    ("sgn-complex", "sgn", (T(np.array([0j, 3 + 4j, -2j], np.complex64)),),
     {}, {}, RTOL),
    ("sgn-real", "sgn", (T(x),), {}, {}, RTOL),
    ("frac", "frac", (T(x * 3),), {}, {}, RTOL),
    ("heaviside", "heaviside", (T(np.array([-1., 0., 2.], F32)),
                                T(np.array([0.5, 0.5, 0.5], F32))), {}, {},
     RTOL),
    ("hypot", "hypot", (T(x), T(y)), {}, {}, RTOL),
    ("ldexp", "ldexp", (T(x), T(ii)), {}, {}, RTOL),
    ("nextafter", "nextafter", (T(x), T(y)), {}, {}, 0.0),
    ("logaddexp", "logaddexp", (T(x), T(y)), {}, {}, RTOL),
    ("logit", "logit", (T(rs.rand(3, 4).astype(F32)),), {}, {}, RTOL),
    ("logit-eps", "logit", (T(np.array([0., 0.5, 1.], F32)),), {"eps": 0.1},
     {}, RTOL),
    ("gcd", "gcd", (T(ii), T(ipos)), {}, {}, RTOL),
    ("lcm", "lcm", (T(ii), T(ipos)), {}, {}, RTOL),
    ("kron", "kron", (T(m[:2, :2]), T(x)), {}, {}, RTOL),
    ("trace", "trace", (T(m),), {}, {}, RTOL),
    ("trace-axes", "trace", (T(x3), 1, 1, 2), {}, {}, RTOL),
    ("t", "t", (T(x),), {}, {}, RTOL),
    ("t-vector", "t", (T(v),), {}, {}, RTOL),
    ("mv", "mv", (T(m), T(v)), {}, {}, RTOL),
    ("permute", "permute", (T(x3), 2, 0, 1), {}, {}, RTOL),
    ("permute-list", "permute", (T(x3), [1, 0, 2]), {}, {}, RTOL),
    ("rank", "rank", (T(x3),), {}, {}, RTOL),
    ("diagonal", "diagonal", (T(x3), 0, 1, 2), {}, {}, RTOL),
    ("cummax", "cummax", (T(ties),), {}, {}, RTOL),
    ("cummin-axis0", "cummin", (T(ties), 0), {}, {}, RTOL),
    ("dist", "dist", (T(x), T(y)), {}, {}, RTOL),
    ("dist-inf", "dist", (T(x), T(y), INF), {}, {}, RTOL),
    ("dist-0", "dist", (T(x), T(y), 0), {}, {}, RTOL),
    ("dsplit", "dsplit", (T(x3), 2), {}, {}, RTOL),
    ("hsplit", "hsplit", (T(x), [1, 3]), {}, {}, RTOL),
    ("vsplit", "vsplit", (T(six), 3), {}, {}, RTOL),
    ("fmax", "fmax", (T(nans), T(y)), {}, {}, RTOL),
    ("fmin", "fmin", (T(nans), T(y)), {}, {}, RTOL),
    ("inverse", "inverse", (T(m),), {}, {}, 1e-4),
    ("logspace", "logspace", (0, 2, 5), {}, CPU, RTOL),
    ("logspace-base", "logspace", (0, 3, 4), {"base": 2.0}, CPU, RTOL),
    ("mode", "mode", (T(small), 1), {}, {}, RTOL),
    ("mode-keepdim", "mode", (T(small), 0), {"keepdim": True}, {}, RTOL),
    ("nansum", "nansum", (T(nans), 1), {}, {}, RTOL),
    ("nanmean", "nanmean", (T(nans),), {}, {}, RTOL),
    ("index_put", "index_put", (T(x), (T(np.array([0, 2])),
                                       T(np.array([1, 3]))), T(y[0, :2])),
     {}, {}, RTOL),
    ("index_put-accumulate", "index_put", (T(x), (T(np.array([0, 0, 2])),
                                                  T(np.array([1, 1, 3]))),
                                           T(np.array([1., 2., 3.], F32))),
     {"accumulate": True}, {}, RTOL),
    ("index_sample", "index_sample", (T(x), T(idx)), {}, {}, RTOL),
    ("scatter_nd", "scatter_nd", (T(np.array([[0, 1], [2, 3], [0, 1]])),
                                  T(np.array([1., 2., 3.], F32)), [3, 4]),
     {}, {}, RTOL),
    ("shard_index", "shard_index", (T(np.array([0, 7, 10, 19, 12])), 20, 2,
                                    1), {}, {}, RTOL),
    ("take-wrap", "take", (T(x), T(np.array([-1, 20, 3]))), {"mode": "wrap"},
     {}, RTOL),
    ("take-clip", "take", (T(x), T(np.array([-1, 20, 3]))), {"mode": "clip"},
     {}, RTOL),
    ("tensordot", "tensordot", (T(x3), T(rs.randn(4, 5).astype(F32)), 1), {},
     {}, RTOL),
    ("unfold", "unfold", (T(rs.randn(2, 8).astype(F32)), 1, 3, 2), {}, {},
     RTOL),
    ("unique_consecutive", "unique_consecutive",
     (T(np.array([1, 1, 2, 2, 2, 3, 1, 1])), True, True), {}, {}, RTOL),
    ("unique_consecutive-axis", "unique_consecutive",
     (T(np.array([[1, 2], [1, 2], [3, 4], [1, 2]])),), {"axis": 0}, {}, RTOL),
    ("unstack", "unstack", (T(x), 1), {}, {}, RTOL),
    ("vander", "vander", (T(v[:3]),), {}, {}, RTOL),
    ("vander-increasing", "vander", (T(v), 3, True), {}, {}, RTOL),
    ("polar", "polar", (T(pos), T(x)), {}, {}, RTOL),
)




# ------------------------------------------------------------ linalg, fft
rs = np.random.RandomState(100)
A = (rs.randn(4, 4) + 4 * np.eye(4)).astype(F32)
SPD = (A @ A.T + np.eye(4)).astype(F32)
B = rs.randn(4, 3).astype(F32)
R = rs.randn(5, 3).astype(F32)
BA = (rs.randn(2, 4, 4) + 4 * np.eye(4)).astype(F32)
V = rs.randn(6).astype(F32)
C3 = rs.randn(4, 3).astype(F32)
LINALG_CASES = (
    ("matmul", (T(B.T), T(A)), {"transpose_y": True}),
    ("norm", (T(A),), {}),
    ("norm-vector", (T(V),), {}),
    ("norm-axis", (T(A), 1, 1), {}),
    ("norm-inf-keepdim", (T(A), float("inf"), None, True), {}),
    ("norm-matrix-2", (T(BA), None, (1, 2)), {}),
    ("norm-nuc", (T(A), "nuc", (0, 1)), {}),
    ("cond", (T(A),), {}),
    ("cond-fro", (T(A), "fro"), {}),
    ("cov", (T(B),), {}),
    ("cov-cols-biased", (T(B), False, False), {}),
    ("cov-weights", (T(B),), {"fweights": T(np.array([1, 2, 1])),
                              "aweights": T(np.array([.5, 1., 2.], F32))}),
    ("corrcoef", (T(B),), {}),
    ("cholesky", (T(SPD),), {}),
    ("cholesky-upper", (T(SPD), True), {}),
    ("cholesky_solve", (T(B), T(np.linalg.cholesky(SPD).astype(F32))), {}),
    ("svdvals", (T(R),), {}),
    ("eigvals-sorted", (T(SPD),), {}),
    ("eigvalsh", (T(SPD),), {}),
    ("eigvalsh-upper", (T(SPD), "U"), {}),
    ("inv", (T(A),), {}),
    ("pinv", (T(R),), {}),
    ("pinv-hermitian", (T(SPD),), {"hermitian": True}),
    ("det", (T(BA),), {}),
    ("slogdet", (T(A),), {}),
    ("solve", (T(A), T(B)), {}),
    ("triangular_solve", (T(np.triu(A)), T(B)), {}),
    ("triangular_solve-lower-transpose", (T(np.tril(A)), T(B)),
     {"upper": False, "transpose": True}),
    ("triangular_solve-unit", (T(np.triu(A)), T(B)), {"unitriangular": True}),
    ("solve_triangular", (T(np.triu(A)), T(B)), {}),
    ("matrix_power", (T(A), 3), {}),
    ("matrix_power-inverse", (T(A), -2), {}),
    ("vector_norm", (T(A),), {}),
    ("vector_norm-axis-p3", (T(A), 3.0, 0), {}),
    ("vector_norm-inf", (T(A), float("inf"), 1), {}),
    ("vector_norm-ninf", (T(A), float("-inf"), 1), {}),
    ("vector_norm-0", (T(np.array([0., 1., 2.], F32)), 0), {}),
    ("matrix_norm", (T(BA),), {}),
    ("matrix_norm-1", (T(A), 1), {}),
    ("matrix_exp", (T(A * 0.2),), {}),
    ("matrix_exp-batched", (T(BA * 0.1),), {}),
    ("matrix_rank", (T(R @ R.T),), {}),
    ("matrix_rank-tol", (T(np.diag([3., 1., 1e-3, 0.]).astype(F32)), 1e-2),
     {}),
    ("matrix_rank-hermitian", (T(SPD),), {"hermitian": True}),
    ("matrix_rank-batched-tol", (T(np.stack([np.diag([3., 1., .5]),
                                             np.diag([3., 1., .5])]).astype(
                                                 F32)),
                                 T(np.array([.7, .2], F32))), {}),
    ("multi_dot", ([T(A), T(B), T(B.T)],), {}),
    ("matrix_transpose", (T(BA),), {}),
    ("dot", (T(A), T(A.T)), {}),
    ("cross", (T(C3), T(C3[::-1].copy())), {}),
    ("cross-axis", (T(C3.T), T(C3.T[:, ::-1].copy()), 0), {}),
    ("bmm", (T(BA), T(BA)), {}),
)



X1 = rs.randn(3, 16).astype(F32)
X2 = rs.randn(2, 8, 6).astype(F32)
XC = (rs.randn(3, 16) + 1j * rs.randn(3, 16)).astype(np.complex64)
FFT_CASES = (
    ("fft", (T(XC),), {}), ("fft-real-n-ortho", (T(X1), 20), {"norm": "ortho"}),
    ("ifft", (T(XC),), {"norm": "forward"}), ("fft2", (T(X2),), {}),
    ("ifft2", (T(X2), (4, 4)), {}), ("fftn", (T(X2),), {}),
    ("ifftn", (T(X2), None, (0, 2)), {}), ("rfft", (T(X1),), {}),
    ("rfft-axis", (T(X2), None, 1), {"norm": "ortho"}),
    ("irfft", (T(XC),), {}), ("irfft-n", (T(XC), 20), {}),
    ("rfft2", (T(X2),), {}), ("irfft2", (T(X2.astype(np.complex64)),), {}),
    ("rfftn", (T(X2),), {}), ("irfftn", (T(X2.astype(np.complex64)),), {}),
    ("hfft", (T(XC),), {}), ("ihfft", (T(X1),), {}),
    ("fftshift", (T(X1),), {}), ("fftshift-axes", (T(X2), (1,)), {}),
    ("ifftshift", (T(X1),), {}),
)




# ----------------------------------------------------------- sparse, dists
rs = np.random.RandomState(200)
IDX = np.array([[0, 1, 1, 2, 0], [1, 0, 2, 3, 1]])      # (0, 1) twice
VAL = rs.randn(5).astype(np.float32)
IDX2 = np.array([[0, 2, 1], [1, 3, 3]])
VAL2 = rs.randn(3).astype(np.float32)
DENSE = rs.randn(3, 4).astype(np.float32)
RIGHT = rs.randn(4, 2).astype(np.float32)
SQUARE = rs.randn(4, 4).astype(np.float32)
CROWS, COLS = np.array([0, 2, 3, 4]), np.array([0, 3, 1, 2])
CVAL = rs.rand(4).astype(np.float32) + 0.5




def coo(m, c, idx=IDX, val=VAL, shape=None):
    """A COO tensor of module ``m`` (the JAX or the port's ``sparse``), its
    arrays made by ``c``."""
    return m.sparse_coo_tensor(c(idx), c(val), shape)


def csr(m, c):
    return m.sparse_csr_tensor(c(CROWS), c(COLS), c(CVAL), (3, 4))


SPARSE_OPS = (
    ("add-sparse", lambda m, c: m.add(coo(m, c), coo(m, c, IDX2, VAL2, (3, 4)))),
    ("add-csr", lambda m, c: m.add(csr(m, c), csr(m, c))),
    ("add-dense", lambda m, c: m.add(coo(m, c), c(DENSE))),
    ("subtract-sparse", lambda m, c: m.subtract(coo(m, c),
                                                coo(m, c, IDX2, VAL2, (3, 4)))),
    ("subtract-dense", lambda m, c: m.subtract(coo(m, c), c(DENSE))),
    ("multiply-scalar", lambda m, c: m.multiply(coo(m, c), 2.5)),
    ("multiply_scalar", lambda m, c: m.multiply_scalar(csr(m, c), -1.5)),
    ("multiply-dense", lambda m, c: m.multiply(coo(m, c), c(DENSE))),
    ("multiply-sparse", lambda m, c: m.multiply(csr(m, c), csr(m, c))),
    ("divide-scalar", lambda m, c: m.divide(coo(m, c), 4.0)),
    ("divide-dense", lambda m, c: m.divide(csr(m, c), c(DENSE + 5))),
    ("matmul-coo", lambda m, c: m.matmul(coo(m, c), c(RIGHT))),
    ("matmul-csr", lambda m, c: m.matmul(csr(m, c), c(RIGHT))),
    ("masked_matmul", lambda m, c: m.masked_matmul(
        c(DENSE), c(SQUARE),
        coo(m, c, IDX2, VAL2, (3, 4)))),
    ("relu", lambda m, c: m.relu(coo(m, c))),
    ("tanh", lambda m, c: m.tanh(csr(m, c))),
    ("sqrt", lambda m, c: m.sqrt(csr(m, c))),
    ("sin", lambda m, c: m.sin(coo(m, c))),
    ("abs", lambda m, c: m.abs(coo(m, c))),
    ("neg", lambda m, c: m.neg(csr(m, c))),
    ("pow", lambda m, c: m.pow(csr(m, c), 3)),
    ("cast", lambda m, c: m.cast(coo(m, c), value_dtype="float16")),
    ("cast-csr", lambda m, c: m.cast(csr(m, c), "int32", "float16")),
    ("transpose", lambda m, c: m.transpose(coo(m, c), [1, 0])),
    ("transpose-csr", lambda m, c: m.transpose(csr(m, c), (1, 0))),
    ("coalesce", lambda m, c: m.coalesce(coo(m, c))),
)



r = np.random.RandomState(1)
LOC = r.randn(3).astype(np.float32)
SCALE = (r.rand(3) + 0.5).astype(np.float32)
P3 = np.array([0.2, 0.5, 0.8], np.float32)
CONC = (r.rand(3) * 3 + 0.5).astype(np.float32)
LOGITS = r.randn(2, 4).astype(np.float32)
TRIL = np.tril(r.randn(3, 3)).astype(np.float32) + 2 * np.eye(
    3, dtype=np.float32)
VALS = (r.rand(3) + 0.1).astype(np.float32)       # inside (0, 1) too
COUNTS = np.array([0., 2., 5.], np.float32)


def dists(m, c):
    """(name, distribution, values to score) for each family."""
    return (
        ("Normal", m.Normal(c(LOC), c(SCALE)), c(VALS * 3 - 1)),
        ("LogNormal", m.LogNormal(c(LOC), c(SCALE)), c(VALS * 3)),
        ("Uniform", m.Uniform(c(LOC - 1), c(LOC + 2)), c(LOC + VALS)),
        ("Categorical", m.Categorical(c(LOGITS)), c(np.array([1, 3]))),
        ("Categorical-probs", m.Categorical(probs=c(np.array(
            [0.1, 0.6, 0.3], np.float32))), c(np.array(2))),
        ("Bernoulli", m.Bernoulli(c(P3)), c(np.array([0., 1., 1.],
                                                     np.float32))),
        ("Beta", m.Beta(c(CONC), c(CONC[::-1].copy())), c(VALS * 0.8)),
        ("Dirichlet", m.Dirichlet(c(CONC)), c(np.array([0.2, 0.3, 0.5],
                                                       np.float32))),
        ("Gamma", m.Gamma(c(CONC), c(SCALE)), c(VALS * 4)),
        ("Exponential", m.Exponential(c(SCALE)), c(VALS * 2)),
        ("Laplace", m.Laplace(c(LOC), c(SCALE)), c(VALS * 3 - 1)),
        ("Gumbel", m.Gumbel(c(LOC), c(SCALE)), c(VALS * 3 - 1)),
        ("Cauchy", m.Cauchy(c(LOC), c(SCALE)), c(VALS * 3 - 1)),
        ("Geometric", m.Geometric(c(P3)), c(COUNTS)),
        ("Poisson", m.Poisson(c(CONC)), c(COUNTS)),
        ("Binomial", m.Binomial(c(np.full(3, 6., np.float32)), c(P3)),
         c(COUNTS)),
        ("Multinomial", m.Multinomial(6, c(np.array([0.2, 0.3, 0.5],
                                                    np.float32))),
         c(np.array([1., 2., 3.], np.float32))),
        ("MultivariateNormal", m.MultivariateNormal(c(LOC),
                                                    scale_tril=c(TRIL)),
         c(VALS)),
        ("MultivariateNormal-cov", m.MultivariateNormal(
            c(LOC), covariance_matrix=c(TRIL @ TRIL.T)), c(VALS)),
        ("Chi2", m.Chi2(c(CONC)), c(VALS * 3)),
        ("StudentT", m.StudentT(c(CONC + 1), c(LOC), c(SCALE)),
         c(VALS * 3 - 1)),
        ("ContinuousBernoulli", m.ContinuousBernoulli(
            c(np.array([0.2, 0.5, 0.9], np.float32))), c(VALS * 0.9)),
        ("Independent", m.Independent(m.Normal(c(LOC), c(SCALE)), 1),
         c(VALS)),
        ("TransformedDistribution", m.TransformedDistribution(
            m.Normal(c(LOC), c(SCALE)),
            [m.AffineTransform(c(np.array(0.5, np.float32)),
                               c(np.array(2.0, np.float32))),
             m.ExpTransform()]), c(VALS * 3 + 0.5)),
    )



KL_PAIRS = (
    ("Normal", lambda m, c: (m.Normal(c(LOC), c(SCALE)),
                             m.Normal(c(LOC[::-1].copy()), c(SCALE * 2)))),
    ("Categorical", lambda m, c: (m.Categorical(c(LOGITS)),
                                  m.Categorical(c(LOGITS[::-1].copy())))),
    ("Bernoulli", lambda m, c: (m.Bernoulli(c(P3)),
                                m.Bernoulli(c(P3[::-1].copy())))),
    ("Uniform", lambda m, c: (m.Uniform(c(LOC), c(LOC + 1)),
                              m.Uniform(c(LOC - 1), c(LOC + 3)))),
    ("Gumbel", lambda m, c: (m.Gumbel(c(LOC), c(SCALE)),
                             m.Gumbel(c(LOC * 2), c(SCALE + 1)))),
    ("MultivariateNormal", lambda m, c: (
        m.MultivariateNormal(c(LOC), scale_tril=c(TRIL)),
        m.MultivariateNormal(c(LOC * 0), scale_tril=c(TRIL * 1.5)))),
)


