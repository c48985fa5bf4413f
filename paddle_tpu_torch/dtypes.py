"""Paddle's dtype names (counterpart of ``paddle_tpu/dtypes.py``;
reference: paddle/phi/common/data_type.h).

bfloat16 is the preferred compute dtype and float32 the accumulation and
master dtype, as in the JAX package.

The 64-bit rule differs in dtype only. The JAX package runs with x64 off,
so a call that names ``int64`` or ``float64`` gets ``int32`` or
``float32`` there, and its integer defaults are ``int32``. The port keeps
the dtype the caller names, and its integer defaults are ``int64``, as
Paddle's and torch's are. The values are the same.
"""
from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64

_DTYPE_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_, "complex64": complex64,
}


def to_dtype(dtype):
    """A Paddle dtype name, a torch dtype or a numpy dtype (``np.float32``,
    ``np.dtype("int32")``) as a torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _DTYPE_ALIASES[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unknown dtype {dtype!r}") from None
    if name == "complex128":
        return torch.complex128
    try:
        return _DTYPE_ALIASES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def default_float():
    return float32
