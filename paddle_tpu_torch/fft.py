"""paddle.fft (counterpart of ``paddle_tpu/fft.py``; reference:
python/paddle/fft.py).

``torch.fft`` with Paddle's signatures and norm names (None means
``"backward"``, as ``_norm`` in the JAX file). A float32 input gives a
complex64 spectrum. ``fftfreq`` and ``rfftfreq`` create tensors, so they
take ``device=None`` (the card).
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .dtypes import to_dtype

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    return norm or "backward"


def _one(fn):
    def f(x, n=None, axis=-1, norm="backward"):
        return fn(x, n=n, dim=axis, norm=_norm(norm)).resolve_conj()
    f.__name__ = fn.__name__
    f.__doc__ = f"``torch.fft.{fn.__name__}`` along ``axis``."
    return f


def _many(fn, default_axes):
    def f(x, s=None, axes=default_axes, norm="backward"):
        return fn(x, s=s, dim=axes, norm=_norm(norm))
    f.__name__ = fn.__name__
    f.__doc__ = f"``torch.fft.{fn.__name__}`` over ``axes``."
    return f


fft = _one(torch.fft.fft)
ifft = _one(torch.fft.ifft)
rfft = _one(torch.fft.rfft)
irfft = _one(torch.fft.irfft)
hfft = _one(torch.fft.hfft)
ihfft = _one(torch.fft.ihfft)
fft2 = _many(torch.fft.fft2, (-2, -1))
ifft2 = _many(torch.fft.ifft2, (-2, -1))
rfft2 = _many(torch.fft.rfft2, (-2, -1))
irfft2 = _many(torch.fft.irfft2, (-2, -1))
fftn = _many(torch.fft.fftn, None)
ifftn = _many(torch.fft.ifftn, None)
rfftn = _many(torch.fft.rfftn, None)
irfftn = _many(torch.fft.irfftn, None)


def fftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.fftfreq(n, d=d, dtype=to_dtype(dtype),
                             device=resolve_device(device))


def rfftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.rfftfreq(n, d=d, dtype=to_dtype(dtype),
                              device=resolve_device(device))


def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=axes)
