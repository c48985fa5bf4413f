"""Image transforms (the port's copy of ``paddle_tpu/vision/transforms.py``;
reference: python/paddle/vision/transforms/, Compose and the classic
preprocessing set).

Host numpy code, run in DataLoader workers: the card wants one batch,
not per-image kernels. Images are HWC uint8 or float in, and
``ToTensor`` gives CHW float32, the reference's contract. With the same
``np.random.Generator`` state every transform gives the JAX package's
output bit for bit.

Randomness: each random transform takes an optional
``np.random.Generator``; without one, every call draws from a fresh
``np.random.default_rng()`` (OS entropy), as in the JAX package. A
transform given a generator carries a copy of it into each spawned
DataLoader worker, so the workers repeat one another's draws unless a
``worker_init_fn`` reseeds it from ``io.get_worker_info().seed`` (the
base seed plus the worker's id).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


def _size2d(size):
    return (size, size) if isinstance(size, int) else tuple(size)


def resize(img: np.ndarray, size, interpolation: str = "bilinear"):
    """HWC resize. Bilinear via separable linear interpolation (no cv2 in
    the image); 'nearest' for masks."""
    h, w = img.shape[:2]
    oh, ow = _size2d(size)
    if (h, w) == (oh, ow):
        return img
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    if interpolation == "nearest":
        ys = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
        xs = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
        out = img[ys][:, xs]
    else:  # bilinear, align_corners=False convention
        ys = (np.arange(oh) + 0.5) * h / oh - 0.5
        xs = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.floor(ys).clip(0, h - 1).astype(int)
        x0 = np.floor(xs).clip(0, w - 1).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0).clip(0, 1)[:, None, None]
        wx = (xs - x0).clip(0, 1)[None, :, None]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
        out = top * (1 - wy) + bot * wy
        if np.issubdtype(img.dtype, np.integer):
            out = np.round(out).clip(0, 255).astype(img.dtype)
        else:
            out = out.astype(img.dtype)
    return out[:, :, 0] if squeeze else out


class Resize:
    def __init__(self, size, interpolation: str = "bilinear"):
        self.size, self.interpolation = size, interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


def _pad_to(img, ch, cw):
    h, w = img.shape[:2]
    ph, pw = max(ch - h, 0), max(cw - w, 0)
    if ph or pw:
        pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)) \
            + ((0, 0),) * (img.ndim - 2)
        img = np.pad(img, pads)
    return img


def _check_crop(img, ch, cw, pad_if_needed, name):
    h, w = img.shape[:2]
    if h < ch or w < cw:
        if not pad_if_needed:
            raise ValueError(f"{name}: image {h}x{w} smaller than crop "
                             f"{ch}x{cw} (set pad_if_needed=True to pad)")
        img = _pad_to(img, ch, cw)
    return img


class CenterCrop:
    def __init__(self, size, pad_if_needed: bool = False):
        self.size = _size2d(size)
        self.pad_if_needed = pad_if_needed

    def __call__(self, img):
        ch, cw = self.size
        img = _check_crop(img, ch, cw, self.pad_if_needed, "CenterCrop")
        h, w = img.shape[:2]
        top, left = (h - ch) // 2, (w - cw) // 2
        return img[top:top + ch, left:left + cw]


class RandomCrop:
    def __init__(self, size, pad_if_needed: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.size = _size2d(size)
        self.pad_if_needed = pad_if_needed
        self.rng = rng

    def __call__(self, img):
        ch, cw = self.size
        img = _check_crop(img, ch, cw, self.pad_if_needed, "RandomCrop")
        h, w = img.shape[:2]
        r = _rng(self.rng)
        top = int(r.integers(0, h - ch + 1))
        left = int(r.integers(0, w - cw + 1))
        return img[top:top + ch, left:left + cw]


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5,
                 rng: Optional[np.random.Generator] = None):
        self.prob, self.rng = prob, rng

    def __call__(self, img):
        if _rng(self.rng).random() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomResizedCrop:
    """Random area/aspect crop then resize (the ImageNet train transform)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 rng: Optional[np.random.Generator] = None):
        self.size = _size2d(size)
        self.scale, self.ratio, self.rng = scale, ratio, rng

    def __call__(self, img):
        h, w = img.shape[:2]
        r = _rng(self.rng)
        for _ in range(10):
            area = h * w * r.uniform(*self.scale)
            aspect = np.exp(r.uniform(np.log(self.ratio[0]),
                                      np.log(self.ratio[1])))
            ch = int(round(np.sqrt(area / aspect)))
            cw = int(round(np.sqrt(area * aspect)))
            if ch <= h and cw <= w:
                top = int(r.integers(0, h - ch + 1))
                left = int(r.integers(0, w - cw + 1))
                return resize(img[top:top + ch, left:left + cw], self.size)
        return resize(CenterCrop(min(h, w))(img), self.size)


class Normalize:
    """(x - mean) / std per channel; expects CHW float (post-ToTensor) or
    HWC with data_format='HWC' (reference default is CHW)."""

    def __init__(self, mean, std, data_format: str = "CHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference contract)."""

    def __call__(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        out = img.transpose(2, 0, 1)
        if np.issubdtype(img.dtype, np.integer):
            out = out.astype(np.float32) / 255.0
        return np.ascontiguousarray(out, np.float32)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)
