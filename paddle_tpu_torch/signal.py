"""paddle.signal (counterpart of ``paddle_tpu/signal.py``; reference:
python/paddle/signal.py).

The JAX package's formulas, not ``torch.stft`` / ``torch.istft``, whose
framing, ``normalized`` scaling and NOLA check differ: ``frame`` is one
gather of [n_frames, frame_length] indices, ``stft`` frames, windows and
``rfft``s every frame at once, and ``istft`` overlap-adds the inverse
frames and divides by the window envelope clamped at 1e-11. ``center``
pads with numpy's ``reflect``, which reflects again where the pad is
longer than the signal (``tensor.pad``): a [2, 40] signal takes an
``n_fft`` of 128. ``istft(length=)`` truncates and never pads.
"""
from __future__ import annotations

import torch

from .tensor import pad as _pad

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _frame_index(n_frames, frame_length, hop_length, device):
    starts = torch.arange(n_frames, device=device) * hop_length
    return starts[:, None] + torch.arange(frame_length, device=device)


def frame(x, frame_length: int, hop_length: int, axis=-1):
    """Overlapping frames of the last axis: [..., frame_length, n_frames]
    with ``axis=-1`` (the default), [..., n_frames, frame_length]
    otherwise."""
    n = x.shape[-1]
    if n < frame_length:
        raise ValueError(f"signal length {n} < frame_length {frame_length}")
    n_frames = 1 + (n - frame_length) // hop_length
    frames = x[..., _frame_index(n_frames, frame_length, hop_length,
                                 x.device)]
    return frames.transpose(-1, -2) if axis == -1 else frames


def overlap_add(x, hop_length: int, axis=-1):
    """The inverse of :func:`frame`: x [..., frame_length, n_frames]
    (``axis=-1``) summed into [..., n]."""
    if axis == -1:
        x = x.transpose(-1, -2)
    *lead, n_frames, frame_length = x.shape
    n = (n_frames - 1) * hop_length + frame_length
    idx = _frame_index(n_frames, frame_length, hop_length, x.device)
    out = torch.zeros((*lead, n), dtype=x.dtype, device=x.device)
    return out.index_add(-1, idx.reshape(-1),
                         x.reshape(*lead, n_frames * frame_length))


def _window(window, win_length, n_fft, dtype, device):
    if window is None:
        window = torch.ones(win_length, dtype=dtype, device=device)
    if win_length < n_fft:  # centre the window in n_fft (torch/paddle)
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window,
                                         (lpad, n_fft - win_length - lpad))
    return window


def stft(x, n_fft: int, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True):
    """x [..., n] -> complex [..., n_fft // 2 + 1 (or n_fft), n_frames]."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _window(window, win_length, n_fft, x.dtype, x.device)
    if center:
        p = n_fft // 2
        x = _pad(x, [(0, 0)] * (x.dim() - 1) + [(p, p)], mode=pad_mode)
    frames = frame(x, n_fft, hop_length, axis=-1).transpose(-1, -2) * window
    spec = (torch.fft.rfft(frames, dim=-1) if onesided
            else torch.fft.fft(frames, dim=-1))
    if normalized:
        spec = spec / torch.sqrt(torch.tensor(float(n_fft)))
    return spec.transpose(-1, -2)


def istft(x, n_fft: int, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False):
    """The inverse of :func:`stft`: overlap-added inverse frames divided by
    the window envelope (clamped at 1e-11); ``length`` truncates."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _window(window, win_length, n_fft, torch.float32, x.device)
    if return_complex and onesided:
        raise ValueError("return_complex requires onesided=False (a "
                         "onesided spectrum encodes a real signal)")
    spec = x.transpose(-1, -2)
    if normalized:
        spec = spec * torch.sqrt(torch.tensor(float(n_fft)))
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, dim=-1)
        if not return_complex:
            frames = frames.real
    frames = frames * window
    sig = overlap_add(frames.transpose(-1, -2), hop_length, axis=-1)
    env = overlap_add((window * window)[:, None].expand(n_fft, x.shape[-1]),
                      hop_length, axis=-1)
    sig = sig / torch.clamp_min(env, 1e-11)
    if center:
        p = n_fft // 2
        sig = sig[..., p:sig.shape[-1] - p]
    if length is not None:
        sig = sig[..., :length]
    return sig
