"""paddle.audio (counterpart of ``paddle_tpu/audio.py``; reference:
python/paddle/audio — the window and mel utilities and the Spectrogram,
MelSpectrogram, LogMelSpectrogram and MFCC feature layers).

Each feature is plain tensor code over :func:`signal.stft` (frame,
window, rfft, |.|^p, mel matmul, log, DCT), batched over channels, on
the input's device. The layers are the port's ``nn.Layer``s; their window,
filterbank and DCT buffers are made on ``device`` (the card by default)
and are not persistable.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import signal as _signal
from .device import resolve_device
from .dtypes import to_dtype
from .nn.layer import Layer
from .tensor import _linspace

__all__ = [
    "get_window", "hz_to_mel", "mel_to_hz", "mel_frequencies",
    "compute_fbank_matrix", "create_dct", "power_to_db",
    "Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC",
]


# -------------------------------------------------------------- functional
def get_window(window: str, win_length: int, fftbins: bool = True,
               dtype=torch.float32, device=None):
    """hann, hamming, blackman or ones; ``fftbins`` gives the periodic
    variant."""
    n = torch.arange(win_length, dtype=torch.float32,
                     device=resolve_device(device))
    denom = win_length if fftbins else win_length - 1
    if window in ("hann", "hanning"):
        w = 0.5 - 0.5 * torch.cos(2 * math.pi * n / denom)
    elif window == "hamming":
        w = 0.54 - 0.46 * torch.cos(2 * math.pi * n / denom)
    elif window == "blackman":
        w = (0.42 - 0.5 * torch.cos(2 * math.pi * n / denom)
             + 0.08 * torch.cos(4 * math.pi * n / denom))
    elif window in ("ones", "boxcar", "rectangular"):
        w = torch.ones_like(n)
    else:
        raise ValueError(f"unsupported window {window!r}")
    return w.to(to_dtype(dtype))


def _f32(v, device):
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.as_tensor(v, dtype=torch.float32,
                           device=resolve_device(device))


# Slaney's scale: linear below 1 kHz, log above
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(freq, htk: bool = False, device=None):
    freq = _f32(freq, device)
    if htk:
        return 2595.0 * torch.log10(1.0 + freq / 700.0)
    return torch.where(freq >= _MIN_LOG_HZ,
                       _MIN_LOG_MEL + torch.log(freq / _MIN_LOG_HZ)
                       / _LOGSTEP, freq / _F_SP)


def mel_to_hz(mel, htk: bool = False, device=None):
    mel = _f32(mel, device)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    return torch.where(mel >= _MIN_LOG_MEL,
                       _MIN_LOG_HZ * torch.exp(_LOGSTEP
                                               * (mel - _MIN_LOG_MEL)),
                       _F_SP * mel)


def mel_frequencies(n_mels: int, f_min: float, f_max: float,
                    htk: bool = False, device=None):
    dev = resolve_device(device)
    mels = _linspace(hz_to_mel(f_min, htk, dev), hz_to_mel(f_max, htk, dev),
                     n_mels, torch.float32, dev)
    return mel_to_hz(mels, htk)


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max: Optional[float] = None,
                         htk: bool = False, norm: str = "slaney",
                         dtype=torch.float32, device=None):
    """[n_mels, n_fft // 2 + 1] triangular mel filterbank
    (librosa-compatible; ``slaney`` normalises each triangle's area)."""
    dev = resolve_device(device)
    f_max = f_max or sr / 2.0
    fft_freqs = _linspace(0.0, sr / 2.0, n_fft // 2 + 1, torch.float32, dev)
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max, htk, dev)
    fdiff = torch.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp_min(torch.minimum(lower, upper), 0.0)
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return weights.to(to_dtype(dtype))


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = "ortho",
               dtype=torch.float32, device=None):
    """[n_mels, n_mfcc] DCT-II basis."""
    dev = resolve_device(device)
    n = torch.arange(n_mels, dtype=torch.float32, device=dev)
    k = torch.arange(n_mfcc, dtype=torch.float32, device=dev)
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2.0)
        dct = dct * math.sqrt(1.0 / (2.0 * n_mels))
    return dct.to(to_dtype(dtype))


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0):
    log_spec = 10.0 * torch.log10(torch.clamp_min(spect, amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


# ------------------------------------------------------------------ layers
class Spectrogram(Layer):
    """|STFT|^power over frames: [..., time] -> [..., freq, frame]."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", dtype=torch.float32, *,
                 device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer(
            "window", get_window(window, self.win_length, dtype=dtype,
                                 device=device), persistable=False)

    def forward(self, x):
        spec = _signal.stft(x, self.n_fft, self.hop_length, self.win_length,
                            self.window, center=self.center,
                            pad_mode=self.pad_mode)
        return torch.abs(spec) ** self.power


class MelSpectrogram(Layer):
    """Spectrogram, then the mel filterbank."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: str = "slaney",
                 dtype=torch.float32, *, device=None):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                       window, power, center, pad_mode,
                                       dtype=dtype, device=device)
        self.register_buffer(
            "fbank", compute_fbank_matrix(sr, n_fft, n_mels, f_min, f_max,
                                          htk, norm, dtype, device=device),
            persistable=False)

    def forward(self, x):
        return self.fbank @ self.spectrogram(x)


class LogMelSpectrogram(Layer):
    """The mel spectrogram in dB (positional order as the reference's)."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: str = "slaney",
                 ref_value: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None, dtype=torch.float32, *,
                 device=None):
        super().__init__()
        self.mel = MelSpectrogram(sr, n_fft, hop_length, win_length, window,
                                  power, center, pad_mode, n_mels, f_min,
                                  f_max, htk, norm, dtype, device=device)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        return power_to_db(self.mel(x), self.ref_value, self.amin,
                           self.top_db)


class MFCC(Layer):
    """Mel-frequency cepstral coefficients: the log-mel spectrogram, then
    the DCT-II. ``kw`` goes to :class:`LogMelSpectrogram`."""

    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_mels: int = 64,
                 *, device=None, **kw):
        super().__init__()
        self.log_mel = LogMelSpectrogram(sr=sr, n_mels=n_mels, device=device,
                                         **kw)
        self.register_buffer("dct", create_dct(n_mfcc, n_mels,
                                               device=device),
                             persistable=False)

    def forward(self, x):
        return self.dct.T @ self.log_mel(x)
