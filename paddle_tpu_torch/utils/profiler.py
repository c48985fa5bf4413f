"""Training-loop meters (counterpart of ``paddle_tpu/utils/profiler.py``'s
``StepTimer`` and ``llama_flops_per_token``): step time, tokens per
second, and MFU against the card's peak.

The peak comes from a table keyed by ``torch.cuda.get_device_name()``:
NVIDIA's data-sheet dense bf16 rate of the card. A card the table does
not know has peak 0, and MFU then logs 0: nothing here defaults to some
other chip's peak. The trace facade (``Profiler``) of the JAX module is
``torch.profiler`` itself in the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

# dense bf16 tensor-core peak, FLOP/s (NVIDIA data sheets, SXM parts)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H200": 989e12,
}


def device_peak_flops(device=None) -> float:
    """The dense bf16 peak of a CUDA card (the current one by default); 0
    for an unknown card or when there is none."""
    if not torch.cuda.is_available():
        return 0.0
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device), 0.0)


@dataclass
class StepTimer:
    """Running step-time / throughput / MFU meter."""
    flops_per_token: float = 0.0
    peak_flops: float = field(default_factory=device_peak_flops)
    _t0: Optional[float] = None
    steps: int = 0
    total_s: float = 0.0
    total_tokens: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, tokens: int = 0, steps: int = 1):
        """Close a timing window covering ``steps`` training steps (the
        trainer logs once per ``logging_steps`` window, so per-step
        averages need the real step count, not the window count)."""
        if self._t0 is None:
            raise RuntimeError(
                "StepTimer.stop() called with no open window; call "
                "start() first")
        dt = time.perf_counter() - self._t0
        self._t0 = None          # window closed; a second stop() raises
        self.steps += steps
        self.total_s += dt
        self.total_tokens += tokens
        return dt

    @property
    def avg_step_s(self) -> float:
        return self.total_s / max(self.steps, 1)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / max(self.total_s, 1e-9)

    def mfu_at(self, tokens_per_sec: float) -> float:
        """Model FLOP utilisation at a token rate: 0 when the FLOPs per
        token or the card's peak are unknown."""
        if not self.flops_per_token or not self.peak_flops:
            return 0.0
        return self.flops_per_token * tokens_per_sec / self.peak_flops

    @property
    def mfu(self) -> float:
        return self.mfu_at(self.tokens_per_sec)


def llama_flops_per_token(n_params: int, num_layers: int, seq_len: int,
                          hidden: int) -> float:
    """6N matmul + causal-attention term (fwd+bwd)."""
    return 6.0 * n_params + 6.0 * num_layers * seq_len * hidden
