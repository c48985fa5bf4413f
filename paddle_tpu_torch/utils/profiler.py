"""Trace facade and training-loop meters (counterpart of
``paddle_tpu/utils/profiler.py``): ``Profiler`` (start / stop a trace),
``StepTimer`` and ``llama_flops_per_token``.

The peak comes from a table keyed by ``torch.cuda.get_device_name()``:
NVIDIA's data-sheet dense bf16 rate of the card. A card the table does
not know has peak 0, and MFU then logs 0: nothing here defaults to some
other chip's peak.

``Profiler`` records through ``torch.profiler``: CPU activity always,
CUDA activity when a card is present, and writes one Chrome trace file
into ``logdir`` at ``stop()``. One trace runs per process at a time, as
with the JAX module's facade: a second profiler started while another
traces falls back to timer-only and says so. Its start and stop hold
``device.card_lock`` alone: no engine steps while the profiler turns the
card's tracing on or off.
"""
from __future__ import annotations

import itertools
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..device import card_lock

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


# one live trace per process; the owner lets stop() know whether this
# instance actually holds it
_trace_owner: Optional["Profiler"] = None
_trace_ids = itertools.count()


class Profiler:
    """paddle.profiler.Profiler-shaped facade over ``torch.profiler``.
    ``timer_only`` records nothing (``trace_path`` stays None)."""

    def __init__(self, logdir: str = "runs/profile",
                 timer_only: bool = False):
        self.logdir = logdir
        self.timer_only = timer_only
        self.trace_path: Optional[str] = None
        self._active = False
        self._prof = None

    def start(self):
        """Idempotent: a second ``start()`` on a live profiler — or a
        ``start()`` while ANOTHER profiler's trace is still open — warns
        and returns instead of raising mid-run."""
        global _trace_owner
        if self._active:
            print("[profiler] start() called on an already-active "
                  "profiler; ignoring", file=sys.stderr, flush=True)
            return
        if not self.timer_only:
            if _trace_owner is not None:
                print(f"[profiler] a trace is already running "
                      f"(logdir={_trace_owner.logdir}); start() falls "
                      f"back to timer-only for this profiler",
                      file=sys.stderr, flush=True)
                self.timer_only = True
            else:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                with card_lock.exclusive():
                    self._prof.start()
                _trace_owner = self
        self._active = True

    def stop(self):
        """Stop the trace and write it to
        ``<logdir>/trace_<pid>_<n>.json`` (``trace_path``)."""
        global _trace_owner
        if self._active and _trace_owner is self:
            try:
                with card_lock.exclusive():
                    self._prof.stop()
                os.makedirs(self.logdir, exist_ok=True)
                path = os.path.join(
                    self.logdir,
                    f"trace_{os.getpid()}_{next(_trace_ids)}.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
            finally:
                # release the latch even when the export raises: a held
                # latch would wedge every later profiler into timer-only
                _trace_owner = None
                self._prof = None
        self._active = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


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
