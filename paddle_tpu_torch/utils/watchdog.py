"""Failure detection (a copy of ``paddle_tpu/utils/watchdog.py``, which
is pure Python; the port keeps its own copy so that it imports nothing of
the JAX package).

The failure modes that matter in a training loop are (1) numeric
divergence (NaN/Inf loss) and (2) a hung step. ``StepWatchdog`` covers
both: a streak counter of non-finite losses with a divergence threshold,
and a wall-clock heartbeat a monitor thread checks (the trainer's hang
exit: checkpoint and exit for the elastic supervisor)."""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional


class DivergenceError(RuntimeError):
    pass


class StepWatchdog:
    def __init__(self, nan_patience: int = 3,
                 hang_timeout_s: Optional[float] = None,
                 on_hang: Optional[Callable[[], None]] = None):
        """nan_patience: consecutive non-finite losses tolerated before
        raising DivergenceError (transient fp16 spikes are normal with a
        GradScaler; persistent NaN is divergence)."""
        self.nan_patience = nan_patience
        self._nan_streak = 0
        self._last_beat = time.monotonic()
        self._hang_timeout = hang_timeout_s
        self._on_hang = on_hang
        # hang detection arms on the FIRST beat (= first completed step):
        # the initial step includes jit compilation, which legitimately
        # dwarfs any sane per-step timeout
        self._armed = False
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if hang_timeout_s is not None:
            self._monitor = threading.Thread(target=self._watch, daemon=True)
            self._monitor.start()

    # ------------------------------------------------------------- numeric
    def check_loss(self, loss_value: float, step: int):
        if math.isfinite(loss_value):
            self._nan_streak = 0
        else:
            self._nan_streak += 1
            if self._nan_streak >= self.nan_patience:
                raise DivergenceError(
                    f"loss non-finite for {self._nan_streak} consecutive "
                    f"steps (last step {step}) — stopping; resume from the "
                    f"latest checkpoint with a lower lr / loss scale")
        self.beat()

    def reset_nan(self):
        """Clear the non-finite-loss streak (divergence recovery: the
        Trainer rolled back to a finite checkpoint, so the streak must
        restart from zero, not re-trip on the next spike)."""
        self._nan_streak = 0

    # ------------------------------------------------------------ heartbeat
    def beat(self):
        self._armed = True
        self._last_beat = time.monotonic()

    def seconds_since_beat(self) -> float:
        return time.monotonic() - self._last_beat

    def _watch(self):
        while not self._stop.wait(min(self._hang_timeout / 4, 30.0)):
            if self._armed and self.seconds_since_beat() > self._hang_timeout:
                if self._on_hang is not None:
                    self._on_hang()
                self._last_beat = time.monotonic()  # fire once per hang

    def close(self):
        self._stop.set()
