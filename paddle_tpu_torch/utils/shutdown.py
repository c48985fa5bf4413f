"""Graceful preemption shutdown (the port's copy of
``paddle_tpu/utils/shutdown.py``; reference: paddle.distributed.elastic's
signal handling; cloud preemption notices arrive as SIGTERM with a ~30s
grace window). The serving gateway's SIGTERM drain latches on it.

Contract: the scheduler says "you are going away" (SIGTERM/SIGINT, or a
deterministic ``preempt`` fault injection in tests); the training loop
polls ``requested()`` at step boundaries, checkpoints synchronously,
drains the async writer, and exits with ``PREEMPTED_RC``. The elastic
supervisor (`distributed.elastic.supervise`) recognizes that code as
*always restartable* — a preemption is not a failure and never consumes
a ``max_restarts`` attempt.

Why a distinct exit code: death-by-signal (negative rc) means the grace
window was missed and the latest *periodic* checkpoint stands; rc ==
PREEMPTED_RC means the child checkpointed its exact current step first,
so the relaunch resumes with zero lost work.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Optional, Tuple

__all__ = ["GracefulShutdown", "PREEMPTED_RC"]

# Deliberately outside the shell (1/2/126/127) and signal (128+n) ranges
# and distinct from the hang path's default 17.
PREEMPTED_RC = 76


class GracefulShutdown:
    """Latch a shutdown request from SIGTERM/SIGINT (or programmatic
    ``request()``) for a polling loop to observe at a safe boundary.

    The handler only *records* the request — all heavy work (checkpoint,
    drain, exit) happens on the polling thread, where it is safe to call
    into torch and the checkpoint writer. ``install()`` is a no-op off
    the main thread (signal handlers are main-thread-only in CPython);
    the fault-injection
    channel still works there.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self.reason: Optional[str] = None
        self._prev: dict = {}

    # ------------------------------------------------------------ handlers
    def install(self) -> "GracefulShutdown":
        if self._prev:
            return self
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:      # not the main thread: poll-only mode
                self._prev.pop(sig, None)
                break
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def _on_signal(self, signum, frame):  # noqa: ARG002
        if self._event.is_set() and signum == signal.SIGINT:
            # second ^C: the user wants OUT now, not another grace period
            raise KeyboardInterrupt
        self.request(f"signal {signal.Signals(signum).name}")

    # ------------------------------------------------------------- control
    def request(self, reason: str = "requested"):
        """Latch a shutdown request (idempotent; first reason wins)."""
        if not self._event.is_set():
            self.reason = reason
            print(f"[shutdown] graceful shutdown requested ({reason}); "
                  f"will checkpoint and exit at the next step boundary",
                  file=sys.stderr, flush=True)
            try:   # flight recorder: the latch is the postmortem anchor
                from . import observability as obs
                obs.record_event("preempt_latch", reason=reason)
            except Exception:
                pass
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self):
        """Reset the latch (tests / reuse across train() calls)."""
        self._event.clear()
        self.reason = None

    # ------------------------------------------------------ context manager
    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
