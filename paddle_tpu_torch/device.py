"""Device choice for the port's entry points, and the card lock.

Every entry point takes ``device=None``: that means the CUDA card, and
raises when there is none. The CPU is used only when the caller asks for
it (``device="cpu"``), as the tests do. Nothing falls back silently.

``card_lock`` orders the process's threads around work that must run
alone on the cards: serving engines on distinct models step together on
their own threads, each under a share of it; a CUDA-graph capture (its
warm-up runs on a side stream, and the kernels' workspaces are shared by
every engine) and a ``torch.profiler`` start or stop (stopping the
profiler while another thread replayed a graph hung the process) hold it
alone.
"""
from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class CardLock:
    """A shared/exclusive lock. A waiting exclusive holder keeps new
    shares out, so it is not starved. Shares nest on a thread, and a
    thread that takes the lock alone gives up its own shares first and
    takes them back after."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0
        self._tls = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._tls, "depth", 0)
        with self._cond:
            # a nested share never waits: a waiting exclusive holder
            # waits for this thread's outer share
            while depth == 0 and (self._exclusive or self._waiting):
                self._cond.wait()
            self._shared += 1
        self._tls.depth = depth + 1
        try:
            yield
        finally:
            self._tls.depth = depth
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        depth = getattr(self._tls, "depth", 0)
        with self._cond:
            self._shared -= depth
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._exclusive = True
        self._tls.depth = 0
        try:
            yield
        finally:
            self._tls.depth = depth
            with self._cond:
                self._exclusive = False
                self._shared += depth
                self._cond.notify_all()


card_lock = CardLock()
