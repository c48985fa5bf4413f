"""Metric logging (a copy of ``paddle_tpu/utils/logging.py``, which is
pure Python, so that the port imports nothing of the JAX package).

A dependency-free JSONL writer (one line per record: {"step": n, "tag":
..., "value": ..., "wall": t}) that any dashboard can tail, plus an
in-memory scalar history for programmatic access."""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict


class LogWriter:
    def __init__(self, logdir: str = "runs", filename: str = "metrics.jsonl"):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._fh = open(self.path, "a", buffering=1)  # line-buffered
        self.history: Dict[str, list] = defaultdict(list)

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self.history[tag].append((step, value))
        self._fh.write(json.dumps({"step": int(step), "tag": tag,
                                   "value": value, "wall": time.time()}) + "\n")

    def add_scalars(self, metrics: Dict[str, float], step: int):
        for tag, v in metrics.items():
            self.add_scalar(tag, v, step)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_writers: Dict[str, LogWriter] = {}


def get_logger(logdir: str = "runs") -> LogWriter:
    """Shared writer PER LOGDIR. The old singleton was keyed on nothing,
    so every call after the first silently ignored ``logdir`` and wrote
    into whichever directory happened to be asked for first."""
    key = os.path.abspath(logdir)
    writer = _writers.get(key)
    if writer is None or writer._fh.closed:
        writer = _writers[key] = LogWriter(logdir)
    return writer
