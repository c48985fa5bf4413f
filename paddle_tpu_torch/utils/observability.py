"""Metrics registry, span tracer and flight recorder: the subset of
``paddle_tpu/utils/observability.py`` that the paged engine and the
trainer touch, copied so the port needs nothing of the JAX package:
``Counter``, ``Gauge``, ``Histogram``, ``MetricsRegistry``, the serving
bucket grids, ``counter`` / ``gauge`` / ``histogram``, ``span``,
``record_event``, and the run-dir artifacts (``configure``, ``flush``:
``trace_<attempt>.json`` and ``metrics.prom``; ``dump_flight``:
``flight_<attempt>.json``; ``publish`` into a ``LogWriter``), with
``run_id`` / ``attempt_id``. A span is also a
``torch.profiler.record_function`` range, so it shows in a torch.profiler
trace as the JAX package's spans show in a jax.profiler one. The time
series, tick-phase documents and ``reset`` come with the serving slice.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

ENV_RUN_ID = "PADDLE_TPU_RUN_ID"
ENV_ATTEMPT = "PADDLE_TPU_ATTEMPT"

# default latency buckets (milliseconds): sub-ms serving ticks up to
# multi-minute checkpoint restores
DEFAULT_MS_BUCKETS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
                      1000, 2000, 5000, 10000, 30000, 60000)
# Serving-latency buckets: explicit 1-2-5 log-spaced milliseconds,
# 0.1 ms .. 100 s. Quantiles are linear interpolation inside the covering
# bucket (clamped to the observed min/max), so the worst-case relative
# error of a reported p50/p99 is bounded by the bucket ratio (2.5x).
SERVING_MS_BUCKETS = (0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 50, 100,
                      200, 500, 1000, 2000, 5000, 10000, 20000,
                      50000, 100000)
# byte-sized things: per-upload host-to-device transfers at the bottom,
# checkpoint-sized transfers at the top
BYTES_BUCKETS = (64, 256, 1024, 4096, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9,
                 1e10, 1e11)


def run_id() -> str:
    """Stable id for this run, minted once and published to the
    environment so spawned children inherit it."""
    rid = os.environ.get(ENV_RUN_ID)
    if not rid:
        rid = uuid.uuid4().hex[:12]
        os.environ[ENV_RUN_ID] = rid
    return rid


def attempt_id() -> int:
    """Elastic attempt number: 0 for a directly launched process."""
    try:
        return int(os.environ.get(ENV_ATTEMPT, "0") or 0)
    except ValueError:
        return 0


# ---------------------------------------------------------------- metrics
def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _full_name(name: str, lkey: Tuple[Tuple[str, str], ...]) -> str:
    if not lkey:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in lkey)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone float counter. ``inc`` only — a counter that can go
    down is a gauge."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative
    ``le``-bounded buckets + sum + count). Quantiles are estimated by
    linear interpolation inside the covering bucket, clamped to the
    observed min/max so a lone sample reports itself, not a bucket
    edge — the estimate's relative error is therefore bounded by the
    covering bucket's hi/lo ratio (see ``SERVING_MS_BUCKETS``).

    ``observe(v, exemplar=...)`` optionally tags the covering bucket
    with an exemplar id (last-write-wins per bucket — the Prometheus
    exemplar idea, kept in-process): ``stats()["p99_exemplar"]`` then
    names a real request that landed in the p99 bucket, which is what
    lets an SLO dashboard jump from "p99 is bad" straight to one
    concrete slow request's trace."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_min", "_max",
                 "_exemplars", "_lock")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +1: +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._exemplars: List[Any] = [None] * (len(self.buckets) + 1)
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: Any = None):
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if exemplar is not None:
                self._exemplars[i] = exemplar

    def exemplar(self, q: float):
        """Exemplar tagged on the bucket covering the q-quantile (None
        when that bucket never saw a tagged observation)."""
        with self._lock:
            if self._count == 0:
                return None
            target = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if c and cum >= target:
                    return self._exemplars[i]
            return None

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1])."""
        with self._lock:
            if self._count == 0:
                return 0.0
            target = q * self._count
            cum = 0
            lo = self._min
            for i, c in enumerate(self._counts):
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                hi = min(hi, self._max)
                if c:
                    if cum + c >= target:
                        frac = (target - cum) / c
                        return max(self._min, min(self._max,
                                                  lo + frac * (hi - lo)))
                    cum += c
                # lo advances past EMPTY buckets too: the covering
                # bucket's interpolation must start at its own lower
                # edge, not several bucket-widths below it
                lo = max(lo, hi)
            return self._max

    def export(self) -> Tuple[Tuple[int, ...], float, int]:
        """One-lock consistent ``(bucket_counts, sum, count)`` view for
        exposition — piecemeal reads under concurrent ``observe()``
        would publish a sum that includes samples missing from the
        buckets."""
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": self._min if count else 0.0,
            "max": self._max if count else 0.0,
            "p50": self.percentile(0.5),
            "p99": self.percentile(0.99),
            "p99_exemplar": self.exemplar(0.99),
        }


class MetricsRegistry:
    """Thread-safe named+labeled metric store. One metric NAME has one
    kind (counter|gauge|histogram) — re-registering it as another kind
    raises, so a dashboard can trust ``# TYPE`` lines."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, tuple], Any] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, factory, labels: Dict[str, Any]):
        lkey = _label_key(labels)
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev}, "
                    f"requested {kind}")
            self._kinds[name] = kind
            m = self._metrics.get((name, lkey))
            if m is None:
                m = factory()
                self._metrics[(name, lkey)] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, Gauge, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get("histogram", name,
                         lambda: Histogram(buckets or DEFAULT_MS_BUCKETS),
                         labels)

    def _items(self) -> List[Tuple[str, tuple, str, Any]]:
        with self._lock:
            return [(name, lkey, self._kinds[name], m)
                    for (name, lkey), m in sorted(self._metrics.items())]

    def snapshot(self) -> Dict[str, Any]:
        """{full_name: value} for scalars; histograms report their
        stats dict. This is the "one source of truth" the serving
        ``health()`` endpoints read from."""
        out: Dict[str, Any] = {}
        for name, lkey, kind, m in self._items():
            full = _full_name(name, lkey)
            out[full] = m.stats() if kind == "histogram" else m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (scrape-ready; served by
        ``tools/obs_report.py --serve``)."""
        lines: List[str] = []
        typed: set = set()
        for name, lkey, kind, m in self._items():
            if name not in typed:
                lines.append(f"# TYPE {name} {kind}")
                typed.add(name)
            if kind == "histogram":
                counts, total, _ = m.export()
                cum = 0
                for i, b in enumerate(m.buckets):
                    cum += counts[i]
                    lk = lkey + (("le", f"{b:g}"),)
                    lines.append(f"{_full_name(name + '_bucket', lk)} {cum}")
                cum += counts[-1]
                lk = lkey + (("le", "+Inf"),)
                lines.append(f"{_full_name(name + '_bucket', lk)} {cum}")
                lines.append(f"{_full_name(name + '_sum', lkey)} "
                             f"{total:g}")
                lines.append(f"{_full_name(name + '_count', lkey)} {cum}")
            else:
                lines.append(f"{_full_name(name, lkey)} {m.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def publish(self, writer, step: int):
        """Merge the registry into a ``LogWriter``-compatible JSONL
        stream (same ``{"step","tag","value","wall"}`` records the
        dashboards already tail): scalars as-is, histograms as
        ``name:p50`` / ``name:p99`` / ``name:count``."""
        for name, lkey, kind, m in self._items():
            full = _full_name(name, lkey)
            if kind == "histogram":
                s = m.stats()
                if not s["count"]:
                    continue
                for suffix in ("p50", "p99", "count"):
                    writer.add_scalar(f"{full}:{suffix}", s[suffix], step)
            else:
                writer.add_scalar(full, m.value, step)


class SpanTracer:
    """Chrome-trace ("Trace Event Format") span collector: a bounded ring
    of complete events (the most recent window survives a long run);
    ``flush()`` writes a JSON object Perfetto or chrome://tracing load.
    Timestamps are epoch microseconds."""

    def __init__(self, max_events: int = 200_000):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self.total_events = 0
        self._pid = os.getpid()

    @property
    def dropped(self) -> int:
        return max(0, self.total_events - len(self._events))

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        t0 = time.time()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dur = time.time() - t0
            ev = {"name": name, "cat": "paddle_tpu_torch", "ph": "X",
                  "ts": t0 * 1e6, "dur": dur * 1e6, "pid": self._pid,
                  "tid": threading.get_ident() & 0x7FFFFFFF,
                  "args": attrs}
            with self._lock:
                self._events.append(ev)
                self.total_events += 1

    def flush(self, path: str):
        """Write (atomically) the chrome-trace JSON object."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"run_id": run_id(), "attempt": attempt_id(),
                             "dropped_events": dropped}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)          # numpy / torch scalars
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """Bounded ring buffer of recent structured events (lock-free on the
    record path: ``deque`` append is atomic); ``dump()`` writes the whole
    window atomically for the post-crash "what just happened" read."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.total_events = 0

    def record(self, kind: str, **fields):
        ev = {"wall": time.time(), "kind": kind}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        self._events.append(ev)
        self.total_events += 1

    def snapshot(self) -> List[dict]:
        return list(self._events)

    def dump(self, path: str, reason: str) -> str:
        doc = {"run_id": run_id(), "attempt": attempt_id(),
               "reason": reason, "dumped_wall": time.time(),
               "capacity": self.capacity, "total_events": self.total_events,
               "events": list(self._events)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


_registry = MetricsRegistry()
_tracer = SpanTracer()
_recorder = FlightRecorder()
_run_dir: Optional[str] = None
_state_lock = threading.Lock()


def registry() -> MetricsRegistry:
    return _registry


def recorder() -> FlightRecorder:
    return _recorder


def counter(name: str, **labels) -> Counter:
    return _registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _registry.gauge(name, **labels)


def histogram(name: str, buckets=None, **labels) -> Histogram:
    return _registry.histogram(name, buckets=buckets, **labels)


def span(name: str, **attrs):
    return _tracer.span(name, **attrs)


def record_event(kind: str, **fields):
    _recorder.record(kind, **fields)


def configure(directory: str) -> str:
    """Point the process-default observability at a run dir (the trainer
    passes ``<output_dir>/runs``, where its JSONL metrics land too)."""
    global _run_dir
    with _state_lock:
        os.makedirs(directory, exist_ok=True)
        _run_dir = directory
    return directory


def flight_path() -> Optional[str]:
    return None if _run_dir is None else os.path.join(
        _run_dir, f"flight_{attempt_id()}.json")


def trace_path() -> Optional[str]:
    return None if _run_dir is None else os.path.join(
        _run_dir, f"trace_{attempt_id()}.json")


def metrics_path() -> Optional[str]:
    return None if _run_dir is None else os.path.join(
        _run_dir, "metrics.prom")


def dump_flight(reason: str) -> Optional[str]:
    """Dump the flight window, the trace and the metrics snapshot. No-op
    without a configured run dir; never raises (a broken dump must not
    mask the original crash)."""
    path = flight_path()
    if path is None:
        return None
    try:
        out = _recorder.dump(path, reason)
        flush()
        return out
    except Exception:
        return None


def flush() -> None:
    """Write the trace and the Prometheus text snapshot into the
    configured run dir (atomic, idempotent)."""
    if _run_dir is None:
        return
    try:
        _tracer.flush(trace_path())
    except Exception:
        pass
    try:
        tmp = metrics_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(_registry.prometheus_text())
        os.replace(tmp, metrics_path())
    except Exception:
        pass


def publish(writer, step: int) -> None:
    """Merge registry values into a LogWriter JSONL stream."""
    _registry.publish(writer, step)
