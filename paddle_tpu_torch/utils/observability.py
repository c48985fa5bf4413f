"""Metrics registry and flight recorder: the subset of
``paddle_tpu/utils/observability.py`` that the paged engine touches
(``Counter``, ``Histogram``, ``MetricsRegistry``, ``registry()``,
``record_event`` and the serving bucket grids), copied so the port needs
nothing of the JAX package. The span tracer, time series and run-dir
artifacts come with the serving slice.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Tuple

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



class FlightRecorder:
    """Bounded ring buffer of recent structured events (lock-free on the
    record path: ``deque`` append is atomic)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.total_events = 0

    def record(self, kind: str, **fields):
        ev = {"wall": time.time(), "kind": kind}
        ev.update(fields)
        self._events.append(ev)
        self.total_events += 1

    def snapshot(self) -> List[dict]:
        return list(self._events)


_registry = MetricsRegistry()
_recorder = FlightRecorder()


def registry() -> MetricsRegistry:
    return _registry


def recorder() -> FlightRecorder:
    return _recorder


def record_event(kind: str, **fields):
    _recorder.record(kind, **fields)
