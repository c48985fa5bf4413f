"""Unified observability layer (the port's copy of
``paddle_tpu/utils/observability.py``): metrics registry, span tracing,
time series, tick-phase documents and a crash flight recorder shared by
train and serve.

- **MetricsRegistry** — thread-safe labeled counters / gauges /
  histograms with ``snapshot()``, Prometheus text-format export
  (``prometheus_text()``), and a JSONL sink (``publish(writer, step)``)
  that merges registry values into the existing ``LogWriter`` stream.
- **Span tracing** — ``span("train_step", step=n)`` context manager
  emitting chrome://tracing-format events (load the flushed file in
  Perfetto / ``chrome://tracing``); each span is also a
  ``torch.profiler.record_function`` range, so it shows in a
  torch.profiler trace as the JAX package's spans show in a
  jax.profiler one. A run id + attempt id propagate to children via
  env (``$PADDLE_TPU_RUN_ID`` / ``$PADDLE_TPU_ATTEMPT``), and every
  event timestamps in epoch microseconds, so per-attempt trace files
  stitch into ONE timeline.
- **MetricsTimeSeries** — a bounded background sampler
  that turns the registry's instantaneous values into windowed
  HISTORY: per-metric ring buffers of periodic snapshots, from which
  counter *rates* and true windowed histogram quantiles are derived
  (``window(W)``), dumped as ``series_<name>.json`` beside the other
  run artifacts and served live as the gateway's ``GET /metricsz``.
  Pull-only — zero overhead on the metric write path when not
  started.
- **Tick-phase documents** — ``TICK_PHASES``, the ``tickphase/1``
  schema the paged engine's profiler dumps, and its validator.
- **Flight recorder** — a bounded ring buffer of recent structured
  events (step end, fault fires, preemption latch, serving
  admits/rejects/preemptions, and the serving fleet's failure
  lifecycle: replica fail/restart, watchdog fires, circuit-breaker
  transitions) dumped to ``<run_dir>/flight_<attempt>.json``
  on crash or SIGTERM — the 30-second postmortem a print log can't
  give.

``reset()`` stops running samplers and runs the registered flushers
(the engines' tick-phase rings) while the run dir is still configured.
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

__all__ = [
    "ENV_RUN_ID", "ENV_ATTEMPT", "run_id", "attempt_id",
    "DEFAULT_MS_BUCKETS", "SERVING_MS_BUCKETS", "BYTES_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SpanTracer", "FlightRecorder",
    "MetricsTimeSeries", "SERIES_SCHEMA",
    "quantile_from_bucket_counts", "validate_series_doc",
    "TICKPHASE_SCHEMA", "TICK_PHASES", "validate_tickphase_doc",
    "register_flusher", "unregister_flusher",
    "registry", "tracer", "recorder",
    "counter", "gauge", "histogram", "span", "record_event",
    "configure", "run_dir", "flight_path", "trace_path", "metrics_path",
    "dump_flight", "flush", "publish", "reset",
]

ENV_RUN_ID = "PADDLE_TPU_RUN_ID"
ENV_ATTEMPT = "PADDLE_TPU_ATTEMPT"

# default latency buckets (milliseconds): sub-ms serving ticks up to
# multi-minute checkpoint restores
DEFAULT_MS_BUCKETS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
                      1000, 2000, 5000, 10000, 30000, 60000)
# Serving-latency buckets: explicit 1-2-5
# log-spaced milliseconds, 0.1 ms .. 100 s. Quantiles are LINEAR
# INTERPOLATION inside the covering bucket (clamped to observed
# min/max), so the worst-case relative error of a reported p50/p99 is
# bounded by the bucket ratio (2.5x). Every serving-path latency histogram
# (gateway TTFT/TPOT, queue waits, decode-step, request attribution)
# uses THESE buckets so cross-component percentiles are comparable.
SERVING_MS_BUCKETS = (0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 50, 100,
                      200, 500, 1000, 2000, 5000, 10000, 20000,
                      50000, 100000)
# byte-sized things: checkpoint step dirs at the top, per-upload H2D
# transfers at the bottom (a one-row delta patch descriptor
# is ~0.1-2 KB, a full paged-engine mirror rebuild 10-500 KB; the
# sub-10KB rungs make the two distinguishable in one histogram)
BYTES_BUCKETS = (64, 256, 1024, 4096, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9,
                 1e10, 1e11)


def run_id() -> str:
    """Stable id for this run, minted once and published to the
    environment so spawned children (elastic relaunches, DataLoader
    workers) inherit it and their telemetry stitches into one run."""
    rid = os.environ.get(ENV_RUN_ID)
    if not rid:
        rid = uuid.uuid4().hex[:12]
        os.environ[ENV_RUN_ID] = rid
    return rid


def attempt_id() -> int:
    """Elastic attempt number: 0 for a directly-launched process,
    incremented by ``distributed.elastic.supervise`` per relaunch."""
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
        the gateway's ``GET /metrics``)."""
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


# ------------------------------------------------------------------ spans
class SpanTracer:
    """Chrome-trace ("Trace Event Format") span collector. Events
    buffer in a bounded RING (a run longer than the buffer keeps the
    most RECENT window — the one a crash-time flush needs — not the
    first N steps) and ``flush()`` writes a Perfetto /
    chrome://tracing loadable JSON object. Timestamps are EPOCH
    microseconds, so traces from separate attempts of one elastic run
    line up on a shared axis when opened together."""

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
                self._events.append(ev)     # ring: oldest falls out
                self.total_events += 1

    def instant(self, name: str, **attrs):
        """Zero-duration marker event (fault fires, latches)."""
        ev = {"name": name, "cat": "paddle_tpu_torch", "ph": "i", "s": "p",
              "ts": time.time() * 1e6, "pid": self._pid,
              "tid": threading.get_ident() & 0x7FFFFFFF, "args": attrs}
        with self._lock:
            self._events.append(ev)
            self.total_events += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def flush(self, path: str):
        """Write (atomically) the chrome-trace JSON object."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"run_id": run_id(),
                             "attempt": attempt_id(),
                             "dropped_events": dropped}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# --------------------------------------------------------- flight recorder
def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)          # numpy / torch scalars
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """Bounded ring buffer of recent structured events. Cheap enough to
    record per training step; ``dump()`` writes the whole window
    atomically for the post-crash "what just happened" read.

    Deliberately LOCK-FREE on the record path: ``record`` runs inside
    signal handlers (the preemption latch) — a handler blocking on a
    lock its own thread holds would deadlock the process. ``deque``
    append/iteration are atomic at the C level, which is exactly the
    guarantee needed here."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.total_events = 0

    def record(self, kind: str, **fields):
        ev = {"wall": time.time(), "kind": kind}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        self._events.append(ev)
        self.total_events += 1    # approximate under races; fine

    def snapshot(self) -> List[dict]:
        return list(self._events)

    def dump(self, path: str, reason: str) -> str:
        events = list(self._events)
        total = self.total_events
        doc = {"run_id": run_id(), "attempt": attempt_id(),
               "reason": reason, "dumped_wall": time.time(),
               "capacity": self.capacity, "total_events": total,
               "events": events}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# ------------------------------------------------------------- time series
SERIES_SCHEMA = "series/1"


def quantile_from_bucket_counts(bounds, counts, q: float) -> float:
    """Estimated q-quantile of a (non-cumulative) per-bucket count
    vector over the ``bounds`` grid — the same linear-interpolation
    rule :meth:`Histogram.percentile` uses, applied to a WINDOWED
    delta of two cumulative samples (so ``/metricsz?window_s=N`` can
    report the p99 of the last N seconds, not of the process
    lifetime). The +Inf tail clamps to the last finite edge; without
    observed min/max the interpolation starts at each bucket's own
    lower edge (0 for the first)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        hi = bounds[i] if i < len(bounds) else bounds[-1]
        if c:
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        lo = hi
    return float(bounds[-1])


class MetricsTimeSeries:
    """Bounded in-process time-series history over a MetricsRegistry
.

    A background daemon thread (``start()``) snapshots EVERY metric in
    the registry each ``interval_s`` into per-metric ring buffers:

    - counters / gauges → ``(t, value)`` samples; ``window(W)``
      derives the counter's RATE over the last W seconds from the
      delta between the newest sample and the last sample at-or-before
      the window start.
    - histograms → ``(t, count, sum, bucket_counts)`` samples (the
      one-lock-consistent :meth:`Histogram.export` view), so
      ``window(W)`` can subtract two cumulative samples and report
      TRUE windowed quantiles (p50/p99 of the last W seconds) via
      :func:`quantile_from_bucket_counts`, plus the windowed
      observation rate and mean.

    Torn-read-safety: every sampled read goes through the metric's own
    lock (``Counter.value`` / ``Histogram.export``) and the registry's
    item lock, so a concurrent ``observe()`` can never tear a sample;
    the sampler's own rings take ``self._lock`` against concurrent
    ``window()`` / ``to_doc()`` readers.

    Memory bound (hard): ``capacity`` samples per metric ring,
    ``max_metrics`` tracked metric series (extras are counted in
    ``dropped_metrics``, never stored). Worst case ≈
    ``max_metrics × capacity × (4 + n_buckets) × 8`` bytes — the
    defaults (512 metrics × 256 samples × ~24 floats) bound the whole
    plane under ~25 MB, and a typical serving registry (~100 metrics,
    mostly scalars) sits around 0.5 MB. Zero overhead when not
    started: nothing hooks the metric write path, ever — sampling is
    pull-only.

    ``start()`` after a ``stop()`` begins FROM ZERO (fresh rings,
    ``samples_taken`` reset) — the same per-call isolation contract
    ``elastic.supervise()`` keeps. Started samplers are tracked
    module-wide so :func:`reset` can stop their threads and flush
    their series files (``series_<name>.json`` in the run dir).

    ``hooks``: callables invoked as ``hook(now)`` after each sampling
    pass (outside the ring lock) — the burn-rate engine rides here so
    alerts resolve on wall time even when traffic stops.
    """

    def __init__(self, name: str = "default", registry=None,
                 interval_s: float = 0.25, capacity: int = 256,
                 max_metrics: int = 512, clock=time.monotonic):
        self.name = str(name)
        self._registry = registry          # None = process default
        self.interval_s = float(interval_s)
        self.capacity = max(int(capacity), 2)
        self.max_metrics = max(int(max_metrics), 1)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, Dict[str, Any]] = {}
        self._hooks: List[Any] = []
        self.samples_taken = 0
        self.dropped_metrics = 0
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sampling
    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else registry()

    def sample(self, now: Optional[float] = None) -> float:
        """One sampling pass (what the thread loops; deterministic
        tests call it directly with an injected clock)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            for name, lkey, kind, m in self._reg()._items():
                full = _full_name(name, lkey)
                ent = self._series.get(full)
                if ent is None:
                    if len(self._series) >= self.max_metrics:
                        self.dropped_metrics += 1
                        continue
                    ent = {"kind": kind,
                           "samples": deque(maxlen=self.capacity)}
                    if kind == "histogram":
                        ent["buckets"] = m.buckets
                    self._series[full] = ent
                if kind == "histogram":
                    counts, total, cnt = m.export()
                    ent["samples"].append((now, cnt, total, counts))
                else:
                    ent["samples"].append((now, m.value))
            self.samples_taken += 1
        for hook in list(self._hooks):
            try:
                hook(now)
            except Exception:
                pass   # a broken hook must not kill the sampler
        return now

    def add_hook(self, fn):
        if fn not in self._hooks:
            self._hooks.append(fn)

    # ------------------------------------------------------------- thread
    def start(self) -> "MetricsTimeSeries":
        """Start (or restart) the background sampler. A restart begins
        from zero — fresh rings, counters reset — mirroring the
        ``supervise()`` per-call isolation contract."""
        if self._thread is not None and self._thread.is_alive():
            return self
        with self._lock:
            self._series.clear()
            self.samples_taken = 0
            self.dropped_metrics = 0
        self._halt.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"metrics-sampler-{self.name}")
        self._thread.start()
        _track_sampler(self)
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 2.0):
        self._halt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        _untrack_sampler(self)

    def _loop(self):
        while not self._halt.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                pass   # telemetry must outlive any bug

    # ------------------------------------------------------------ queries
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, full_name: str) -> List[tuple]:
        with self._lock:
            ent = self._series.get(full_name)
            return list(ent["samples"]) if ent else []

    def window(self, window_s: float,
               now: Optional[float] = None) -> Dict[str, Any]:
        """The windowed view ``GET /metricsz?window_s=N`` serves:
        per metric, the rate / mean / quantiles of the last
        ``window_s`` seconds derived from the sampled rings."""
        now = self._clock() if now is None else float(now)
        lo = now - float(window_s)
        out: Dict[str, Any] = {}
        with self._lock:
            items = [(full, ent["kind"], ent.get("buckets"),
                      list(ent["samples"]))
                     for full, ent in self._series.items()]
        for full, kind, buckets, samples in items:
            if not samples:
                continue
            # rate baseline: the last sample at-or-before the window
            # start (so a window covering k samples integrates k full
            # inter-sample deltas, not k-1); fall back to the earliest
            # in-window sample when the ring doesn't reach back
            base = None
            inside = []
            for s in samples:
                if s[0] < lo:
                    base = s
                else:
                    inside.append(s)
            if not inside:
                inside = [samples[-1]]
            if base is None:
                base = inside[0]
            last = inside[-1]
            dt = last[0] - base[0]
            if kind == "counter":
                rate = (last[1] - base[1]) / dt if dt > 0 else 0.0
                out[full] = {"kind": "counter",
                             "last": last[1],
                             "delta": last[1] - base[1],
                             "rate_per_s": round(rate, 6)}
            elif kind == "gauge":
                vals = [s[1] for s in inside]
                out[full] = {"kind": "gauge",
                             "last": last[1],
                             "mean": round(sum(vals) / len(vals), 6),
                             "min": min(vals), "max": max(vals)}
            else:
                dcount = last[1] - base[1]
                dsum = last[2] - base[2]
                dcounts = [max(b - a, 0) for a, b in
                           zip(base[3], last[3])]
                rate = dcount / dt if dt > 0 else 0.0
                out[full] = {
                    "kind": "histogram",
                    "count": dcount,
                    "rate_per_s": round(rate, 6),
                    "mean": round(dsum / dcount, 6) if dcount else 0.0,
                    "p50": round(quantile_from_bucket_counts(
                        buckets, dcounts, 0.5), 6),
                    "p99": round(quantile_from_bucket_counts(
                        buckets, dcounts, 0.99), 6),
                }
        return out

    # ------------------------------------------------------------ exports
    def to_doc(self, alerts: Optional[List[dict]] = None
               ) -> Dict[str, Any]:
        """The ``series/1`` document (``validate_series_doc`` checks
        it). ``alerts`` attaches a
        burn-rate alert log so one file carries a replica's whole
        trajectory + its SLO incidents."""
        with self._lock:
            metrics = {}
            for full, ent in self._series.items():
                rec: Dict[str, Any] = {
                    "kind": ent["kind"],
                    "samples": [list(s[:3]) + [list(s[3])]
                                if ent["kind"] == "histogram"
                                else list(s)
                                for s in ent["samples"]],
                }
                if ent["kind"] == "histogram":
                    rec["buckets"] = list(ent["buckets"])
                metrics[full] = rec
            taken, dropped = self.samples_taken, self.dropped_metrics
        clock_now = self._clock()
        return {"schema": SERIES_SCHEMA, "name": self.name,
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "samples_taken": taken,
                "dropped_metrics": dropped,
                "dumped_wall": time.time(),
                "clock_now": clock_now,
                "metrics": metrics,
                "alerts": list(alerts or ())}

    def dump(self, path: str,
             alerts: Optional[List[dict]] = None) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(alerts=alerts), f)
        os.replace(tmp, path)
        return path

    def flush_series(self, alerts: Optional[List[dict]] = None
                     ) -> Optional[str]:
        """Write ``series_<name>.json`` into the configured run dir
        (no-op without one) — what a SIGTERM'd replica leaves on disk
        beside its reqtrace ring."""
        d = run_dir()
        if d is None:
            return None
        try:
            return self.dump(os.path.join(
                d, f"series_{self.name}.json"), alerts=alerts)
        except Exception:
            return None


def validate_series_doc(doc: Any) -> List[str]:
    """Schema check for a dumped time-series document (``obs_report
    --check`` runs this so the sampler's writer and ``fleet_dash``'s
    reader cannot drift apart). Returns a list of problems (empty =
    valid): schema tag, per-metric sample shapes, the ring bound
    (``len(samples) <= capacity``), monotone sample times, monotone
    counter values (what makes rate derivation sound), histogram
    bucket-vector lengths, and the alert-log entry shape."""
    bad: List[str] = []
    if not isinstance(doc, dict):
        return ["doc is not an object"]
    if doc.get("schema") != SERIES_SCHEMA:
        bad.append(f"schema != {SERIES_SCHEMA!r}: {doc.get('schema')!r}")
    cap = doc.get("capacity")
    if not isinstance(cap, int) or cap < 2:
        bad.append(f"capacity not an int >= 2: {cap!r}")
        cap = None
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        return bad + ["metrics is not an object"]
    for full, ent in metrics.items():
        where = f"metrics[{full!r}]"
        if not isinstance(ent, dict):
            bad.append(f"{where} not an object")
            continue
        kind = ent.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            bad.append(f"{where} unknown kind {kind!r}")
            continue
        samples = ent.get("samples")
        if not isinstance(samples, list):
            bad.append(f"{where}.samples not a list")
            continue
        if cap is not None and len(samples) > cap:
            bad.append(f"{where} ring bound violated: "
                       f"{len(samples)} > capacity {cap}")
        n_b = None
        if kind == "histogram":
            buckets = ent.get("buckets")
            if not isinstance(buckets, list) or not buckets:
                bad.append(f"{where}.buckets missing")
            else:
                n_b = len(buckets) + 1   # +Inf tail
        want = 2 if kind != "histogram" else 4
        prev_t = prev_v = None
        for j, s in enumerate(samples):
            if not isinstance(s, list) or len(s) != want \
                    or not all(isinstance(x, (int, float))
                               for x in s[:want - 1 if kind ==
                                          "histogram" else want]):
                bad.append(f"{where}.samples[{j}] malformed")
                continue
            t = s[0]
            if prev_t is not None and t < prev_t:
                bad.append(f"{where}.samples[{j}] time went backwards")
            prev_t = t
            if kind == "counter":
                if prev_v is not None and s[1] < prev_v:
                    bad.append(f"{where}.samples[{j}] counter "
                               f"regressed (rate would go negative)")
                prev_v = s[1]
            if kind == "histogram":
                counts = s[3]
                if not isinstance(counts, list) \
                        or (n_b is not None and len(counts) != n_b):
                    bad.append(f"{where}.samples[{j}] bucket vector "
                               f"length != len(buckets)+1")
                elif sum(counts) != s[1]:
                    bad.append(f"{where}.samples[{j}] bucket counts "
                               f"don't sum to the sample count")
    alerts = doc.get("alerts", [])
    if not isinstance(alerts, list):
        bad.append("alerts is not a list")
    else:
        for j, a in enumerate(alerts):
            if not isinstance(a, dict):
                bad.append(f"alerts[{j}] not an object")
                continue
            if a.get("kind") not in ("fire", "resolve"):
                bad.append(f"alerts[{j}] unknown kind "
                           f"{a.get('kind')!r}")
            for k in ("slo", "rule"):
                if not isinstance(a.get(k), str):
                    bad.append(f"alerts[{j}] missing {k!r}")
            if not isinstance(a.get("t"), (int, float)):
                bad.append(f"alerts[{j}] missing numeric 't'")
    return bad


# ----------------------------------------------------------- tick phases
# Tick-phase profiler document schema. The ENGINE writes
# these (``PagedEngine.dump_tick_profile`` → ``tickphase_*.json``);
# the validator lives HERE, beside the schema, so a reader can check a
# document without importing the engine.
TICKPHASE_SCHEMA = "tickphase/1"
# phase order is the tick's own: host staging/patch-pack → H2D upload
# → dispatch call → device wait (block-until-ready on the drain
# boundary) → D2H drain. ``host`` is the RESIDUAL (tick wall minus the
# explicitly bracketed phases), so the five always sum to the wall.
TICK_PHASES = ("host", "h2d", "dispatch", "device", "drain")


def validate_tickphase_doc(doc: Any) -> List[str]:
    """Schema check for a dumped tick-phase ring (``obs_report
    --check`` runs this so the engine's writer and the tools' readers
    cannot drift apart). Returns a list of problems (empty = valid):
    schema tag, the ring bound, per-entry phase fields, and the
    phase-sum-equals-wall invariant (to 1% — the residual construction
    makes it exact up to rounding)."""
    bad: List[str] = []
    if not isinstance(doc, dict):
        return ["doc is not an object"]
    if doc.get("schema") != TICKPHASE_SCHEMA:
        bad.append(f"schema != {TICKPHASE_SCHEMA!r}: "
                   f"{doc.get('schema')!r}")
    cap = doc.get("capacity")
    if not isinstance(cap, int) or cap < 1:
        bad.append(f"capacity not an int >= 1: {cap!r}")
        cap = None
    totals = doc.get("phase_totals_ms")
    if not isinstance(totals, dict) \
            or set(totals) != set(TICK_PHASES):
        bad.append("phase_totals_ms missing or wrong phase set")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return bad + ["entries is not a list"]
    if cap is not None and len(entries) > cap:
        bad.append(f"ring bound violated: {len(entries)} > "
                   f"capacity {cap}")
    prev_tick = None
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            bad.append(f"{where} not an object")
            continue
        for k in ("tick", "t", "wall_ms", "dispatches", "active") \
                + tuple(f"{p}_ms" for p in TICK_PHASES):
            if not isinstance(e.get(k), (int, float)):
                bad.append(f"{where} missing numeric {k!r}")
        if not all(isinstance(e.get(f"{p}_ms"), (int, float))
                   for p in TICK_PHASES) \
                or not isinstance(e.get("wall_ms"), (int, float)):
            continue
        wall = e["wall_ms"]
        ps = sum(e[f"{p}_ms"] for p in TICK_PHASES)
        if abs(ps - wall) > max(0.01 * wall, 0.01):
            bad.append(f"{where} phase sum {ps:.4f} != wall "
                       f"{wall:.4f}")
        t = e.get("tick")
        if prev_tick is not None and isinstance(t, (int, float)) \
                and t <= prev_tick:
            bad.append(f"{where} tick counter not increasing")
        if isinstance(t, (int, float)):
            prev_tick = t
    return bad


# --------------------------------------------------------- process default
_registry = MetricsRegistry()
_tracer = SpanTracer()
_recorder = FlightRecorder()
_run_dir: Optional[str] = None
_state_lock = threading.Lock()
# started samplers, tracked so reset() can stop their threads and
# flush their series files (a leaked sampler
# thread would keep writing into a test's fresh registry)
_samplers: List["MetricsTimeSeries"] = []
# registered flushers: callables invoked by
# reset() BEFORE the substrate is torn down, so ring-shaped state that
# lives elsewhere (the engines' tick-phase rings) lands in the run dir
# beside the series files. A flusher must be idempotent and must never
# raise through reset.
_flushers: List[Any] = []


def _track_sampler(s: "MetricsTimeSeries"):
    with _state_lock:
        if s not in _samplers:
            _samplers.append(s)


def _untrack_sampler(s: "MetricsTimeSeries"):
    with _state_lock:
        if s in _samplers:
            _samplers.remove(s)


def register_flusher(fn) -> None:
    """Register a callable reset() invokes (while the run dir is still
    configured) before tearing the substrate down — how an engine's
    tick-phase ring survives a SIGTERM-path reset."""
    with _state_lock:
        if fn not in _flushers:
            _flushers.append(fn)


def unregister_flusher(fn) -> None:
    with _state_lock:
        if fn in _flushers:
            _flushers.remove(fn)


def registry() -> MetricsRegistry:
    return _registry


def tracer() -> SpanTracer:
    return _tracer


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
    """Point the process-default observability at a run dir (the
    Trainer passes ``<output_dir>/runs`` — the same dir its JSONL
    metrics land in, so every artifact of a run lives in one place)."""
    global _run_dir
    with _state_lock:
        os.makedirs(directory, exist_ok=True)
        _run_dir = directory
    return directory


def run_dir() -> Optional[str]:
    return _run_dir


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
    """Dump the flight window (and the trace + metrics snapshot — a
    postmortem wants all three together). No-op without a configured
    run dir; never raises (a broken dump must not mask the original
    crash)."""
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
    """Write the Perfetto trace and the Prometheus text snapshot for
    the configured run dir (atomic, idempotent, safe to call often)."""
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


def reset() -> None:
    """Fresh registry / tracer / recorder and no run dir (tests).
    Running samplers are STOPPED first — and their series flushed into
    the (still-configured) run dir — so no background thread keeps
    sampling the new registry and no trajectory is silently lost
."""
    global _registry, _tracer, _recorder, _run_dir
    with _state_lock:
        samplers = list(_samplers)
        flushers = list(_flushers)
    for s in samplers:
        try:
            s.stop()
            s.flush_series()
        except Exception:
            pass
    # tick-phase rings (and any other registered ring state) flush
    # while the run dir is still configured
    for fn in flushers:
        try:
            fn()
        except Exception:
            pass
    with _state_lock:
        _samplers.clear()
        _flushers.clear()
        _registry = MetricsRegistry()
        _tracer = SpanTracer()
        _recorder = FlightRecorder()
        _run_dir = None
