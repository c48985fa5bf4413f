"""Request-scoped tracing & SLO attribution (counterpart of
``paddle_tpu/serving/reqtrace.py``; reference: the per-request timelines
production continuous-batching stacks — Orca/vLLM-style fleets in
PAPERS.md — grow once a p99 number alone stops explaining anything).

The gateway's loadgen reports p99 TTFT but nothing says WHERE a slow
request burned its budget: admission queue, prefill chunking, block
allocation, or the decode tick loop. This module is the per-request
dimension of the process-scoped observability substrate:

- **TraceContext** — :class:`RequestTrace`: minted at the gateway per
  request (honoring an inbound ``X-Request-Id``), carried on the
  :class:`~.scheduler.ServeRequest` through router → scheduler →
  ``PagedEngine.submit()`` → tick thread. Every component appends
  TYPED events (``accept``, ``route``, ``queue_enter``/``leave`` with
  EDF class + promotion, ``slot_take`` with prefix-hit tokens, each
  ``prefill_chunk``, ``first_token``, per-tick token batches with spec
  proposed/accepted, ``stream_write``, ``finish``/abort reasons) onto
  one plain Python list — host-side bookkeeping only, so default-on
  tracing changes NOTHING device-visible: streams stay bit-identical
  and the steady-tick 1-dispatch/0-upload counters stay pinned
  (``tests/test_reqtrace.py``).

- **SLO attribution** — at finish the ring derives the decomposition
  ``ttft = queue_wait + prefill + first_tick`` (the residual vs the
  accept-time TTFT is gateway parse/route overhead) and exports each
  component as labeled histograms on the explicit log-spaced
  ``SERVING_MS_BUCKETS`` grid, with exemplar request-ids tagged on the
  covering buckets — a scrape's p99 bucket names a real request whose
  retained timeline explains it.

- **Tail-based retention** — :class:`RequestTraceRing` is a bounded
  per-engine ring. FULL timelines are kept only for requests that are
  slow (``ttft > slow_ttft_ms``, a deterministic threshold — not
  random sampling), shed, expired, cancelled, or errored; healthy fast
  requests keep a one-line summary (the attribution numbers) and drop
  their event list. Ring dumps (``reqtrace_<gateway>_<replica>.json``)
  are what ``tools/trace_report.py`` joins against the loadgen's
  client-side JSONL.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import observability as obs

__all__ = ["EVENT_KINDS", "OUTCOMES", "RequestTrace",
           "RequestTraceRing", "attribution", "decode_phase_share",
           "validate_ring_doc"]

SCHEMA = "reqtrace/1"

# The typed event catalog (docs/OBSERVABILITY.md). Emitters:
#   gateway asyncio thread: accept, route, shed, stream_write
#   scheduler             : queue_enter, queue_leave, queue_expire
#   engine (tick thread)  : engine_queue, slot_take, prefill_chunk,
#                           prefill_done, tick, preempt, engine_abort,
#                           engine_finish
#   gateway tick thread   : first_token, finish
# Ring-mode engines add a ``ring_lag`` field on tick
# events: the dispatch-to-drain distance of the tokens the event
# reports (1 in steady pipelined state). A tick event's wall time is
# therefore the DRAIN time — host-visible token timing — not the
# device commit time, which ran up to ring_lag dispatches earlier;
# TTFT attribution is consistent because first_token/stream_write
# share the same drain-side clock (docs/SERVING.md).
EVENT_KINDS = frozenset({
    "accept", "route", "shed",
    "queue_enter", "queue_leave", "queue_expire",
    "engine_queue", "slot_take", "prefill_chunk", "prefill_done",
    "first_token", "tick", "stream_write",
    "preempt", "engine_abort", "engine_finish", "finish",
    # fleet fault tolerance: the failure-path events.
    #   gateway/supervisor: replica_fail (replica + reason — crash/
    #     hang/drop), watchdog_fire (stuck_ms), resubmit (to_replica +
    #     attempt), resume_offset (offset = tokens the client already
    #     saw, committed = engine-committed prefix length)
    #   breaker lifecycle, attached to the requests that witness it:
    #     breaker_open rides the failing requests' traces,
    #     breaker_half_open / breaker_close ride the probe request's
    "replica_fail", "watchdog_fire", "resubmit", "resume_offset",
    "breaker_open", "breaker_half_open", "breaker_close",
    # multi-host fleet: emitted by the fleet FRONTEND's own
    # trace ring. ``proxy_to`` = the stream is being proxied to a peer
    # gateway (replica + attempt); ``peer_fail`` = that peer died /
    # dropped the connection mid-stream (reason) — the resubmit /
    # resume_offset events that follow are the cross-PROCESS failover
    # hop trace_report's fleet merge follows by request id.
    "proxy_to", "peer_fail",
})

# terminal outcomes a ring entry records (finish_reason superset)
OUTCOMES = ("stop", "timeout", "expired", "shed", "cancelled",
            "disconnect", "error")


class RequestTrace:
    """One request's typed-event timeline. Event appends come from two
    threads (the gateway's asyncio thread and the replica's tick
    thread); ``list.append`` is atomic at the C level, which is the
    only guarantee the timeline needs — event ORDER between threads is
    best-effort, the per-event timestamp is authoritative."""

    __slots__ = ("request_id", "tenant", "slo", "t0", "wall0",
                 "events", "done")

    def __init__(self, request_id, tenant: str = "default",
                 slo: str = "interactive"):
        self.request_id = str(request_id)
        self.tenant = str(tenant)
        self.slo = str(slo)
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        self.events: List[Any] = []
        self.done = False

    def ev(self, kind: str, t_ms: Optional[float] = None, **fields):
        """Append one typed event at ``t_ms`` milliseconds after the
        trace was minted (default: now). ``t_ms`` exists for synthetic
        timelines (tests, ``obs_report --check``)."""
        if t_ms is None:
            t_ms = (time.monotonic() - self.t0) * 1e3
        self.events.append((round(float(t_ms), 3), kind, fields))

    def mark(self, kind: str) -> Optional[float]:
        """Time (ms since accept) of the FIRST event of ``kind``."""
        for t, k, _ in self.events:
            if k == kind:
                return t
        return None


def attribution(trace: RequestTrace) -> Dict[str, Optional[float]]:
    """The SLO decomposition: ``ttft = queue_wait + prefill +
    first_tick`` (+ the accept→enqueue parse/route residual).

    - ``queue_wait_ms``  — ``queue_enter`` → ``slot_take`` (scheduler
      EDF queue + the tick loop's admission latency)
    - ``prefill_ms``     — ``slot_take`` → ``prefill_done`` (chunked
      prefill compute; prefix-cache hits shrink it)
    - ``first_tick_ms``  — ``prefill_done`` → ``first_token`` (this
      engine samples the first token ON the final prefill chunk, so
      this component is the dispatch/hold path that gets it onto the
      stream; for engines that decode it, the first decode tick rides
      here too)
    - ``ttft_ms``        — ``accept`` (t=0) → ``first_token``

    Components are None when their bracketing events never happened
    (shed before queue, expired before a slot, ...)."""
    qe = trace.mark("queue_enter")
    st = trace.mark("slot_take")
    pd = trace.mark("prefill_done")
    ft = trace.mark("first_token")

    def _d(a, b):
        return round(b - a, 3) if a is not None and b is not None \
            else None

    return {
        "ttft_ms": round(ft, 3) if ft is not None else None,
        "queue_wait_ms": _d(qe, st),
        "prefill_ms": _d(st, pd),
        "first_tick_ms": _d(pd, ft),
    }


def decode_phase_share(trace: "RequestTrace") -> Optional[Dict[str, float]]:
    """Per-request decode-phase attribution: sum the
    ``phase`` splits the engine attaches to this request's ``tick``
    events (present only when the engine runs with ``tick_profile=on``)
    and normalize to FRACTIONS of the summed tick wall. This is the
    request-granular face of the engine's tick-phase profiler — "of the
    ticks that advanced THIS request, what share went to host vs
    dispatch vs device vs drain". Returns None when no tick carried a
    phase split (profiler off, or the request never reached decode)."""
    totals: Dict[str, float] = {}
    wall = 0.0
    n = 0
    for _, k, fields in trace.events:
        if k != "tick":
            continue
        ph = fields.get("phase")
        if not isinstance(ph, dict):
            continue
        w = float(ph.get("wall_ms", 0.0))
        if w <= 0.0:
            continue
        n += 1
        wall += w
        for pk, pv in ph.items():
            if pk == "wall_ms" or not pk.endswith("_ms"):
                continue
            totals[pk[:-3]] = totals.get(pk[:-3], 0.0) + float(pv)
    if n == 0 or wall <= 0.0:
        return None
    out = {f"{p}_frac": round(v / wall, 4) for p, v in totals.items()}
    out["ticks"] = n
    out["wall_ms"] = round(wall, 3)
    return out


class RequestTraceRing:
    """Bounded per-engine ring of finished request timelines, plus the
    attribution histograms derived from them (registered in the global
    observability registry under this ring's labels — the same objects
    a /metrics scrape exports, the PR-4 pin discipline)."""

    def __init__(self, capacity: int = 512,
                 slow_ttft_ms: float = 500.0,
                 labels: Optional[Dict[str, str]] = None):
        self.capacity = int(capacity)
        self.slow_ttft_ms = float(slow_ttft_ms)
        self.labels = {k: str(v) for k, v in (labels or {}).items()}
        self._ring: deque = deque(maxlen=self.capacity)
        # finish observers: called once per closed trace
        # with the appended entry — the ring's ``trace.done`` latch is
        # the dedupe point, so the SLO burn-rate engine riding here
        # sees each request's terminal outcome EXACTLY once even when
        # a disconnect races a tick-thread finish
        self.observers: list = []
        self._lock = threading.Lock()
        reg = obs.registry()
        self._c_traced = reg.counter("request_traces_total",
                                     **self.labels)
        self._c_retained = reg.counter("request_traces_retained_total",
                                       **self.labels)
        self._hists: Dict[tuple, Any] = {}

    # ------------------------------------------------------------ metrics
    def _hist(self, name: str, slo: str, **extra):
        key = (name, slo, tuple(sorted(extra.items())))
        h = self._hists.get(key)
        if h is None:
            h = obs.registry().histogram(
                name, buckets=obs.SERVING_MS_BUCKETS, slo=slo,
                **extra, **self.labels)
            self._hists[key] = h
        return h

    # ------------------------------------------------------------- finish
    def finish(self, trace: Optional[RequestTrace], outcome: str,
               tokens: int = 0,
               tpot_ms: Optional[float] = None) -> Optional[dict]:
        """Close a trace: derive attribution, feed the histograms
        (exemplar = the request id), apply the deterministic tail
        retention rule, append the entry. Idempotent per trace (the
        first finisher wins — a disconnect racing a tick-thread finish
        must not double-count)."""
        if trace is None:
            return None
        with self._lock:
            if trace.done:
                return None
            trace.done = True
        comps = attribution(trace)
        slo = trace.slo
        self._c_traced.inc()
        if comps["ttft_ms"] is not None:
            self._hist("request_ttft_ms", slo).observe(
                comps["ttft_ms"], exemplar=trace.request_id)
        for phase in ("queue_wait", "prefill", "first_tick"):
            v = comps[f"{phase}_ms"]
            if v is not None:
                self._hist("request_phase_ms", slo,
                           phase=phase).observe(
                    v, exemplar=trace.request_id)
        slow = comps["ttft_ms"] is not None \
            and comps["ttft_ms"] > self.slow_ttft_ms
        # a failed-over request's timeline is retained even
        # when it finished fast and clean — the failover hop is exactly
        # what a postmortem needs to see
        failovers = sum(1 for _, k, _ in trace.events if k == "resubmit")
        retain = slow or outcome != "stop" or failovers > 0
        entry = {
            "request_id": trace.request_id,
            "tenant": trace.tenant,
            "slo": slo,
            "outcome": outcome,
            "tokens": int(tokens),
            "tpot_ms": round(tpot_ms, 3) if tpot_ms is not None
            else None,
            "wall_accept": trace.wall0,
            "slow": slow,
            "failovers": failovers,
            "retained": retain,
            "events": [list(e) for e in trace.events] if retain
            else [],
            **comps,
        }
        # per-request decode phase attribution, present only
        # when the engine ran with tick_profile on (extra entry keys
        # are schema-tolerated, like the fleet fields above)
        share = decode_phase_share(trace)
        if share is not None:
            entry["phase_share"] = share
        if retain:
            self._c_retained.inc()
        self._ring.append(entry)
        for fn in list(self.observers):
            try:
                fn(entry)
            except Exception:
                pass   # an observer bug must not break request finish
        return entry

    # ----------------------------------------------------------- exports
    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def summary(self, recent: int = 8) -> Dict[str, Any]:
        """The /debugz view: counters plus the last few entries WITHOUT
        their event lists (timelines ride in the dump / snapshot)."""
        entries = list(self._ring)
        return {
            "capacity": self.capacity,
            "slow_ttft_ms": self.slow_ttft_ms,
            "traced": int(self._c_traced.value),
            "retained": int(self._c_retained.value),
            "buffered": len(entries),
            "recent": [{k: v for k, v in e.items() if k != "events"}
                       for e in entries[-recent:]],
        }

    def to_doc(self) -> Dict[str, Any]:
        return {"schema": SCHEMA, "dumped_wall": time.time(),
                "capacity": self.capacity,
                "slow_ttft_ms": self.slow_ttft_ms,
                "labels": dict(self.labels),
                "entries": self.snapshot()}

    def dump(self, path: str) -> str:
        """Atomic JSON dump (the artifact ``tools/trace_report.py``
        ingests; the gateway writes one per replica on drain)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f)
        os.replace(tmp, path)
        return path


def validate_ring_doc(doc: Any) -> List[str]:
    """Schema check for a dumped ring (``obs_report --check`` runs this
    so the writer and ``trace_report``'s reader cannot drift apart).
    Returns a list of problems (empty = valid)."""
    bad: List[str] = []
    if not isinstance(doc, dict):
        return ["doc is not an object"]
    if doc.get("schema") != SCHEMA:
        bad.append(f"schema != {SCHEMA!r}: {doc.get('schema')!r}")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return bad + ["entries is not a list"]
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            bad.append(f"{where} not an object")
            continue
        for k in ("request_id", "slo", "outcome", "retained",
                  "events"):
            if k not in e:
                bad.append(f"{where} missing {k!r}")
        if e.get("outcome") not in OUTCOMES:
            bad.append(f"{where} unknown outcome {e.get('outcome')!r}")
        for k in ("ttft_ms", "queue_wait_ms", "prefill_ms",
                  "first_tick_ms"):
            v = e.get(k, "absent")
            if v is not None and not isinstance(v, (int, float)):
                bad.append(f"{where}.{k} not numeric/None: {v!r}")
        evs = e.get("events", [])
        if not isinstance(evs, list):
            bad.append(f"{where}.events not a list")
            continue
        if e.get("retained") is False and evs:
            bad.append(f"{where} dropped entry still carries events")
        for j, ev in enumerate(evs):
            if (not isinstance(ev, (list, tuple)) or len(ev) != 3
                    or not isinstance(ev[0], (int, float))
                    or not isinstance(ev[2], dict)):
                bad.append(f"{where}.events[{j}] not [t_ms, kind, "
                           f"fields]")
            elif ev[1] not in EVENT_KINDS:
                bad.append(f"{where}.events[{j}] unknown kind "
                           f"{ev[1]!r}")
    return bad
