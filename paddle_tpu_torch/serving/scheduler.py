"""SLO-aware continuous-batching admission for the serving gateway
(counterpart of ``paddle_tpu/serving/scheduler.py``; reference: vLLM's
scheduler policy layer, Orca's iteration-level scheduling).

``PagedEngine.submit()`` is FIFO: whatever got in the engine queue
first is admitted first, regardless of who is waiting or how urgent
they are. This scheduler is the policy layer the gateway puts in front
of it — requests wait HERE, where they can still be reordered, shed or
expired, and the engine's own queue is kept empty so an admission
happens exactly when a slot frees up (iteration-level continuous
batching, not batch-level):

- **SLO classes** — ``interactive`` requests carry a TTFT deadline
  (enqueue time + ``interactive_ttft_ms``) and are served
  earliest-deadline-first; ``batch`` requests are throughput traffic
  that yields to interactive work.
- **Queue-age promotion** — a batch request queued longer than
  ``promote_after_ms`` joins the interactive pool with an
  already-expired deadline, so EDF serves it next: starvation-free
  without a separate aging thread.
- **Per-tenant fair share** — among the best-class candidates, the
  tenant with the least recently-served debt goes first;
  ``priority`` (higher wins) orders requests within a tenant.
- **Load shedding** — ``enqueue`` raises :class:`ShedError` (the
  gateway maps it to HTTP 429 + ``Retry-After``) when this queue is at
  capacity or when the engine's OWN backpressure signal (the
  ``queued``/``queue_capacity`` fields of ``PagedEngine.health()``)
  says the replica is saturated — no new saturation heuristics, the
  engine's existing ones.
- **Deadline expiry before admission** — a queued request whose hard
  deadline (``timeout_s``) passed is cancelled by ``reap()`` and
  counted in the ``timeouts`` counter BEFORE it ever takes a slot;
  the remaining deadline budget is threaded into
  ``PagedEngine.submit(timeout_s=...)`` by the gateway so in-slot
  expiry still uses the engine's own machinery.

Thread contract: ``enqueue``/``cancel`` run on the gateway's asyncio
thread, ``reap``/``pop`` on the replica's tick thread — every public
method takes the one internal lock.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import observability as obs

__all__ = ["SLO_INTERACTIVE", "SLO_BATCH", "ShedError", "ServeRequest",
           "SLOScheduler"]

SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"

# fair-share debt entries kept per scheduler (tenant ids arrive
# verbatim from clients, so the map must be bounded like the router's
# sticky table)
_DEBT_CAP = 1024


class ShedError(RuntimeError):
    """Admission refused under load. ``retry_after_s`` is the backoff
    hint the gateway surfaces as the HTTP ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServeRequest:
    """One gateway request riding through scheduler -> engine -> stream.

    ``gen`` holds the ``PagedEngine.submit`` kwargs verbatim;
    ``deadline`` is the hard monotonic cutoff (None = no cap);
    ``sink`` is the gateway's per-request asyncio event queue (opaque
    to the scheduler). Timing fields are written by the gateway's
    replica worker as the request advances."""

    __slots__ = ("request_id", "input_ids", "gen", "slo", "tenant",
                 "priority", "deadline", "t_enqueue", "digest", "sink",
                 "stream", "emitted", "t_admit", "t_first", "t_last",
                 "n_out", "promoted", "trace", "failovers", "probe",
                 "resume", "owner")

    def __init__(self, request_id, input_ids, gen: Dict[str, Any],
                 slo: str = SLO_INTERACTIVE, tenant: str = "default",
                 priority: int = 0, deadline: Optional[float] = None,
                 digest: Optional[str] = None, sink=None,
                 stream: bool = True, trace=None):
        if slo not in (SLO_INTERACTIVE, SLO_BATCH):
            raise ValueError(f"unknown SLO class {slo!r}")
        self.request_id = request_id
        self.input_ids = list(input_ids)
        self.gen = dict(gen)
        self.slo = slo
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline = deadline
        self.digest = digest
        self.sink = sink
        self.stream = bool(stream)
        self.trace = trace        # RequestTrace or None
        self.t_enqueue = time.monotonic()
        self.emitted = 0          # tokens already pushed to the sink
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None   # first-token wall (TTFT)
        self.t_last: Optional[float] = None
        self.n_out = 0
        self.promoted = False
        # fleet fault tolerance: ``failovers`` counts
        # replica-failure resubmissions against the gateway's retry
        # budget; ``resume`` holds the engine-exported descriptor
        # (prompt + committed tokens) the next _admit submits from;
        # ``probe`` marks the request as a circuit-breaker probation
        # probe; ``owner`` is the worker currently serving it (updated
        # on failover so a disconnect cancels at the RIGHT replica).
        self.failovers = 0
        self.probe = False
        self.resume: Optional[Dict[str, Any]] = None
        self.owner = None


class SLOScheduler:
    """Admission queue for ONE engine replica (the gateway runs one per
    replica, so shedding and fairness see exactly the backlog that
    replica owns)."""

    def __init__(self, max_queue: int = 256,
                 interactive_ttft_ms: float = 500.0,
                 promote_after_ms: float = 2000.0,
                 labels: Optional[Dict[str, str]] = None):
        self.max_queue = int(max_queue)
        self.interactive_ttft_s = float(interactive_ttft_ms) / 1e3
        self.promote_after_s = float(promote_after_ms) / 1e3
        self._lock = threading.Lock()
        self._q: List[ServeRequest] = []
        self._debt: Dict[str, int] = {}
        # EMA of per-request service time: the Retry-After estimate
        self._service_ema_s = 0.25
        labels = labels or {}
        reg = obs.registry()
        self._c_shed = reg.counter("gateway_sched_shed_total", **labels)
        self._c_timeout = reg.counter("gateway_sched_timeouts_total",
                                      **labels)
        self._c_promoted = reg.counter("gateway_sched_promotions_total",
                                       **labels)
        self._g_depth = reg.gauge("gateway_queue_depth", **labels)
        self._h_wait = reg.histogram("gateway_queue_wait_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **labels)

    # ------------------------------------------------------------- intake
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def enqueue(self, req: ServeRequest,
                engine_health: Optional[Dict[str, Any]] = None):
        """Admit ``req`` to the wait queue, or shed. The engine-side
        saturation check reuses ``PagedEngine.health()`` verbatim: a
        replica whose OWN bounded queue is full is overloaded by the
        engine's definition, not a new one."""
        with self._lock:
            if len(self._q) >= self.max_queue:
                self._c_shed.inc()
                raise ShedError(
                    f"scheduler queue at capacity ({self.max_queue})",
                    self._retry_after_locked())
            if engine_health is not None:
                cap = engine_health.get("queue_capacity")
                if cap is not None and \
                        engine_health.get("queued", 0) >= cap:
                    self._c_shed.inc()
                    raise ShedError(
                        "engine admission queue saturated "
                        f"({engine_health.get('queued')}/{cap})",
                        self._retry_after_locked())
            self._q.append(req)
            self._g_depth.set(len(self._q))
            if req.trace is not None:
                req.trace.ev("queue_enter", slo=req.slo,
                             tenant=req.tenant, depth=len(self._q))

    def cancel(self, request_id) -> bool:
        """Remove a still-queued request (client disconnect before
        admission). Returns False when it already left the queue."""
        with self._lock:
            for r in self._q:
                if r.request_id == request_id:
                    self._q.remove(r)
                    self._g_depth.set(len(self._q))
                    return True
        return False

    # ----------------------------------------------------------- policy
    def _edf_deadline(self, r: ServeRequest) -> float:
        """EDF key: interactive requests are due a first token
        ``interactive_ttft_ms`` after arrival; a batch request becomes
        due at its promotion age, so once promoted it is ALREADY late
        and EDF serves it ahead of fresher interactive work."""
        if r.slo == SLO_INTERACTIVE:
            return r.t_enqueue + self.interactive_ttft_s
        return r.t_enqueue + self.promote_after_s

    def reap(self, now: Optional[float] = None) -> List[ServeRequest]:
        """Remove and return every queued request whose HARD deadline
        passed — the contract: an expired request is counted
        (``timeouts``) and cancelled before it ever takes a slot."""
        now = time.monotonic() if now is None else now
        out: List[ServeRequest] = []
        with self._lock:
            for r in [r for r in self._q
                      if r.deadline is not None and now > r.deadline]:
                self._q.remove(r)
                self._c_timeout.inc()
                if r.trace is not None:
                    r.trace.ev("queue_expire", wait_ms=round(
                        (now - r.t_enqueue) * 1e3, 3))
                out.append(r)
            if out:
                self._g_depth.set(len(self._q))
        return out

    def pop(self, now: Optional[float] = None) -> Optional[ServeRequest]:
        """Next request to admit, or None. Selection: best SLO class
        (interactive, which includes promoted-batch) -> least-debt
        tenant -> highest priority -> earliest deadline."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._q:
                return None
            inter = [r for r in self._q
                     if r.slo == SLO_INTERACTIVE
                     or now - r.t_enqueue >= self.promote_after_s]
            pool = inter or self._q
            tenants: Dict[str, List[ServeRequest]] = {}
            for r in pool:
                tenants.setdefault(r.tenant, []).append(r)
            tenant = min(tenants, key=lambda t: (self._debt.get(t, 0), t))
            pick = min(tenants[tenant],
                       key=lambda r: (-r.priority, self._edf_deadline(r),
                                      r.t_enqueue))
            self._q.remove(pick)
            self._debt[tenant] = self._debt.get(tenant, 0) + 1
            if len(self._debt) > 1 and (m := min(self._debt.values())):
                # keep debt VALUES bounded; only relative order matters
                self._debt = {t: d - m for t, d in self._debt.items()}
            if len(self._debt) > _DEBT_CAP:
                # bound the tenant COUNT too (tenant ids come verbatim
                # from clients): zero-debt entries mean the same as
                # absent ones, and past that the least-indebted go —
                # forgetting a tenant only resets it to most-favored
                self._debt = {t: d for t, d in self._debt.items() if d}
                if len(self._debt) > _DEBT_CAP:
                    keep = sorted(self._debt.items(),
                                  key=lambda kv: -kv[1])[:_DEBT_CAP]
                    self._debt = dict(keep)
            if pick.slo == SLO_BATCH and pick in inter:
                pick.promoted = True
                self._c_promoted.inc()
            self._g_depth.set(len(self._q))
            self._h_wait.observe((now - pick.t_enqueue) * 1e3,
                                 exemplar=pick.request_id)
            if pick.trace is not None:
                pick.trace.ev("queue_leave", promoted=pick.promoted,
                              wait_ms=round(
                                  (now - pick.t_enqueue) * 1e3, 3))
            return pick

    # ------------------------------------------------------------ sizing
    def note_service(self, seconds: float):
        """Fold one completed request's service time into the EMA that
        sizes the Retry-After hint."""
        with self._lock:
            self._service_ema_s = (0.8 * self._service_ema_s
                                   + 0.2 * max(float(seconds), 1e-3))

    def _retry_after_locked(self) -> float:
        est = (len(self._q) + 1) * self._service_ema_s
        return round(min(max(est, 0.1), 30.0), 2)

    def snapshot(self) -> Dict[str, Any]:
        """Health fields, read from the SAME registry objects a
        /metrics scrape exports (the PR-4 pin discipline)."""
        with self._lock:
            depth = len(self._q)
        return {
            "queued": depth,
            "max_queue": self.max_queue,
            "shed": int(self._c_shed.value),
            "timeouts": int(self._c_timeout.value),
            "promotions": int(self._c_promoted.value),
            "queue_wait_ms": self._h_wait.stats(),
        }

    def debug_snapshot(self, max_entries: int = 64) -> Dict[str, Any]:
        """The /debugz view: the live queue contents (who is
        waiting, how long, with what deadline) plus the fair-share
        tenant-debt map and the service-time EMA that sizes
        Retry-After — the introspection a "why is this request stuck"
        investigation starts from."""
        now = time.monotonic()
        with self._lock:
            q = [{"request_id": str(r.request_id), "slo": r.slo,
                  "tenant": r.tenant, "priority": r.priority,
                  "age_ms": round((now - r.t_enqueue) * 1e3, 1),
                  "deadline_in_s":
                      round(r.deadline - now, 3)
                      if r.deadline is not None else None}
                 for r in self._q[:max_entries]]
            debt = dict(self._debt)
            ema = self._service_ema_s
        snap = self.snapshot()
        snap.update(queue=q, tenant_debt=debt,
                    service_ema_s=round(ema, 4))
        return snap
