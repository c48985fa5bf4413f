"""Replica supervision for the serving fleet (counterpart of
``paddle_tpu/serving/supervisor.py``; reference: the supervisor/health-
check loops production LLM fleets run in front of continuous-batching
replicas — k8s liveness probes + envoy-style outlier ejection, restated
in-process over the gateway's replica workers).

Before this module, a replica failure was terminal three different
ways: a tick-thread crash ran ``_fail_all`` and errored every live
stream, a hung fused dispatch hung every client on that replica
forever (nothing watched the tick thread), and the router's health
eviction had no rejoin path — the fleet only ever shrank. The
supervisor closes all three:

- **Watchdog** — a daemon thread polls every replica worker. A dead
  tick thread (crash, or the ``replica_drop`` fault site's silent
  exit) is detected by ``Thread.is_alive``; a STUCK dispatch is
  detected by a deadline on the worker's dispatch-to-drain latency
  (``t_busy`` is set before the engine step — which, in ring mode,
  includes draining the previous dispatch — and cleared after the
  token dispatch; busy longer than ``dispatch_timeout_s`` fires the
  watchdog). Either way the replica is marked unhealthy, ABANDONED
  (the old thread, if it ever wakes, checks the flag and exits without
  touching shared state), its live requests are handed to the
  gateway's failover path (``Gateway._failover_worker`` — resubmit as
  ``prompt + committed tokens`` on a surviving replica), and its
  engine is rebuilt.

- **Rebuild** — ``engine_factory`` (when the gateway was given one)
  constructs a FRESH engine; otherwise ``PagedEngine.hard_reset()``
  rebuilds the existing engine's pools/mirrors in place (fresh device
  tensors — the dead program may still own the old ones; the built
  kernels survive, the tick graphs are captured again). A new tick
  thread takes over the replica name,
  scheduler, trace ring and metric labels.

- **Circuit breaker** — the rebuilt replica does NOT rejoin rotation
  directly. Its :class:`CircuitBreaker` opened on the failure
  (exponential backoff, doubling per consecutive failure); after the
  backoff it goes HALF-OPEN, and the router diverts exactly ONE live
  request at a time to it as a probation probe. ``probes_to_close``
  probe successes close the breaker and the replica re-enters the
  warm -> sticky -> least-loaded ladder; a probe failure re-opens it
  with a longer backoff. Permanent eviction is gone — a replica that
  keeps failing just probes ever more rarely.

Everything here is host-side bookkeeping on its own thread; the hot
serving path gains one timestamp write per tick.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils import observability as obs

__all__ = ["CircuitBreaker", "ReplicaSupervisor"]

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# /debugz + gauge encoding of the state machine (docs/SERVING.md)
_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1, BREAKER_HALF_OPEN: 2}


class CircuitBreaker:
    """Half-open circuit breaker gating one replica's traffic.

    closed --failure--> open --(backoff elapses, next route)-->
    half_open --probe success x probes_to_close--> closed
              --probe failure--> open (backoff doubled)

    ``failure_threshold`` consecutive failures open the breaker
    (default 1: a replica crash is conclusive on its own). The backoff
    before the first probe is ``backoff_s * factor**(opens-1)`` capped
    at ``backoff_max_s``. While HALF-OPEN, ``try_probe`` hands out AT
    MOST ONE in-flight probe at a time — the router calls it, and the
    request's terminal path reports ``probe_done``.

    Thread contract: called from the router (asyncio thread), the
    replica tick threads and the supervisor; one internal lock.
    ``clock`` is injectable for deterministic unit tests."""

    def __init__(self, failure_threshold: int = 1,
                 probes_to_close: int = 1,
                 backoff_s: float = 1.0, backoff_factor: float = 2.0,
                 backoff_max_s: float = 30.0,
                 on_state: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.probes_to_close = max(int(probes_to_close), 1)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self._on_state = on_state
        self._clock = clock
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self._consecutive = 0      # consecutive failures while closed
        self._opens = 0            # total opens (drives the backoff)
        self._probe_ok = 0         # successes this half-open episode
        self._probe_inflight = False
        self._reopen_at = 0.0

    # ----------------------------------------------------------- internals
    def _set(self, state: str):
        if state == self.state:
            return
        self.state = state
        if self._on_state is not None:
            try:
                self._on_state(state)
            except Exception:
                pass   # a callback must never wedge the state machine

    def _open_locked(self):
        self._opens += 1
        self._probe_ok = 0
        self._probe_inflight = False
        back = min(self.backoff_s
                   * self.backoff_factor ** (self._opens - 1),
                   self.backoff_max_s)
        self._reopen_at = self._clock() + back
        self._set(BREAKER_OPEN)

    # -------------------------------------------------------------- events
    def record_failure(self):
        """A replica-level failure (crash / hang / probe failure)."""
        with self._lock:
            self._consecutive += 1
            if self.state == BREAKER_HALF_OPEN \
                    or self._consecutive >= self.failure_threshold:
                self._open_locked()

    def record_success(self):
        """A non-probe success while closed: clears the consecutive-
        failure count (a threshold > 1 needs uninterrupted failures)."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                self._consecutive = 0

    def try_probe(self) -> bool:
        """Router hook: True iff THIS request should be the probation
        probe (open + backoff elapsed promotes to half-open first;
        half-open with no probe in flight claims the slot)."""
        with self._lock:
            if self.state == BREAKER_OPEN \
                    and self._clock() >= self._reopen_at:
                self._set(BREAKER_HALF_OPEN)
            if self.state != BREAKER_HALF_OPEN or self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def rearm(self):
        """Restart the open-state backoff clock. The supervisor calls
        this when a rebuilt replica actually becomes READY: the
        probation window must not open while the engine is still being
        rebuilt/warmed, or every probe in that gap burns a request
        against a dead worker. A half-open breaker whose probe slot is
        free drops back to open; an in-flight probe is left alone."""
        with self._lock:
            if self.state == BREAKER_HALF_OPEN \
                    and not self._probe_inflight:
                self._set(BREAKER_OPEN)
            if self.state == BREAKER_OPEN:
                back = min(self.backoff_s * self.backoff_factor
                           ** max(self._opens - 1, 0),
                           self.backoff_max_s)
                self._reopen_at = max(self._reopen_at,
                                      self._clock() + back)

    def probe_done(self, success: Optional[bool]):
        """Terminal report for an in-flight probe. ``True`` counts
        toward closing, ``False`` re-opens (longer backoff), ``None``
        (client disconnect / deadline — proves nothing either way)
        just releases the probe slot."""
        with self._lock:
            if not self._probe_inflight:
                return
            self._probe_inflight = False
            if self.state != BREAKER_HALF_OPEN:
                return
            if success is True:
                self._probe_ok += 1
                if self._probe_ok >= self.probes_to_close:
                    self._consecutive = 0
                    self._opens = 0
                    self._probe_ok = 0
                    self._set(BREAKER_CLOSED)
            elif success is False:
                self._open_locked()

    # ------------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "state_code": _STATE_CODE[self.state],
                "opens": self._opens,
                "consecutive_failures": self._consecutive,
                "probe_inflight": self._probe_inflight,
                "probe_successes": self._probe_ok,
                "reopen_in_s": round(
                    max(self._reopen_at - self._clock(), 0.0), 3)
                if self.state == BREAKER_OPEN else 0.0,
            }


class ReplicaSupervisor(threading.Thread):
    """Per-gateway watchdog/restart loop (one daemon thread for the
    whole fleet; per-replica state lives on the workers/breakers).

    The supervisor is intentionally the ONLY writer of replica
    replacement: the tick threads detect their own crashes (and run
    the failover hand-off inline, so requests move the moment the
    exception surfaces), but rebuild + rejoin always happen here —
    one thread, no racing restarts."""

    def __init__(self, gateway, check_interval_s: float = 0.05,
                 dispatch_timeout_s: float = 30.0):
        super().__init__(daemon=True,
                         name=f"supervisor-{gateway.name}")
        self.gw = gateway
        self.check_interval_s = float(check_interval_s)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._halt = threading.Event()
        reg = obs.registry()
        self._c_watchdog = reg.counter("gateway_watchdog_fires_total",
                                       **gateway._labels)
        self._g_breaker: Dict[str, Any] = {}

    def stop(self, timeout: float = 5.0):
        self._halt.set()
        if self.is_alive():
            self.join(timeout)

    # ------------------------------------------------------------ the loop
    def run(self):
        while not self._halt.wait(self.check_interval_s):
            try:
                self._check_once()
            except Exception as e:   # supervision must outlive any bug
                obs.record_event("supervisor_error",
                                 gateway=self.gw.name, err=repr(e))

    def _check_once(self):
        now = time.monotonic()
        for w in list(self.gw._workers):
            if w.draining:
                continue
            if w.failed:
                # already failed over (the crash path runs
                # _failover_worker on the dying tick thread) but still
                # in _workers: the rebuild is ours. A rebuilt worker
                # replaces this entry; ``rebuild_failed`` latches the
                # permanent-eviction path so a raising factory is not
                # retried every pass.
                self._spawn_rebuild(w, w.fail_reason or "crash")
                continue
            if w.abandoned:
                continue           # defensive: failed should be set too
            started = w.ident is not None
            if started and not w.is_alive():
                # dead tick thread WITHOUT the failed latch: a
                # replica_drop-style silent exit — nothing on the dying
                # thread ran, so failover is ours too
                self.gw._failover_worker(w, reason="drop")
                self._spawn_rebuild(w, "drop")
                continue
            t_busy = w.t_busy
            # a cold engine's FIRST dispatches pay the kernel builds
            # and graph captures: 10x grace until one dispatch lands
            limit = self.dispatch_timeout_s * (1.0 if w.warmed
                                               else 10.0)
            if t_busy is not None and now - t_busy > limit:
                # stuck dispatch: the thread has been inside one
                # step/drain longer than the deadline
                self._c_watchdog.inc()
                obs.record_event("gateway_watchdog_fire",
                                 gateway=self.gw.name,
                                 replica=w.replica.name,
                                 stuck_s=round(now - t_busy, 3))
                lost = getattr(w.engine, "check_lost", None)
                if lost is not None:
                    # a tp replica stuck inside a sequenced step may
                    # wait on a rank that is gone: it ends there
                    lost(now - t_busy)
                self.gw._failover_worker(
                    w, reason="hang",
                    stuck_ms=round((now - t_busy) * 1e3, 1))
                self._spawn_rebuild(w, "hang")
        self._export_breaker_gauges()

    def _spawn_rebuild(self, worker, reason: str):
        """Run the (possibly expensive — engine_factory may compile)
        rebuild OFF the detection loop: failover hand-off is the
        latency-critical half and already happened; a slow rebuild of
        one replica must not delay watchdog detection for the others.
        One rebuild per worker at a time (``rebuilding`` latch)."""
        if worker.rebuild_failed or worker.rebuilding:
            return
        if self.gw._engine_factory is None and worker.is_alive():
            # the in-place reset must wait for the thread to die —
            # spawning a thread per pass just to discover that would
            # churn dozens of threads/second during a long hang
            return
        worker.rebuilding = True
        threading.Thread(
            target=self._rebuild, args=(worker, reason), daemon=True,
            name=f"rebuild-{self.gw.name}-{worker.replica.name}"
        ).start()

    # ------------------------------------------------------------- rebuild
    def _rebuild(self, worker, reason: str):
        """Replace ``worker`` with a fresh tick thread over a rebuilt
        engine; the breaker (already OPEN from the failover hand-off)
        gates its rejoin.

        A hung worker whose thread is STILL ALIVE gets an in-place
        ``hard_reset`` only once the thread has actually died: a
        slow-but-not-wedged step could otherwise return AFTER the
        reset and clobber the replacement's state dict/pools with its
        own. The injected ``dispatch_hang`` wakes and exits via the
        abandoned guard, so deferral is brief; a truly wedged dispatch
        keeps the replica evicted until an ``engine_factory`` can give
        the replacement an isolated engine. (With a factory, a
        replacement SHARING the old model object still serializes on
        the hung thread's per-model tick lock — safe, but it rejoins
        only when the hang clears; give replicas distinct model
        instances, as the chaos loadgen does, for full isolation.)"""
        gw = self.gw
        replica = worker.replica
        if gw._draining:
            worker.rebuilding = False
            return          # a draining fleet never rebuilds (an
                            # in-flight rebuild thread can outlive
                            # supervisor.stop())
        if gw._engine_factory is None and worker.is_alive():
            worker.rebuilding = False
            return          # retried next pass until the thread dies
        obs.registry().counter("replica_restarts_total",
                               reason=reason, **gw._labels).inc()
        if gw._spill_arena is not None and reason != "hang":
            # the dying engine's device pools still live in THIS
            # process: salvage its parked and live spans into the
            # host arena before the factory/hard_reset discards them
            # — the rebuilt worker
            # restores instead of re-prefilling. A hung worker is
            # skipped: its wedged thread may still be touching the
            # pools mid-step.
            try:
                if hasattr(worker.engine, "spill_parked"):
                    worker.engine.spill_parked()
                if hasattr(worker.engine, "spill_live"):
                    worker.engine.spill_live()
            except Exception:
                pass        # salvage only costs warmth, never safety
        try:
            if gw._engine_factory is not None:
                engine = gw._engine_factory()
            else:
                # rebuild in place: fresh pools/mirrors on the same
                # engine object (safe — the old thread is DEAD, gated
                # above)
                engine = worker.engine
                engine.hard_reset()
        except Exception as e:
            obs.record_event("gateway_rebuild_failed",
                             gateway=gw.name, replica=replica.name,
                             err=repr(e))
            # breaker stays open and the latch below stops retries: a
            # failed rebuild evicts the replica permanently (the
            # pre-supervisor behavior)
            worker.rebuild_failed = True
            return
        replica.engine = engine
        new_w = gw._make_worker(replica, sched=worker.sched,
                                ring=worker.ring)
        with gw._fo_lock:
            if gw._draining:
                # drain began while the factory ran: never swap a
                # fresh non-draining worker into a draining fleet
                worker.rebuilding = False
                return
            new_w.draining = gw._draining
            idx = gw._workers.index(worker)
            gw._workers[idx] = new_w
            gw._by_replica[replica] = new_w
        new_w.start()
        b = getattr(replica, "breaker", None)
        if b is not None:
            # probation starts NOW that the replica is ready, not when
            # the failure happened — a rebuild slower than the backoff
            # must not leak probes onto a dead worker
            b.rearm()
        obs.record_event("gateway_replica_restart", gateway=gw.name,
                         replica=replica.name, reason=reason)

    def _export_breaker_gauges(self):
        """``gateway_breaker_state`` gauge per replica (0 closed /
        1 open / 2 half-open) — the scrapeable face of /debugz's
        breaker section."""
        reg = obs.registry()
        for w in list(self.gw._workers):
            b = getattr(w.replica, "breaker", None)
            if b is None:
                continue
            g = self._g_breaker.get(w.replica.name)
            if g is None:
                g = reg.gauge("gateway_breaker_state",
                              replica=w.replica.name,
                              **self.gw._labels)
                self._g_breaker[w.replica.name] = g
            g.set(_STATE_CODE[b.state])
