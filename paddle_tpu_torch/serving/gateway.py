"""Async HTTP/SSE serving gateway over PagedEngine (counterpart of
``paddle_tpu/serving/gateway.py``; reference: vLLM's OpenAI front end +
continuous-batching engine loop, restated stdlib-only).

This is the front door: the piece that turns
"an engine" into "a service". Dependency policy matches
``tools/obs_report.py --serve`` — stdlib only (``asyncio`` +
hand-parsed HTTP/1.1 over ``asyncio.start_server``), so the gateway
runs anywhere the engine does.

Architecture (one process, N replicas):

- **HTTP layer (asyncio)** — ``POST /v1/generate`` takes a JSON body
  (token-id prompt + sampling params + SLO class/tenant/priority) and
  answers either a JSON completion or an SSE token stream
  (``text/event-stream``, one ``data:`` event per token, a final
  ``done`` event carrying the full stop-trimmed token list).
  ``GET /healthz`` is the aggregated health snapshot; ``GET /metrics``
  serves the live observability registry in Prometheus text format —
  the same objects ``health()`` reads, pinned equal by test.
- **Replica workers (one thread per engine)** — ``PagedEngine`` is
  single-threaded by design, so ALL engine access (submit / step /
  cancel) happens on that replica's tick thread. The thread loop:
  drain posted control ops (cancels), reap scheduler-expired requests,
  admit from the :class:`SLOScheduler` exactly while the engine has a
  free slot and an empty queue (iteration-level continuous batching —
  the policy queue stays in the scheduler where it can still be
  reordered or shed), then one ``engine.step()`` and a token dispatch
  that mirrors ``PagedEngine.stream()``'s hold-back semantics, so a
  gateway SSE stream is BIT-IDENTICAL to a direct engine stream (a
  yielded token is never retracted by a stop trim). Ring-mode engines
 surface each dispatch's tokens on the NEXT
  ``step()`` — the tick thread consumes drained ring entries exactly
  as it consumed the synchronous readback, so the dispatch loop below
  is readback-architecture agnostic: against a ``ring_mode=False``
  engine the SSE byte stream is bitwise the pre-ring one, and in ring
  mode each request's byte stream is identical with token batches
  landing one tick later (cancels posted to the tick thread drain the
  in-flight dispatch before releasing the slot — ``/debugz`` shows
  per-engine ring drain/blocking counters).
- **Router** — :class:`PrefixAffinityRouter` keyed by
  ``PagedEngine.prefix_digest()`` picks the replica whose prefix cache
  already holds the prompt's shared span (least-loaded fallback,
  health eviction).
- **Drain** — SIGTERM (via ``utils.shutdown.GracefulShutdown``) latches
  draining: new requests get 503 + Retry-After, in-flight requests
  finish, workers exit once their engines are empty, metrics flush
  (``observability.flush()``), the listener closes. Rolling restarts
  lose nothing that already got a slot.

Token events cross from tick threads to the asyncio loop via
``loop.call_soon_threadsafe`` onto per-request queues; a client that
disconnects mid-stream is detected at the SSE writer (EOF watch or a
failed ``drain()``) and its request is cancelled ON THE TICK THREAD
(``engine.cancel`` frees the slot and blocks immediately — a dropped
stream never strands a slot).
"""
from __future__ import annotations

import asyncio
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..ops.kernels import launch_counts
from ..utils import faults
from ..utils import observability as obs
from ..utils.faults import BackpressureError
from ..utils.shutdown import GracefulShutdown
from . import kvxfer
from .reqtrace import RequestTrace, RequestTraceRing
from .router import EngineReplica, NoReplicaError, PrefixAffinityRouter
from .scheduler import (SLO_BATCH, SLO_INTERACTIVE, ServeRequest,
                        ShedError, SLOScheduler)
from .slo import BurnRateEngine
from .supervisor import BREAKER_CLOSED, CircuitBreaker, ReplicaSupervisor

__all__ = ["Gateway"]

_gateway_ids = itertools.count()

_SSE_HEAD = (b"HTTP/1.1 200 OK\r\n"
             b"Content-Type: text/event-stream\r\n"
             b"Cache-Control: no-cache\r\n"
             b"Connection: close\r\n\r\n")


def _http_response(status: int, body: bytes,
                   ctype: str = "application/json",
                   extra: Dict[str, str] = None) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests", 500: "Internal Server Error",
              503: "Service Unavailable", 504: "Gateway Timeout"}.get(
                  status, "OK")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: int, payload: Dict[str, Any],
                   extra: Dict[str, str] = None) -> bytes:
    return _http_response(status, json.dumps(payload).encode(),
                          extra=extra)


def _query_param(query: str, key: str, conv=float):
    """``?key=value`` lookup in a raw query string (last occurrence
    wins), parsed with ``conv``; None when absent or unparseable.
    Shared by the gateway's and the fleet frontend's HTTP handlers."""
    out = None
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == key:
            try:
                out = conv(v)
            except ValueError:
                pass
    return out


def _release_probe(req: ServeRequest, replica, success=None):
    """Report a probation probe's terminal outcome to its breaker.
    EVERY path that terminates a probe request must come through here
    (or probe_done directly): a probe that ends without reporting
    leaks the breaker's single in-flight slot and the replica can
    never rejoin. ``None`` = inconclusive (expiry/shed/disconnect —
    releases the slot without moving the state machine)."""
    if req.probe:
        b = getattr(replica, "breaker", None)
        if b is not None:
            b.probe_done(success)
        req.probe = False


class _ReplicaWorker(threading.Thread):
    """Owns ONE PagedEngine: the only thread that ever touches it.

    ``tick_lock`` serializes ``engine.step()`` across replicas that
    share one underlying MODEL object: their steps run the same
    modules over the same weights on the same card, so overlapping
    them buys nothing but contention for the interpreter and the
    card's one default stream. Replicas built over distinct model
    instances get distinct locks and tick freely (each engine's CUDA
    graph capture holds the engine module's process-wide capture
    lock, so one replica's capture never overlaps another's).

    The thread makes the engine's card its current CUDA device before
    its first tick: the current device is per thread, and a worker on
    a second card must not launch onto the first."""

    def __init__(self, gw: "Gateway", replica: EngineReplica,
                 sched: SLOScheduler, tick_lock: threading.Lock,
                 ring: Optional[RequestTraceRing] = None):
        super().__init__(daemon=True,
                         name=f"gateway-{gw.name}-{replica.name}")
        self.gw = gw
        self.replica = replica
        self.engine = replica.engine
        self.sched = sched
        self._tick_lock = tick_lock
        self._ops: deque = deque()
        self._wake = threading.Event()
        self._live: Dict[Any, ServeRequest] = {}
        self.draining = False
        # fleet fault tolerance: ``failed`` latches once the
        # failover hand-off ran (crash path on this thread, hang/drop
        # on the supervisor — the latch makes them exclusive);
        # ``abandoned`` tells a still-running (hung) thread a
        # replacement owns the engine now — it must exit without
        # touching shared state. ``t_busy`` is the watchdog's
        # dispatch-to-drain deadline anchor: set before the engine
        # step, cleared after the token dispatch. ``_chaos`` is the
        # chaos harness's one-shot replica-addressed fault.
        self.failed = False
        self.fail_reason: Optional[str] = None
        self.rebuild_failed = False
        self.rebuilding = False
        self.abandoned = False
        self.t_busy: Optional[float] = None
        # False until the first dispatch completes: a COLD engine's
        # first steps pay the kernel builds and the tick programs'
        # CUDA-graph captures, so the watchdog grants it a 10x grace
        # deadline instead of reading them as a hang. An engine that
        # has dispatched before (factory-warmed, or rebuilt in place
        # with its kernels built) starts warmed and serves under the
        # strict deadline from its first request.
        self.warmed = getattr(replica.engine, "dispatch_count", 0) > 0
        self._chaos: Optional[str] = None
        # orders token emission against the failover snapshot: the
        # tick thread holds it across _dispatch, the failover path
        # holds it while latching ``abandoned`` and snapshotting/
        # clearing ``_live`` — so a slow-but-alive step that outlives
        # the watchdog can never emit concurrently with (or after)
        # the failover's re-delivery of the same requests
        self._io_lock = threading.Lock()
        rl = dict(gw._labels, replica=replica.name)
        # request-trace ring: this replica's
        # per-request timelines; the engine reports its lifecycle
        # events through trace_sink (resolved via _live, which is
        # populated BEFORE submit so queue-time events land too).
        # A rebuilt replica inherits its predecessor's ring
        # so the failure's timelines survive the restart.
        self.ring = ring
        if gw._trace:
            if self.ring is None:
                self.ring = RequestTraceRing(
                    capacity=gw._trace_capacity,
                    slow_ttft_ms=gw._slow_ttft_ms, labels=rl)
            self.engine.trace_sink = self._engine_trace
        # autoscaler signals: free
        # capacity gauges an external controller can scrape, updated
        # from the tick loop — the same registry the scheduler's
        # gateway_queue_depth already lives in
        reg = obs.registry()
        self._g_free_slots = reg.gauge("engine_free_slots", **rl)
        self._g_block_free = reg.gauge("block_pool_free_frac", **rl)

    def _engine_trace(self, request_id, kind, **fields):
        """PagedEngine.trace_sink target: resolve the engine's typed
        event onto the live request's trace (tick thread only)."""
        req = self._live.get(request_id)
        if req is not None and req.trace is not None:
            req.trace.ev(kind, **fields)

    def _trace_finish(self, req: ServeRequest, outcome: str,
                      tpot_ms: Optional[float] = None):
        if self.ring is not None and req.trace is not None:
            self.ring.finish(req.trace, outcome, tokens=req.n_out,
                             tpot_ms=tpot_ms)

    def _set_capacity_gauges(self):
        """Autoscaler signals: free
        slots + allocatable-block fraction, scrapeable from the same
        registry the scheduler's gateway_queue_depth lives in. O(1)
        host reads, refreshed around every tick."""
        eng = self.engine
        self._g_free_slots.set(sum(s is None for s in eng.slots))
        self._g_block_free.set(
            (len(eng.free_blocks) + len(eng.cached_free))
            / max(eng.P - 1, 1))

    # ------------------------------------------------------- cross-thread
    def post(self, fn):
        """Run ``fn`` on the tick thread before the next step."""
        self._ops.append(fn)
        self._wake.set()

    def wake(self):
        self._wake.set()

    def inject_fault(self, kind: str):
        """Chaos-harness hook (``tools/serve_loadgen.py --chaos``):
        arm a one-shot replica fault handled at the top of the next
        tick — the same code paths the seeded ``tick_crash`` /
        ``dispatch_hang`` / ``replica_drop`` fault sites take, but
        addressed to THIS replica deterministically."""
        if kind not in ("crash", "hang", "drop"):
            raise ValueError(f"unknown chaos kind {kind!r}")
        self._chaos = kind
        self._wake.set()

    def cancel_request(self, request_id, req: ServeRequest = None):
        """Client gone: drop it from wherever it currently lives —
        scheduler queue (never reached the engine) or the engine
        itself (slot + blocks free immediately). The engine-side
        record dicts are consumed here too (runs on the tick thread):
        nobody will ever read this request's result, and `_dispatch`
        only reaps rids still in `_live`, so leaving them would leak
        one entry per disconnect in a long-running gateway. ``req``
        lets the caller hand over a still-queued request (not yet in
        ``_live``) so its trace still closes."""
        req = self._live.get(request_id, req)
        if not self.sched.cancel(request_id):
            self.engine.cancel(request_id)
            self.engine.cancelled.pop(request_id, None)
            self.engine.results.pop(request_id, None)
            self.engine.logprobs.pop(request_id, None)
        self._live.pop(request_id, None)
        if req is not None:
            # a disconnected probe proves nothing: slot released only
            _release_probe(req, self.replica)
            self._trace_finish(req, "disconnect")

    def _emit(self, req: ServeRequest, ev):
        if req.sink is None:
            return
        try:
            self.gw._loop.call_soon_threadsafe(req.sink.put_nowait, ev)
        except RuntimeError:   # loop already closed (teardown)
            pass

    # ------------------------------------------------------------ tick loop
    def run(self):
        eng = self.engine
        rname = self.replica.name
        dev = getattr(eng, "device", None)
        if getattr(dev, "type", None) == "cuda":
            import torch
            torch.cuda.set_device(dev)
        while True:
            if self.abandoned:
                return        # a replacement worker owns the engine now
            # chaos entry points: the seeded fault sites +
            # the loadgen's replica-addressed one-shots share one code
            # path, so the chaos harness exercises exactly what real
            # failures would hit. crash/hang stay ARMED until the
            # worker is actually busy (an idle-tick kill that fizzles
            # would understate the harness's injected-kill count).
            if self._chaos == "drop" or faults.inject("replica_drop",
                                                      replica=rname):
                return        # hard exit, NO cleanup: the supervisor
                              # finds the corpse and fails over
            while self._ops:
                op = self._ops.popleft()
                try:
                    op()
                except Exception as e:   # a bad op must not kill serving
                    obs.record_event("gateway_op_error",
                                     gateway=self.gw.name, err=repr(e))
            now = time.monotonic()
            for req in self.sched.reap(now):
                # expired in QUEUE — cancelled before it
                # ever took a slot; the scheduler already counted it
                _release_probe(req, self.replica)
                self._emit(req, ("done", {"tokens": [],
                                          "finish_reason": "timeout"}))
                self._trace_finish(req, "expired")
            while (req := self._pop_admissible()) is not None:
                self._admit(req, time.monotonic())
            self._set_capacity_gauges()
            if eng.queue or any(s is not None for s in eng.slots):
                chaos, self._chaos = self._chaos, None
                try:
                    if chaos == "crash" or faults.inject("tick_crash",
                                                         replica=rname):
                        raise RuntimeError("injected tick_crash")
                    if chaos == "hang" or faults.inject("dispatch_hang",
                                                        replica=rname):
                        # the injected hang IS dispatch latency: open
                        # the watchdog window before sleeping
                        self.t_busy = time.monotonic()
                        time.sleep(faults.dispatch_hang_seconds())
                    if faults.inject("slow_replica", replica=rname):
                        time.sleep(faults.slow_replica_seconds())
                    if self.abandoned:
                        # the watchdog fired while we slept: requests
                        # failed over, the engine was rebuilt for a
                        # replacement worker — touch NOTHING
                        return
                    with self._tick_lock:
                        # the dispatch-to-drain watchdog window opens
                        # INSIDE the lock: waiting for a shared-model
                        # sibling's tick is not THIS replica's hang,
                        # and must not cascade watchdog fires onto
                        # healthy siblings (a real in-step hang that
                        # never releases the shared lock leaves its
                        # siblings blocked-but-undetected — run
                        # distinct model instances for isolation,
                        # as the chaos loadgen does)
                        self.t_busy = time.monotonic()
                        eng.step()
                except Exception as e:
                    self._fail_all(e)
                    return
                with self._io_lock:
                    if self.abandoned:
                        # a slow-but-not-hung step outlived the
                        # watchdog: the failover path owns every live
                        # request now — emit nothing, touch nothing
                        return
                    self._dispatch()
                self.t_busy = None
                # first full dispatch done: the cold start is paid,
                # so the watchdog's grace multiplier drops and
                # the strict deadline applies from here on
                self.warmed = True
                # post-tick refresh: a scrape between ticks sees the
                # capacity the step just freed, not last tick's view
                self._set_capacity_gauges()
            else:
                if self.draining and self.sched.depth() == 0 \
                        and not self._live:
                    return
                self._wake.wait(0.005)
                self._wake.clear()

    def _pop_admissible(self) -> Optional[ServeRequest]:
        """Hand the engine up to FREE-SLOT-many requests per tick (its
        own step() admits every queued request that fits, so a burst
        fills the batch in ONE tick instead of one-per-forward), but
        never build a deeper engine backlog than that: requests beyond
        the free slots stay in the scheduler, where policy can still
        reorder, promote, or expire them."""
        eng = self.engine
        free = sum(s is None for s in eng.slots)
        if len(eng.queue) >= free:
            return None
        return self.sched.pop()

    def _admit(self, req: ServeRequest, now: float):
        ids = req.input_ids
        if req.resume is None:
            kw = dict(req.gen)
        else:
            # failover resume: re-prefill prompt+committed
            # on THIS replica and continue from where the dead one
            # stopped — the engine's preemption fold, across replicas.
            # A seeded sampled request re-derives a per-attempt key
            # (distribution-preserving, not bitwise; an unseeded one
            # just gets this engine's fresh counter stream).
            d = req.resume
            ids = d["prompt"]
            kw = dict(max_new_tokens=max(int(d["remaining"]), 1),
                      temperature=d["temperature"], top_k=d["top_k"],
                      top_p=d["top_p"], repetition_penalty=d["rep"],
                      resume_tokens=d["committed"],
                      resume_lps=d["committed_lps"])
            if d["eos"] is not None:
                kw["eos_token_id"] = d["eos"]
            if d["stop"]:
                kw["stop_sequences"] = d["stop"]
            seed = req.gen.get("seed")
            if seed is not None:
                kw["seed"] = int(seed) + 0x9E3779B1 * req.failovers
        if req.deadline is not None:
            # thread the REMAINING deadline budget into the engine so
            # in-slot expiry uses its own timeout machinery
            kw["timeout_s"] = max(req.deadline - now, 1e-3)
        # register BEFORE submit: the engine's trace_sink resolves
        # request ids through _live, and submit itself emits the
        # engine_queue event
        self._live[req.request_id] = req
        try:
            self.engine.submit(req.request_id,
                               np.asarray([ids], np.int32),
                               **kw)
        except BackpressureError as e:
            # transient overload (an engine also taking out-of-band
            # submit() traffic filled its queue since the free-slot
            # check) — shed, don't tell the client its request was bad
            self._live.pop(req.request_id, None)
            _release_probe(req, self.replica)
            self._emit(req, ("error", 429, str(e)))
            self._trace_finish(req, "shed")
            return
        except Exception as e:
            self._live.pop(req.request_id, None)
            _release_probe(req, self.replica)
            self._emit(req, ("error", 400, str(e)))
            self._trace_finish(req, "error")
            return
        req.t_admit = now

    def _fail_all(self, err: Exception):
        """Tick-thread failure exit:
        live requests now route through the FAILOVER path — each is
        resubmitted to a surviving replica as prompt + committed
        tokens; the bare error is only the no-survivor fallback inside
        ``Gateway._failover_worker``. The supervisor then rebuilds
        this replica's engine and rejoins it through the breaker."""
        obs.record_event("gateway_replica_error", gateway=self.gw.name,
                         replica=self.replica.name, err=repr(err))
        self.gw._failover_worker(self, reason="crash", err=err)

    def flush_queue(self, status: int, msg: str):
        """Error out every request still waiting in the scheduler —
        the dead/exiting-worker path: a queued client must get an
        answer, never a hang. Safe off the tick thread once the
        thread is gone (the scheduler locks internally)."""
        for req in self.sched.reap():
            _release_probe(req, self.replica)
            self._emit(req, ("done", {"tokens": [],
                                      "finish_reason": "timeout"}))
            self._trace_finish(req, "expired")
        while (req := self.sched.pop()) is not None:
            _release_probe(req, self.replica)
            self._emit(req, ("error", status, msg))
            self._trace_finish(req, "error")

    # ------------------------------------------------------------ dispatch
    def _token_out(self, req: ServeRequest, tok: int, now: float,
                   lp: Optional[float] = None):
        if req.t_first is None:
            req.t_first = now
            self.gw._h_ttft.observe((now - req.t_enqueue) * 1e3,
                                    exemplar=req.request_id)
            if req.trace is not None:
                req.trace.ev("first_token",
                             ttft_ms=round(
                                 (now - req.t_enqueue) * 1e3, 3))
        req.t_last = now
        req.n_out += 1
        self.gw._c_tokens.inc()
        # the event carries the token's logprob too: a fleet
        # frontend proxying this stream needs (token, lp) pairs to
        # resubmit prompt+committed WITH logprobs on a surviving peer,
        # so a failed-over stream's final logprob list stays bitwise
        # the uninterrupted run's. NaN (an lp-less resume prefix) maps
        # to null — json.dumps would otherwise emit invalid JSON.
        if lp is not None and lp != lp:
            lp = None
        self._emit(req, ("token", int(tok),
                         float(lp) if lp is not None else None))

    def _finish(self, req: ServeRequest, payload: Dict[str, Any],
                now: float):
        tpot_ms = None
        if req.t_first is not None and req.n_out >= 2:
            tpot_ms = ((req.t_last - req.t_first)
                       / (req.n_out - 1) * 1e3)
            self.gw._h_tpot.observe(tpot_ms, exemplar=req.request_id)
        self.gw._c_completed.inc()
        self.sched.note_service(now - req.t_enqueue)
        self._emit(req, ("done", payload))
        reason = payload.get("finish_reason", "stop")
        outcome = {"stop": "stop", "timeout": "timeout",
                   "cancelled": "cancelled"}.get(reason, "error")
        if req.probe:
            # circuit-breaker probation: a clean finish
            # counts toward closing; an engine timeout/cancel proves
            # nothing and just releases the probe slot
            b = getattr(self.replica, "breaker", None)
            if b is not None:
                b.probe_done(True if reason == "stop" else None)
                if b.state == BREAKER_CLOSED and req.trace is not None:
                    req.trace.ev("breaker_close",
                                 replica=self.replica.name)
            req.probe = False
        elif reason == "stop":
            # ordinary successes clear the consecutive-failure count —
            # what makes failure_threshold > 1 mean CONSECUTIVE, not
            # "N failures over the replica's lifetime"
            b = getattr(self.replica, "breaker", None)
            if b is not None:
                b.record_success()
        if req.trace is not None:
            req.trace.ev("finish", reason=reason, tokens=req.n_out)
        self._trace_finish(req, outcome, tpot_ms=tpot_ms)
        # goodput: tokens from requests that met
        # their TTFT SLO (batch traffic has none — completing counts)
        if reason == "stop" and req.n_out:
            ttft_ms = ((req.t_first - req.t_enqueue) * 1e3
                       if req.t_first is not None else None)
            if req.slo != SLO_INTERACTIVE or (
                    ttft_ms is not None
                    and ttft_ms <= self.gw._slow_ttft_ms):
                self.gw._c_good_tokens.inc(req.n_out)
            self.gw._g_goodput.set(
                self.gw._c_good_tokens.value
                / max(self.gw._c_tokens.value, 1.0))

    def _dispatch(self):
        """Push this tick's newly emitted tokens (stream()'s hold-back
        rule, verbatim) and resolve finished / aborted requests."""
        eng = self.engine
        now = time.monotonic()
        for s in eng.slots:
            if s is None:
                continue
            req = self._live.get(s.request_id)
            if req is None:
                continue
            hold = max((len(x) for x in s.stop), default=0)
            n_pre = len(s.prefix)
            start = req.emitted
            upto = max(n_pre + len(s.tokens) - hold, start)
            for i in range(start, upto):
                if i < n_pre:
                    tok = s.prefix[i]
                    lp = (s.prefix_lps[i]
                          if i < len(s.prefix_lps) else None)
                else:
                    tok = s.tokens[i - n_pre]
                    lp = (s.lps[i - n_pre]
                          if i - n_pre < len(s.lps) else None)
                self._token_out(req, tok, now, lp=lp)
            req.emitted = upto
            if upto > start and req.trace is not None:
                req.trace.ev("stream_write", n=upto - start)
        for rid in [r for r in self._live if r in eng.results]:
            req = self._live.pop(rid)
            toks = eng.results.pop(rid)
            lps = eng.logprobs.pop(rid, [])
            n_tail = len(toks) - req.emitted
            for i in range(req.emitted, len(toks)):
                self._token_out(req, toks[i], now,
                                lp=lps[i] if i < len(lps) else None)
            req.emitted = len(toks)
            if n_tail > 0 and req.trace is not None:
                req.trace.ev("stream_write", n=n_tail)
            self._finish(req, {"tokens": [int(t) for t in toks],
                               "logprobs": [float(v) for v in lps],
                               "finish_reason": "stop"}, now)
        for rid in [r for r in self._live if r in eng.cancelled]:
            req = self._live.pop(rid)
            reason = eng.cancelled.pop(rid)
            self._finish(req, {"tokens": [],
                               "finish_reason": reason}, now)


def check_single_rank(engine, where: str) -> None:
    """``NotImplementedError`` for an engine whose model is sharded at
    tp > 1 with no sequencer in front of it: its ranks must all see every
    call, in one order (wrap each rank's engine in
    :class:`~.tp_replica.SequencedEngine` and serve rank 0's);
    ``ValueError`` for a follower rank's sequenced engine."""
    if getattr(engine, "sequenced", False):
        if not engine.leader:
            raise ValueError(
                f"{where} on a tp follower rank's engine: rank 0 serves "
                f"the replica, the other ranks call follow()")
        return
    if getattr(engine, "_tp", 1) > 1:
        raise NotImplementedError(
            f"{where} on a PagedEngine sharded at tp {engine._tp} with no "
            f"sequencer: wrap every rank's engine in "
            f"serving.tp_replica.SequencedEngine and serve rank 0's")


class Gateway:
    """Serve one or more PagedEngine replicas over HTTP/SSE.

    ``engines``: a single engine or a list (each becomes a replica with
    its own tick thread + SLO scheduler). ``port=0`` binds an ephemeral
    port (``self.port`` after ``start()``).
    """

    def __init__(self, engines, host: str = "127.0.0.1", port: int = 0,
                 *, max_queue: int = 256,
                 interactive_ttft_ms: float = 500.0,
                 promote_after_ms: float = 2000.0,
                 routing: str = "prefix", spill_margin: float = 8.0,
                 shutdown: Optional[GracefulShutdown] = None,
                 name: Optional[str] = None,
                 trace: bool = True, trace_capacity: int = 512,
                 slow_ttft_ms: Optional[float] = None,
                 supervise: bool = True,
                 engine_factory=None,
                 spill_arena=None,
                 migrate_on_drain: bool = False,
                 xfer_grace_s: float = 0.5,
                 failover_budget: int = 2,
                 watchdog_timeout_s: float = 30.0,
                 watchdog_interval_s: float = 0.05,
                 breaker_backoff_s: float = 1.0,
                 breaker_backoff_max_s: float = 30.0,
                 breaker_probes: int = 1,
                 sample_interval_s: Optional[float] = 0.25,
                 sample_capacity: int = 512,
                 slo_alerting: bool = True,
                 slo_targets: Optional[Dict[str, float]] = None,
                 slo_rules=None,
                 slo_window_scale: float = 1.0):
        """Fleet fault tolerance: ``supervise`` (default on)
        runs the :class:`~.supervisor.ReplicaSupervisor` — tick-thread
        crash/hang detection (``watchdog_timeout_s`` is the
        dispatch-to-drain deadline), engine rebuild
        (``engine_factory()`` when given, ``PagedEngine.hard_reset()``
        in place otherwise) and circuit-breaker rejoin
        (``breaker_backoff_s`` exponential backoff before the first
        probation probe, ``breaker_probes`` successes to close).
        ``failover_budget`` caps how many replica failures one request
        may ride through before it errors out — the amplification
        bound under cascading failures.

        Telemetry plane: ``sample_interval_s`` runs a
        :class:`~paddle_tpu_torch.utils.observability.MetricsTimeSeries`
        sampler (None/0 disables — today's snapshot-only behavior)
        that backs ``GET /metricsz?window_s=N`` and the
        ``series_<gateway>.json`` drain artifact; ``slo_alerting``
        runs a :class:`~.slo.BurnRateEngine` over the reqtrace
        outcome stream (requires ``trace=True`` — the ring's
        idempotent finish is the dedupe point), with
        ``slo_window_scale`` shrinking the burn windows for
        CI-speed runs. Both are host-side and pull-only: streams and
        the steady-tick dispatch/upload pins are unchanged with the
        plane on (pinned by ``tests/test_telemetry.py``)."""
        if not isinstance(engines, (list, tuple)):
            engines = [engines]
        for eng in engines:
            check_single_rank(eng, "Gateway")
        self.name = name or f"gw{next(_gateway_ids)}"
        self.host, self.port = host, port
        self._labels = {"gateway": self.name}
        self._shutdown = shutdown
        self._draining = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # one /profilez capture at a time: concurrent
        # captures would fight over utils.profiler's single-trace
        # ownership — the second caller gets 409, not a corrupt trace
        self._profilez_busy = False
        # request-scoped tracing: default ON — the whole
        # path is host-side bookkeeping, pinned to change nothing
        # (bit-identical streams, same dispatch/upload counters).
        # ``slow_ttft_ms`` is the DETERMINISTIC tail-retention
        # threshold (default: the interactive TTFT SLO — "slow" means
        # "missed its SLO"), shared with the goodput gauge.
        self._trace = bool(trace)
        self._trace_capacity = int(trace_capacity)
        self._slow_ttft_ms = float(
            interactive_ttft_ms if slow_ttft_ms is None
            else slow_ttft_ms)
        reg = obs.registry()
        self._c_requests = {
            slo: reg.counter("gateway_requests_total", slo=slo,
                             **self._labels)
            for slo in (SLO_INTERACTIVE, SLO_BATCH)}
        self._c_shed = reg.counter("gateway_shed_total", **self._labels)
        self._c_completed = reg.counter("gateway_completed_total",
                                        **self._labels)
        self._c_tokens = reg.counter("gateway_tokens_total",
                                     **self._labels)
        self._c_disconnects = reg.counter("gateway_disconnects_total",
                                          **self._labels)
        self._h_ttft = reg.histogram("gateway_ttft_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **self._labels)
        self._h_tpot = reg.histogram("gateway_tpot_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **self._labels)
        # goodput: tokens from
        # requests that met their TTFT SLO, plus the running fraction —
        # the autoscaler's quality-of-service signal
        self._c_good_tokens = reg.counter("gateway_good_tokens_total",
                                          **self._labels)
        self._g_goodput = reg.gauge("gateway_goodput_frac",
                                    **self._labels)
        # fleet fault tolerance: the failover accounting
        # the supervisor/crash paths share. _fo_lock serializes the
        # per-worker failure latch and the worker-list swap.
        self._engine_factory = engine_factory
        # host-RAM KV spill tier: the gateway OWNS the arena
        # precisely because engines don't survive supervisor rebuilds —
        # _make_worker re-attaches it to whatever engine a replica
        # currently runs, so a crashed replica comes back warm. One
        # shared arena per gateway: digests are content-addressed over
        # the token chain, so a span spilled by one replica restores
        # bit-exactly into any sibling with the same geometry.
        self._spill_arena = spill_arena
        # cross-replica KV transfer: with migration on, a
        # drain cuts live requests over to a survivor as terminal
        # "migrated" SSE events carrying the committed stream + a
        # resume_kv digest the fleet frontend resolves against /kvz —
        # the resubmit restores the span instead of re-prefilling.
        # _xfer_fetch is the fleet-tier hook _resubmit consults on a
        # local arena miss (settable by an embedding frontend/test):
        # digest hex -> wire blob bytes or None.
        self._migrate_on_drain = bool(migrate_on_drain)
        self._xfer_grace_s = float(xfer_grace_s)
        self._xfer_fetch = None
        self._failover_budget = int(failover_budget)
        self._fo_lock = threading.Lock()
        self._c_failovers = reg.counter("gateway_failovers_total",
                                        **self._labels)
        self._c_fo_exhausted = reg.counter(
            "gateway_retry_budget_exhausted_total", **self._labels)
        self._c_migrated = reg.counter(
            "gateway_migrated_requests_total", **self._labels)
        # telemetry plane: the windowed time-series sampler
        # behind /metricsz + the SLO burn-rate engine over the trace
        # rings' outcome stream. Built BEFORE the workers so
        # _make_worker can attach the engine to each ring it creates.
        self.sampler = None
        if sample_interval_s:
            self.sampler = obs.MetricsTimeSeries(
                name=self.name, interval_s=float(sample_interval_s),
                capacity=sample_capacity)
        self._slo: Optional[BurnRateEngine] = None
        if slo_alerting and self._trace:
            self._slo = BurnRateEngine(
                targets=slo_targets, rules=slo_rules,
                window_scale=slo_window_scale, labels=self._labels)
        self._workers: List[_ReplicaWorker] = []
        # prefix-gossip generation ratchet: keeps the
        # exported generation monotonic across engine_factory rebuilds
        # (see prefix_digest_summary)
        self._prefix_gen_base = 0
        self._prefix_gen_last = 0
        replicas = []
        # replicas sharing one MODEL object tick one at a time (see
        # _ReplicaWorker); one lock per distinct model serializes
        # exactly those
        self._model_locks: Dict[int, threading.Lock] = {}
        for i, eng in enumerate(engines):
            rep = EngineReplica(f"r{i}", eng)
            sched = SLOScheduler(
                max_queue=max_queue,
                interactive_ttft_ms=interactive_ttft_ms,
                promote_after_ms=promote_after_ms,
                labels=dict(self._labels, replica=rep.name))
            self._workers.append(self._make_worker(rep, sched))
            replicas.append(rep)
        self._router = PrefixAffinityRouter(
            replicas, policy=routing, spill_margin=spill_margin,
            labels=self._labels)
        self._by_replica = {w.replica: w for w in self._workers}
        # the reference engine defines prompt limits + the digest grid
        self._ref = engines[0]
        # a span in the arena holds rank 0's heads alone at tp > 1: no
        # peer imports it and none is imported (such resumes re-prefill)
        self._xfer_ok = getattr(self._ref, "_tp", 1) == 1
        self._supervisor: Optional[ReplicaSupervisor] = None
        if supervise:
            for rep in replicas:
                rep.breaker = CircuitBreaker(
                    probes_to_close=breaker_probes,
                    backoff_s=breaker_backoff_s,
                    backoff_max_s=breaker_backoff_max_s,
                    on_state=self._breaker_state_cb(rep))
            self._supervisor = ReplicaSupervisor(
                self, check_interval_s=watchdog_interval_s,
                dispatch_timeout_s=watchdog_timeout_s)

    def _make_worker(self, replica: EngineReplica, sched: SLOScheduler,
                     ring: Optional[RequestTraceRing] = None
                     ) -> _ReplicaWorker:
        """Build a tick-thread worker for ``replica``'s CURRENT engine
        (also the supervisor's rebuild hook — a fresh engine reuses
        the replica name, scheduler, trace ring and metric labels)."""
        key = id(getattr(replica.engine, "model", replica.engine))
        lock = self._model_locks.setdefault(key, threading.Lock())
        if len(self._model_locks) > 256:
            # supervisor rebuilds with a fresh-model factory add one
            # entry per restart; prune entries no current worker uses
            # (kept small enough that a hung thread's still-referenced
            # model — whose id therefore can't be recycled — is never
            # re-keyed onto a fresh lock in practice)
            live = {key} | {
                id(getattr(w.engine, "model", w.engine))
                for w in self._workers}
            self._model_locks = {k: v for k, v in
                                 self._model_locks.items()
                                 if k in live}
        if self._spill_arena is not None \
                and hasattr(replica.engine, "attach_spill"):
            # covers initial build AND supervisor rebuilds: the arena
            # outlives the engine, which is what makes restarts warm
            replica.engine.attach_spill(self._spill_arena)
        w = _ReplicaWorker(self, replica, sched, lock, ring=ring)
        if self._slo is not None and w.ring is not None \
                and self._slo_observe not in w.ring.observers:
            # the burn engine rides the ring's idempotent finish — a
            # rebuilt worker inherits its predecessor's ring, so the
            # observer survives supervisor restarts too
            w.ring.observers.append(self._slo_observe)
        return w

    def _slo_observe(self, entry: Dict[str, Any]):
        """Ring-finish observer: fold one terminal outcome
        into the burn-rate engine. 'Bad' = the request broke its
        class's promise — any non-stop outcome, plus (interactive
        only) a TTFT over the SLO threshold, the same rule the
        goodput gauge applies. A zero-token clean finish has no TTFT
        and counts good."""
        eng = self._slo
        if eng is None:
            return
        ttft = entry.get("ttft_ms")
        ok = entry["outcome"] == "stop" and (
            entry["slo"] != SLO_INTERACTIVE
            or ttft is None or ttft <= self._slow_ttft_ms)
        eng.observe(entry["slo"], ok)

    def _breaker_state_cb(self, replica: EngineReplica):
        def cb(state: str):
            if state == BREAKER_CLOSED:
                # breaker closed = probation passed: back in rotation
                replica.mark(True)
            obs.record_event("gateway_breaker", gateway=self.name,
                             replica=replica.name, state=state)
        return cb

    # ------------------------------------------------------------ failover
    def _failover_worker(self, worker: _ReplicaWorker, reason: str,
                         err: Optional[Exception] = None,
                         stuck_ms: Optional[float] = None):
        """Fail ONE replica: latch it out of
        rotation, open its breaker, and move every live/queued request
        to a surviving replica — resubmitted as ``prompt + committed
        tokens`` with the stream-resume offset, so the client sees no
        duplicate and no gap. Requests that FINISHED on the dead
        replica but were never delivered are completed from its result
        mirrors. Runs on the dying tick thread (crash) or the
        supervisor (hang/drop); the ``failed`` latch makes the two
        callers mutually exclusive."""
        with self._fo_lock:
            if worker.failed:
                return
            worker.failed = True
            worker.fail_reason = reason
        # _io_lock orders this snapshot against the old thread's
        # _dispatch: either its in-flight emission completes first and
        # we snapshot the post-dispatch state, or we latch abandoned
        # first and it emits nothing ever again. (The crash path runs
        # ON the tick thread, which never holds the lock here.) The
        # acquire is BOUNDED: a thread wedged INSIDE _dispatch would
        # otherwise pin the fleet's one supervisor forever — on
        # timeout we proceed unordered (abandoned is latched first,
        # so the wedged dispatch can at worst duplicate-emit into
        # sinks whose requests have already moved on).
        worker.abandoned = True
        locked = worker._io_lock.acquire(timeout=1.0)
        try:
            worker.replica.mark(False)
            # host-mirror snapshot of the dead engine —
            # export_resumable and the result dicts are plain host
            # bookkeeping, safe to read whatever state the
            # device/tick thread is stuck in
            try:
                desc = worker.engine.export_resumable()
            except Exception:
                desc = {}
            try:
                results = dict(worker.engine.results)
                res_lps = dict(worker.engine.logprobs)
            except Exception:
                results, res_lps = {}, {}
            live = list(worker._live.values())
            worker._live.clear()
        finally:
            if locked:
                worker._io_lock.release()
        # crash fast-path: the tick thread died but the
        # process — and the device pools — did not. Bank every live
        # request's computed span into the shared arena BEFORE the
        # resubmits below, so the survivor's admission restores them
        # through one H2D scatter instead of re-prefilling
        # prompt+committed. A wedged thread ("hang") may still be
        # inside a dispatch touching the pools, so only provably idle
        # engines are salvaged; any failure here costs exactly one
        # re-prefill, never a token.
        if self._spill_arena is not None and reason != "hang" \
                and hasattr(worker.engine, "spill_live"):
            try:
                worker.engine.spill_live()
            except Exception:
                pass
        breaker = getattr(worker.replica, "breaker", None)
        if breaker is not None:
            breaker.record_failure()
        self._router.evict_unhealthy()
        for r in worker.sched.reap():
            _release_probe(r, worker.replica)
            worker._emit(r, ("done", {"tokens": [],
                                      "finish_reason": "timeout"}))
            worker._trace_finish(r, "expired")
        queued = []
        while (r := worker.sched.pop()) is not None:
            queued.append(r)
        now = time.monotonic()
        for req in live + queued:
            if req.trace is not None:
                if stuck_ms is not None:
                    req.trace.ev("watchdog_fire", stuck_ms=stuck_ms)
                req.trace.ev("replica_fail",
                             replica=worker.replica.name, reason=reason)
                if breaker is not None:
                    req.trace.ev("breaker_open",
                                 replica=worker.replica.name)
            # a probe caught in its target's failure IS the probe's
            # answer: re-open with a longer backoff
            _release_probe(req, worker.replica, False)
            toks = results.get(req.request_id)
            if toks is not None:
                # finished on the dead replica, undelivered: deliver
                # from the result mirrors instead of re-running it
                rl = res_lps.get(req.request_id, [])
                for i in range(req.emitted, len(toks)):
                    worker._token_out(req, toks[i], now,
                                      lp=rl[i] if i < len(rl) else None)
                req.emitted = len(toks)
                worker._finish(
                    req, {"tokens": [int(t) for t in toks],
                          "logprobs": [float(v) for v in
                                       res_lps.get(req.request_id, [])],
                          "finish_reason": "stop"}, now)
                continue
            self._resubmit(req, desc.get(req.request_id), worker)
        obs.record_event("gateway_replica_fail", gateway=self.name,
                         replica=worker.replica.name, reason=reason,
                         moved=len(live) + len(queued),
                         err=repr(err) if err is not None else "")

    def _resubmit(self, req: ServeRequest, desc: Optional[Dict],
                  from_worker: _ReplicaWorker):
        """One request's failover hop: charge the retry budget, pick a
        surviving replica (healthy, alive, and NOT draining — a
        draining replica never accepts failover traffic), attach the
        resume descriptor and re-enqueue through that replica's
        scheduler (failover traffic is still subject to shedding:
        bounded budget + shedding is what keeps a replica failure from
        amplifying into a retry storm under overload)."""
        if desc is not None and int(desc["remaining"]) <= 0:
            # budget fully committed at the kill boundary: deliver the
            # committed stream instead of re-running anything (checked
            # BEFORE the retry budget — a complete result in hand must
            # never be 503'd)
            now = time.monotonic()
            toks = [int(t) for t in desc["committed"]]
            clps = desc["committed_lps"]
            for i in range(req.emitted, len(toks)):
                from_worker._token_out(req, toks[i], now,
                                       lp=clps[i] if i < len(clps)
                                       else None)
            req.emitted = len(toks)
            from_worker._finish(
                req, {"tokens": toks,
                      "logprobs": [float(v)
                                   for v in desc["committed_lps"]],
                      "finish_reason": "stop"}, now)
            return
        req.failovers += 1
        if req.failovers > self._failover_budget:
            self._c_fo_exhausted.inc()
            self._fail_request(
                req, from_worker, 503,
                f"failover budget exhausted after "
                f"{self._failover_budget} replica failures")
            return
        if desc is not None:
            # attach BEFORE any enqueue: the target's tick thread may
            # pop the request the moment it lands
            req.resume = desc
            # fleet spill-tier fast-path: make the stream's
            # longest span arena-resident (peer /kvz fetch if needed)
            # before the survivor admits it — the resume then restores
            # instead of re-prefilling
            if self._spill_arena is not None:
                self._xfer_restore(req, desc)
        cands = sorted(
            (w for w in self._workers
             if w is not from_worker and not w.failed
             and not w.abandoned and not w.draining
             and w.is_alive() and w.replica.healthy()),
            key=lambda w: w.replica.load() + w.sched.depth())
        for target in cands:
            req.owner = target
            try:
                eng = target.engine
                target.sched.enqueue(
                    req, engine_health={"queued": len(eng.queue),
                                        "queue_capacity": eng.max_queue})
            except ShedError as e:
                self._c_shed.inc()
                self._fail_request(req, from_worker, 503,
                                   f"failover shed: {e}")
                return
            if target.failed or not target.is_alive():
                # the target failed CONCURRENTLY, after its own queue
                # flush — take the request back and try the next
                # survivor (left queued it would hang forever)
                if target.sched.cancel(req.request_id):
                    continue
                # its failover path already claimed the request
                return
            if req.trace is not None:
                req.trace.ev("resubmit",
                             to_replica=target.replica.name,
                             attempt=req.failovers)
                req.trace.ev("resume_offset", offset=req.emitted,
                             committed=len(desc["committed"])
                             if desc else 0)
            self._c_failovers.inc()
            target.wake()
            return
        self._fail_request(req, from_worker, 503,
                           "replica failed; no surviving replica")

    def _xfer_restore(self, req: ServeRequest, desc: Dict):
        """Fleet-tier consult before a failover hop re-prefills
: walk the resumed stream's digest chain
        longest-first; a span already arena-resident means the
        survivor's admission will restore it — done. Otherwise ask the
        fleet through the ``_xfer_fetch`` hook (peer ``GET /kvz``) and
        inject the wire blob. Every failure — no hook, no peer, any
        decode-ladder rung, over-capacity refusal — leaves the normal
        re-prefill path untouched."""
        eng = self._ref
        if not getattr(eng, "prefix_caching", False) or not self._xfer_ok:
            return
        try:
            ids = [int(t) for t in desc["prompt"]]
            geo = eng._spill_geometry()
            chain = eng._chunk_digests(ids, len(ids) - 1)
        except Exception:
            return
        for i in range(len(chain) - 1, -1, -1):
            raw = chain[i]
            if self._spill_arena.probe(raw) is not None:
                return                       # already fleet/local warm
            if self._xfer_fetch is None:
                return
            try:
                blob = self._xfer_fetch(raw.hex())
            except Exception:
                blob = None
            if blob is None:
                continue                     # peer may hold a shorter span
            if kvxfer.inject_span(self._spill_arena, blob, geo,
                                  gateway=self.name) is not None:
                if req.trace is not None:
                    req.trace.ev("kv_xfer_restore",
                                 digest=raw.hex()[:12])
                return

    def _fail_request(self, req: ServeRequest,
                      worker: _ReplicaWorker, status: int, msg: str):
        """Terminal failover error: tell the client and close the
        trace on the failed replica's ring."""
        worker._emit(req, ("error", status, msg))
        if req.trace is not None:
            req.trace.ev("finish", reason="error")
        worker._trace_finish(req, "error")

    # -------------------------------------------------------------- digest
    def _affinity_digests(self, ids: List[int]) -> Optional[List[str]]:
        """The prompt's chunk-grid digest chain, LONGEST span first —
        the router probes each span so a unique tail crossing a chunk
        boundary still finds the replica warm on the shared spans."""
        eng = self._ref
        if not getattr(eng, "prefix_caching", False):
            return None
        try:
            chain = eng.prefix_digests(ids)
        except Exception:
            return None
        return chain[::-1] or None

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        self._loop = asyncio.get_running_loop()
        for w in self._workers:
            w.start()
        if self.sampler is not None:
            if self._slo is not None:
                # alerts must RESOLVE on wall time even when traffic
                # stops — the sampler tick is the evaluation heartbeat
                self.sampler.add_hook(self._slo.evaluate)
            self.sampler.start()
        if self._supervisor is not None \
                and not self._supervisor.is_alive():
            self._supervisor.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        obs.record_event("gateway_start", gateway=self.name,
                         port=self.port,
                         replicas=len(self._workers))
        return self

    async def drain(self, timeout: float = 30.0,
                    migrate: Optional[bool] = None):
        """Stop admitting, finish in-flight, flush metrics, close the
        listener (the SIGTERM rolling-restart path). With migration on
        (``migrate_on_drain`` or the override), live requests are CUT
        OVER instead of finished here: each stream ends with a
        terminal ``migrated`` event carrying the committed tokens and
        a ``resume_kv`` digest whose KV span was just banked in the
        arena — the fleet frontend resubmits to a survivor that
        restores the span instead of re-prefilling."""
        if self._draining and self._server is None:
            return
        self._draining = True
        # supervision stops FIRST: a worker exiting because it drained
        # must not be mistaken for a dropped replica and restarted,
        # and a draining fleet never rebuilds (SIGTERM composes with
        # an open breaker — the replica just stays down)
        if self._supervisor is not None:
            self._supervisor.stop()
        for w in self._workers:
            w.draining = True
            w.wake()
        if migrate is None:
            migrate = self._migrate_on_drain
        mig_before = int(self._c_migrated.value)
        if migrate and self._spill_arena is not None:
            # migrate-out runs ON each tick thread (posted op): the
            # D2H span export and the live-request cut must be ordered
            # against that thread's own dispatch
            flags = []
            for w in self._workers:
                if not w.is_alive():
                    continue
                ev = threading.Event()

                def _mig(w=w, ev=ev):
                    try:
                        self._migrate_out(w)
                    finally:
                        ev.set()

                w.post(_mig)
                flags.append(ev)
            mig_deadline = time.monotonic() + min(timeout, 10.0)
            for ev in flags:
                while not ev.is_set() \
                        and time.monotonic() < mig_deadline:
                    await asyncio.sleep(0.005)
        deadline = time.monotonic() + timeout
        for w in self._workers:
            # an abandoned (hung) worker never exits on its own; its
            # replacement — if any — is what _workers holds
            while w.is_alive() and not w.abandoned \
                    and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
        for w in self._workers:
            if not w.is_alive():
                # close the enqueue/exit race: a request that slipped
                # into the scheduler as its tick thread returned gets
                # a terminal answer here instead of a hung client
                w.flush_queue(503, "draining: not admitting new "
                                   "requests")
        if self._spill_arena is not None:
            # the device pools are about to die with the process; the
            # arena (host RAM, handed to the replacement gateway) is
            # what carries the warm spans across the restart
            for w in self._workers:
                try:
                    if hasattr(w.engine, "spill_parked"):
                        w.engine.spill_parked()
                    if hasattr(w.engine, "spill_live"):
                        # requests that outlived the drain deadline
                        # still bank their computed spans — a peer
                        # /kvz fetch can finish what this replica
                        # couldn't
                        w.engine.spill_live()
                except Exception:
                    pass        # a failed drain spill only costs warmth
        for w in self._workers:
            if getattr(w.engine, "sequenced", False):
                # a tp replica's other ranks leave their follow loops
                w.engine.stop()
        obs.record_event("gateway_drain", gateway=self.name)
        if self.sampler is not None:
            # stop the sampler thread and leave the trajectory on disk
            # (series_<gateway>.json, beside the reqtrace rings) so a
            # SIGTERM'd replica's windowed history survives it
            #
            self.sampler.stop()
            self.sampler.flush_series(
                alerts=self._slo.alerts if self._slo is not None
                else None)
        obs.flush()
        if obs.run_dir():
            # park the request-trace rings next to the other run
            # artifacts so trace_report finds them after a restart
            try:
                self.dump_traces(obs.run_dir())
            except Exception:
                pass
            # ... and the tick-phase rings beside them (a SIGTERM'd
            # replica leaves its phase trajectory too)
            try:
                self.dump_tick_profiles(obs.run_dir())
            except Exception:
                pass
        if int(self._c_migrated.value) > mig_before \
                and self._xfer_grace_s > 0:
            # hold the listener open past the cut-over so the fleet
            # frontend's /kvz fetch of the migrated spans lands —
            # closing immediately would race the survivor's restore
            # (it would still finish correctly via re-prefill, but
            # the whole point of migrating is skipping that)
            await asyncio.sleep(self._xfer_grace_s)
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None

    def _migrate_out(self, worker: _ReplicaWorker):
        """Cut one replica's live requests over to the fleet (drain
        migration; runs on the tick thread via ``post``).
        Banks each request's computed KV span into the shared arena
        (``spill_live``), then ends its stream with a terminal
        ``migrated`` event: the committed tokens/logprobs, the
        remaining budget, and the longest arena-resident span digest
        as ``resume_kv``. The resubmitted stream restores that span —
        greedy continuation is bitwise the uninterrupted stream; every
        failure here just means the resubmit re-prefills instead."""
        eng = worker.engine
        try:
            eng.spill_live()
        except Exception:
            pass            # a failed export only costs a re-prefill
        try:
            desc = eng.export_resumable()
        except Exception:
            desc = {}
        for rid, req in list(worker._live.items()):
            d = desc.get(rid)
            if d is None:
                continue
            digest = ""
            try:
                ids = [int(t) for t in d["prompt"]]
                chain = eng._chunk_digests(ids, len(ids) - 1) \
                    if self._xfer_ok else []
                for raw in reversed(chain):
                    if self._spill_arena.probe(raw) is not None:
                        digest = raw.hex()
                        break
            except Exception:
                digest = ""
            payload = {
                "tokens": [int(t) for t in d["committed"]],
                "logprobs": [float(v) for v in d["committed_lps"]],
                "finish_reason": "migrated",
                "resume_kv": digest,
                "remaining": int(d["remaining"]),
            }
            worker._emit(req, ("done", payload))
            if req.trace is not None:
                req.trace.ev("migrate_out", digest=digest[:12],
                             committed=len(payload["tokens"]),
                             remaining=payload["remaining"])
            worker._trace_finish(req, "migrated")
            try:
                eng.cancel(rid)
                eng.cancelled.pop(rid, None)
                eng.results.pop(rid, None)
                eng.logprobs.pop(rid, None)
            except Exception:
                pass
            worker._live.pop(rid, None)
            self._c_migrated.inc()
        obs.record_event("gateway_migrate_out", gateway=self.name,
                         replica=worker.replica.name,
                         moved=int(self._c_migrated.value))

    async def run_until_shutdown(self, poll_s: float = 0.05):
        """Serve until the GracefulShutdown latch fires (SIGTERM /
        SIGINT / programmatic ``request()``), then drain and return —
        the contract rolling restarts rely on."""
        if self._shutdown is None:
            self._shutdown = GracefulShutdown()
        self._shutdown.install()
        if self._server is None:
            await self.start()
        try:
            while not self._shutdown.requested():
                await asyncio.sleep(poll_s)
        finally:
            await self.drain()
            self._shutdown.uninstall()

    @property
    def draining(self) -> bool:
        if self._shutdown is not None and self._shutdown.requested():
            self._draining = True
            for w in self._workers:
                if not w.draining:
                    w.draining = True
                    w.wake()
        return self._draining

    # -------------------------------------------------------------- traces
    def dump_traces(self, directory: str) -> List[str]:
        """Write every replica's request-trace ring to
        ``reqtrace_<gateway>_<replica>.json`` under ``directory`` (the
        artifacts a trace report ingests). No-op when
        tracing is off."""
        os.makedirs(directory, exist_ok=True)
        out = []
        for w in self._workers:
            if w.ring is None:
                continue
            out.append(w.ring.dump(os.path.join(
                directory,
                f"reqtrace_{self.name}_{w.replica.name}.json")))
        return out

    def dump_tick_profiles(self, directory: str) -> List[str]:
        """Write every replica engine's tick-phase ring to
        ``tickphase_<gateway>_<replica>.json`` under ``directory``
        (the synchronized dump a ``/profilez`` capture and a
        drain leave beside the reqtrace rings). No-op for engines
        running with ``tick_profile`` off."""
        os.makedirs(directory, exist_ok=True)
        out = []
        for w in self._workers:
            dump = getattr(w.engine, "dump_tick_profile", None)
            if dump is None or getattr(w.engine, "_prof", None) is None:
                continue
            try:
                out.append(dump(os.path.join(
                    directory,
                    f"tickphase_{self.name}_{w.replica.name}.json")))
            except Exception:
                pass     # a failed dump only costs the phase artifact
        return out

    def prefix_digest_summary(self) -> Dict[str, Any]:
        """Compact prefix-digest-set summary for fleet gossip: the union
        of every replica engine's live prefix-cache digests plus a
        monotonic ``generation`` counter (sum of the engines'
        ``prefix_generation``). A poller that
        remembers the generation can skip re-fetching an unchanged set
        (``GET /debugz/prefix?if_gen=N``) — the cheap conditional
        fetch that makes sub-second gossip affordable.

        Monotonicity is RATCHETED at the gateway: the per-engine
        counters never reset in place (``hard_reset`` keeps counting)
        but a supervisor rebuild through ``engine_factory`` swaps in a
        FRESH engine whose counter restarts at 0 — the raw sum could
        regress and later collide with a previously-served value,
        making a poller's ``if_gen`` falsely read "unchanged". On any
        observed regression the base absorbs the drop plus one, so
        the exported generation strictly advances past every value
        ever served (called from the asyncio thread only)."""
        gen = 0
        digests: set = set()
        for w in list(self._workers):
            eng = w.engine
            gen += int(getattr(eng, "prefix_generation", 0))
            try:
                digests.update(k.hex() for k in
                               list(getattr(eng, "prefix_cache", {})))
            except RuntimeError:    # resized mid-iteration: torn read
                pass                # is fine — the next poll catches up
        spilled: List[str] = []
        if self._spill_arena is not None:
            # spill tier: advertise arena-resident digests
            # under a separate, cheaper key — a peer router treats them
            # as warm (a restore beats a re-prefill) without confusing
            # them with device-live spans. The arena's own monotonic
            # generation folds into the ratcheted counter so an if_gen
            # poller sees spill-tier changes too.
            gen += int(self._spill_arena.generation)
            live = digests
            spilled = [h for h in self._spill_arena.digest_hexes()
                       if h not in live]
        if gen < self._prefix_gen_last:
            self._prefix_gen_base += self._prefix_gen_last - gen + 1
        self._prefix_gen_last = gen
        doc = {"generation": self._prefix_gen_base + gen,
               "entries": len(digests),
               "digests": sorted(digests)}
        if self._spill_arena is not None:
            doc["spilled"] = spilled
            doc["spilled_entries"] = len(spilled)
        return doc

    def metricsz(self, window_s: Optional[float] = None
                 ) -> Dict[str, Any]:
        """``GET /metricsz?window_s=N``: windowed rates +
        quantiles as JSON, beside the Prometheus text endpoint —
        counter rates, gauge means and TRUE windowed histogram
        quantiles over the last N seconds, derived from the sampler's
        rings, plus the SLO burn/alert block. ``enabled: false`` when
        the sampler is off (the federating frontend skips those)."""
        if self.sampler is None:
            return {"gateway": self.name, "enabled": False}
        w = float(window_s) if window_s else \
            max(self.sampler.interval_s * 8, 2.0)
        doc: Dict[str, Any] = {
            "gateway": self.name,
            "enabled": True,
            "window_s": w,
            "interval_s": self.sampler.interval_s,
            "samples_taken": self.sampler.samples_taken,
            "metrics": self.sampler.window(w),
        }
        if self._slo is not None:
            doc["slo"] = self._slo.snapshot()
        return doc

    def debugz(self) -> Dict[str, Any]:
        """``GET /debugz``: live engine introspection — the
        slot map, block-pool occupancy/fragmentation, the prefix-cache
        digests the router probes, scheduler queues + tenant debt,
        per-replica EMAs, and the request-trace ring summaries. Reads
        cross-thread without pausing the tick threads (debug fidelity,
        not a consistency point)."""
        reps: Dict[str, Any] = {}
        for w in list(self._workers):
            b = getattr(w.replica, "breaker", None)
            rep: Dict[str, Any] = {"healthy": w.replica.healthy(),
                                   "alive": w.is_alive(),
                                   "failed": w.failed,
                                   "load": w.replica.load(),
                                   "breaker": b.snapshot()
                                   if b is not None else None}
            try:
                rep["engine"] = w.engine.debug_snapshot()
            except Exception as e:       # torn mid-tick read: partial
                rep["engine"] = {"error": repr(e)}
            # slot-transition cost counters, surfaced at the
            # replica top level so a fleet poller need not dig into the
            # engine snapshot — the snapshot's own block when it read
            # cleanly, rebuilt from the engine counters when it tore
            tr = rep["engine"].get("transitions") \
                if isinstance(rep["engine"], dict) else None
            rep["transitions"] = tr if tr is not None else {
                "delta_enabled": getattr(w.engine, "_delta", None),
                "patch_fuse_enabled": getattr(w.engine, "_fuse_patches",
                                              None),
                **{k: getattr(w.engine, k, None)
                   for k in ("full_rebuilds", "delta_patches",
                             "patches_fused", "patch_queue_overflows",
                             "ring_cursor_rollovers",
                             "h2d_uploads", "h2d_upload_bytes",
                             "dispatch_count")}}
            try:
                rep["scheduler"] = w.sched.debug_snapshot()
            except Exception as e:
                rep["scheduler"] = {"error": repr(e)}
            rep["trace_ring"] = (w.ring.summary()
                                 if w.ring is not None else None)
            # tick-phase profiler, surfaced like the
            # transition counters: the snapshot's block when it read
            # cleanly, a minimal enabled-flag otherwise
            tp = rep["engine"].get("tick_profile") \
                if isinstance(rep["engine"], dict) else None
            rep["tick_profile"] = tp if tp is not None else {
                "enabled": getattr(w.engine, "_prof", None) is not None}
            reps[w.replica.name] = rep
        sup = None
        if self._supervisor is not None:
            sup = {
                "alive": self._supervisor.is_alive(),
                "dispatch_timeout_s":
                    self._supervisor.dispatch_timeout_s,
                "watchdog_fires":
                    int(self._supervisor._c_watchdog.value),
            }
        return {
            "gateway": self.name,
            "draining": self.draining,
            "slow_ttft_ms": self._slow_ttft_ms,
            "failover_budget": self._failover_budget,
            "failovers": int(self._c_failovers.value),
            "retry_budget_exhausted": int(self._c_fo_exhausted.value),
            "supervisor": sup,
            "router": self._router.snapshot(),
            "replicas": reps,
            "prefix_digest_set": self.prefix_digest_summary(),
            "kv_spill": (self._spill_arena.snapshot()
                         if self._spill_arena is not None else None),
            # cross-replica transfer plane
            "kv_xfer": dict(
                kvxfer.counters_snapshot(self.name),
                migrate_on_drain=self._migrate_on_drain,
                migrated_requests=int(self._c_migrated.value)),
            # telemetry plane
            "telemetry": {
                "sampler": None if self.sampler is None else {
                    "running": self.sampler.running,
                    "interval_s": self.sampler.interval_s,
                    "capacity": self.sampler.capacity,
                    "samples_taken": self.sampler.samples_taken,
                    "metrics": len(self.sampler.names()),
                    "dropped_metrics": self.sampler.dropped_metrics,
                },
                "slo": self._slo.snapshot()
                if self._slo is not None else None,
            },
            # this process's hand-written kernel launches so far (a
            # fleet reads its replicas' counts here)
            "kernel_launches": launch_counts(),
        }

    # ------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        """Aggregated snapshot, read from the SAME registry objects a
        /metrics scrape exports (pinned equal by test)."""
        return {
            "gateway": self.name,
            "draining": self.draining,
            "requests": {slo: int(c.value)
                         for slo, c in self._c_requests.items()},
            "shed": int(self._c_shed.value),
            "completed": int(self._c_completed.value),
            "tokens": int(self._c_tokens.value),
            "disconnects": int(self._c_disconnects.value),
            "failovers": int(self._c_failovers.value),
            "retry_budget_exhausted": int(self._c_fo_exhausted.value),
            # the autoscaler's quality signal: same counters
            # the gateway_goodput_frac gauge is derived from, readable
            # by a remote fleet probe in one /healthz fetch
            "goodput_frac": round(
                self._c_good_tokens.value
                / max(self._c_tokens.value, 1.0), 4),
            "ttft_ms": self._h_ttft.stats(),
            "tpot_ms": self._h_tpot.stats(),
            "router": self._router.snapshot(),
            "replicas": {
                w.replica.name: dict(
                    healthy=w.replica.healthy(),
                    scheduler=w.sched.snapshot(),
                    engine=w.engine.health())
                for w in self._workers},
        }

    # ---------------------------------------------------------------- HTTP
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            line = await asyncio.wait_for(reader.readline(), 30)
            parts = line.decode("latin1").split()
            if len(parts) < 3:
                return
            method, path = parts[0], parts[1]
            headers: Dict[str, str] = {}
            while True:
                h = await asyncio.wait_for(reader.readline(), 30)
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            try:
                n = int(headers.get("content-length", "0") or 0)
                if n < 0:
                    raise ValueError("negative")
            except ValueError:
                writer.write(_json_response(
                    400, {"error": "bad Content-Length"}))
                await writer.drain()
                return
            if n:
                body = await asyncio.wait_for(reader.readexactly(n), 30)
            await self._dispatch_http(method, path, body, headers,
                                      reader, writer)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch_http(self, method, path, body, headers, reader,
                             writer):
        path, _, query = path.partition("?")
        path = path.rstrip("/") or "/"
        if method == "GET" and path == "/debugz/prefix":
            # the gossip poll: ``?if_gen=N`` answers a tiny
            # unchanged-marker instead of the digest list when the set
            # generation still equals N
            summary = self.prefix_digest_summary()
            if_gen = _query_param(query, "if_gen", int)
            if if_gen is not None and if_gen == summary["generation"]:
                writer.write(_json_response(
                    200, {"generation": summary["generation"],
                          "unchanged": True}))
            else:
                writer.write(_json_response(200, summary))
            await writer.drain()
            return
        if method == "GET" and path == "/healthz":
            writer.write(_json_response(200, self.health()))
            await writer.drain()
            return
        if method == "GET" and path == "/debugz":
            writer.write(_json_response(200, self.debugz()))
            await writer.drain()
            return
        if method == "GET" and path == "/metrics":
            writer.write(_http_response(
                200, obs.registry().prometheus_text().encode(),
                ctype="text/plain; version=0.0.4"))
            await writer.drain()
            return
        if method == "GET" and path == "/metricsz":
            # windowed JSON beside the Prometheus text
            window_s = _query_param(query, "window_s")
            writer.write(_json_response(200, self.metricsz(window_s)))
            await writer.drain()
            return
        if method == "GET" and path == "/kvz":
            await self._serve_kvz(query, writer)
            return
        if method == "GET" and path == "/profilez":
            await self._serve_profilez(query, writer)
            return
        if method == "POST" and path == "/v1/generate":
            await self._generate(body, headers, reader, writer)
            return
        writer.write(_json_response(404, {"error": f"no route {path}"}))
        await writer.drain()

    async def _serve_kvz(self, query: str, writer):
        """``GET /kvz?digest=<hex>``: one spill-arena span as a kvxfer
        wire record (peer fetch — the fleet-fetchable face of
        the gossip ``spilled`` tier; a rebuilt or different replica
        pulls a dead peer's spans instead of re-prefilling). 404 for
        anything not restorable. Chaos: ``xfer_slow`` delays the body
        here (the fetch side bounds it with ``xfer_timeout_s``); the
        encoder's ``xfer_corrupt``/``xfer_trunc`` sites damage it —
        the fetcher's decode ladder turns every one into a counted
        re-prefill fallback, never a token."""
        digest = _query_param(query, "digest", str)
        if self._spill_arena is None or not digest or not self._xfer_ok:
            writer.write(_json_response(
                404, {"error": "no spill arena" if
                      self._spill_arena is None else "missing digest"
                      if self._xfer_ok else "spans of a tp replica hold "
                      "one rank's heads"}))
            await writer.drain()
            return
        if faults.inject("xfer_slow", gateway=self.name,
                         digest=str(digest)[:12]):
            await asyncio.sleep(faults.xfer_slow_seconds())
        try:
            blob = kvxfer.export_span(
                self._spill_arena, str(digest),
                self._ref._spill_geometry(), gateway=self.name)
        except Exception:
            blob = None
        if blob is None:
            writer.write(_json_response(
                404, {"error": "span not restorable"}))
        else:
            writer.write(_http_response(
                200, blob, ctype="application/octet-stream"))
        await writer.drain()

    async def _serve_profilez(self, query: str, writer):
        """``GET /profilez?duration_s=N``: a
        BOUNDED on-demand capture — open a ``torch.profiler`` trace
        (CPU and, with a card, CUDA activity) through
        :class:`~..utils.profiler.Profiler` (whose module latch
        keeps this from corrupting a trace some training loop already
        owns — contention degrades to timer-only, never an error), let
        live traffic run for ``duration_s`` wall seconds, stop the
        trace, then dump every replica engine's tick-phase ring beside
        it (``tickphase_<gateway>_<replica>.json`` in the run dir).
        The response reports per-replica phase totals ACCUMULATED
        DURING THE WINDOW, so a caller gets the slope-vs-intercept
        split inline even with no run dir configured. One capture at a
        time (409 otherwise); duration is clamped to 30 s — this is a
        tap on a serving process, not a profiling session.

        The response says whether the trace ran (``traced``) and where
        its Chrome trace file is (``trace``); a trace that could not
        start or stop reports its error in ``trace_error``. Kernels a
        CUDA graph replays may be under-counted in the trace: a
        captured graph's node list is the sure count. The replicas
        pause while the trace turns on and while it stops (the stop
        also parses the trace: seconds at a large model's tick rate):
        ``Profiler`` holds ``device.card_lock`` alone there."""
        dur = _query_param(query, "duration_s")
        dur = 1.0 if dur is None else max(0.05, min(float(dur), 30.0))
        if self._profilez_busy:
            writer.write(_json_response(
                409, {"error": "capture already in progress"}))
            await writer.drain()
            return
        self._profilez_busy = True
        try:
            from ..utils.profiler import Profiler
            run_dir = obs.run_dir()
            trace_dir = os.path.join(run_dir, f"torchprof_{self.name}") \
                if run_dir else None
            prof = Profiler(logdir=trace_dir or "",
                            timer_only=trace_dir is None)
            before = {}
            for w in self._workers:
                p = getattr(w.engine, "_prof", None)
                if p is not None:
                    before[w.replica.name] = (
                        p.ticks, dict(p.totals), p.wall_total_ms)
            traced = False
            trace_error = None
            try:
                prof.start()
                traced = not prof.timer_only
            except Exception as e:
                prof = None       # the tick-ring dump still happens
                trace_error = repr(e)
            try:
                await asyncio.sleep(dur)
            finally:
                if prof is not None:
                    try:
                        prof.stop()
                    except Exception as e:
                        traced = False
                        trace_error = repr(e)
            reps: Dict[str, Any] = {}
            for w in self._workers:
                p = getattr(w.engine, "_prof", None)
                if p is None:
                    reps[w.replica.name] = {"enabled": False}
                    continue
                t0, tot0, w0 = before.get(
                    w.replica.name, (0, {}, 0.0))
                reps[w.replica.name] = {
                    "enabled": True,
                    "ticks_in_window": p.ticks - t0,
                    "wall_ms_in_window": round(
                        p.wall_total_ms - w0, 3),
                    "phase_ms_in_window": {
                        k: round(v - tot0.get(k, 0.0), 3)
                        for k, v in p.totals.items()},
                }
            files = self.dump_tick_profiles(run_dir) if run_dir else []
            obs.record_event("profilez_capture", gateway=self.name,
                             duration_s=dur,
                             traced=traced, files=len(files))
            writer.write(_json_response(200, {
                "gateway": self.name,
                "duration_s": dur,
                "traced": traced,
                "trace": prof.trace_path if traced else None,
                "trace_error": trace_error,
                "tickphase_files": files,
                "replicas": reps,
            }))
            await writer.drain()
        finally:
            self._profilez_busy = False

    # ------------------------------------------------------------ generate
    def _parse_request(self, body: bytes,
                       headers: Optional[Dict[str, str]] = None
                       ) -> ServeRequest:
        spec = json.loads(body.decode())
        if not isinstance(spec, dict):
            raise ValueError("request body must be a JSON object")
        ids = spec.get("prompt", spec.get("input_ids"))
        if not isinstance(ids, list) or not ids \
                or not all(isinstance(t, int) for t in ids):
            raise ValueError("prompt must be a non-empty list of "
                             "token ids")
        max_new = int(spec.get("max_new_tokens", 32))
        cap = self._ref.M * self._ref.B
        if len(ids) + max_new > cap:
            raise ValueError(f"prompt+max_new_tokens {len(ids)}+"
                             f"{max_new} exceeds per-request capacity "
                             f"{cap}")
        gen = {"max_new_tokens": max_new}
        for k in ("eos_token_id", "temperature", "top_k", "top_p",
                  "seed", "repetition_penalty"):
            if spec.get(k) is not None:
                gen[k] = spec[k]
        if spec.get("stop") is not None:
            gen["stop_sequences"] = [list(map(int, s))
                                     for s in spec["stop"]]
        # fleet failover resume: a fleet frontend whose peer
        # died mid-stream resubmits prompt+committed here; the engine
        # validates resume_tokens is the tail of the prompt and a
        # greedy stream continues bitwise (the in-process failover
        # seam, exposed over HTTP).
        if spec.get("resume_tokens") is not None:
            rt = spec["resume_tokens"]
            if not isinstance(rt, list) \
                    or not all(isinstance(t, int) for t in rt):
                raise ValueError("resume_tokens must be a list of "
                                 "token ids")
            gen["resume_tokens"] = rt
            rl = spec.get("resume_lps")
            if rl is not None:
                if not isinstance(rl, list) \
                        or not all(isinstance(v, (int, float))
                                   or v is None for v in rl):
                    raise ValueError("resume_lps must be a list of "
                                     "floats")
                gen["resume_lps"] = [float("nan") if v is None
                                     else float(v) for v in rl]
        # cross-replica KV transfer: optional reference to
        # the resumed stream's KV span — "b64:<wire record>" carries
        # the blob inline (drain migration resubmit), a bare digest
        # hex consults the local arena then the fleet fetch hook.
        # Strictly best-effort: any failure is a counted fallback and
        # the resume re-prefills; never a client-visible error.
        if spec.get("resume_kv"):
            try:
                self._consume_resume_kv(str(spec["resume_kv"]))
            except Exception:
                pass
        timeout_s = spec.get("timeout_s")
        deadline = (time.monotonic() + float(timeout_s)
                    if timeout_s is not None else None)
        digest = spec.get("affinity_key") or self._affinity_digests(ids)
        # trace-context id: body request_id wins, then an
        # inbound X-Request-Id header (the loadgen's client-minted id
        # — what lets trace_report join client and server views), then
        # a gateway-minted one. The SAME id keys the response, the
        # engine's ring entry and every metric exemplar.
        rid = spec.get("request_id") \
            or (headers or {}).get("x-request-id") \
            or uuid.uuid4().hex[:16]
        return ServeRequest(
            rid,
            ids, gen, slo=spec.get("slo", SLO_INTERACTIVE),
            tenant=str(spec.get("tenant", "default")),
            priority=int(spec.get("priority", 0)),
            deadline=deadline, digest=digest,
            sink=asyncio.Queue(), stream=bool(spec.get("stream", True)))

    def _consume_resume_kv(self, ref: str):
        """Make a ``resume_kv`` span arena-resident BEFORE admission,
        so the engine's ``_arena_restore`` turns the resume's
        prompt+committed re-prefill into one H2D scatter.
        ``b64:<base64 wire record>`` runs the inline blob through the
        kvxfer decode ladder; a bare digest hex checks residency and,
        on a miss, the fleet ``_xfer_fetch`` hook (peer ``GET /kvz``).
        Every failure mode — bad encoding, any ladder rung, no peer,
        over-capacity — leaves admission exactly as it was: the stream
        re-prefills, bitwise identical."""
        if self._spill_arena is None or not self._xfer_ok:
            return
        geo = self._ref._spill_geometry()
        if ref.startswith("b64:"):
            import base64
            import binascii
            try:
                blob = base64.b64decode(ref[4:], validate=True)
            except (binascii.Error, ValueError):
                return
            kvxfer.inject_span(self._spill_arena, blob, geo,
                               gateway=self.name)
            return
        try:
            raw = bytes.fromhex(ref)
        except ValueError:
            return
        if self._spill_arena.probe(raw) is not None \
                or self._xfer_fetch is None:
            return
        try:
            blob = self._xfer_fetch(ref)
        except Exception:
            blob = None
        if blob is not None:
            kvxfer.inject_span(self._spill_arena, blob, geo,
                               gateway=self.name)

    async def _generate(self, body, headers, reader, writer):
        if self.draining:
            writer.write(_json_response(
                503, {"error": "draining: not admitting new requests"},
                extra={"Retry-After": "1"}))
            await writer.drain()
            return
        try:
            req = self._parse_request(body, headers)
        except (ValueError, KeyError, TypeError) as e:
            # TypeError covers wrong-typed fields (int({}) etc.);
            # json.JSONDecodeError is a ValueError subclass
            writer.write(_json_response(400, {"error": str(e)}))
            await writer.drain()
            return
        if self._trace:
            req.trace = RequestTrace(req.request_id, tenant=req.tenant,
                                     slo=req.slo)
            req.trace.ev("accept", stream=req.stream,
                         prompt_tokens=len(req.input_ids))
        worker = None
        for attempt in (0, 1):
            meta: Dict[str, Any] = {}
            try:
                replica = self._router.route(
                    req.digest, trace=req.trace,
                    allow_probe=attempt == 0, meta=meta)
            except NoReplicaError as e:
                writer.write(_json_response(503, {"error": str(e)},
                                            extra={"Retry-After": "5"}))
                await writer.drain()
                return
            worker = self._by_replica[replica]
            # the router's verdict is the AUTHORITATIVE probe signal —
            # only a request the router handed the breaker's probe
            # slot may report probe_done (inferring from healthy()
            # would let a replica failing between route and here
            # impersonate the real probe and corrupt its accounting)
            req.probe = meta.get("verdict") == "probe"
            if req.probe and req.trace is not None:
                req.trace.ev("breaker_half_open",
                             replica=replica.name)
            try:
                # the engine's own backpressure fields, read O(1) (a
                # full health() snapshot per request is scrape-grade
                # work) — live protection for engines that ALSO take
                # out-of-band submit() traffic; the gateway's own
                # admission keeps the engine queue shallower than this
                eng = worker.engine
                worker.sched.enqueue(
                    req, engine_health={"queued": len(eng.queue),
                                        "queue_capacity": eng.max_queue})
            except ShedError as e:
                self._c_shed.inc()
                # a shed probe says "overloaded", not "broken":
                # release the slot without moving the breaker
                _release_probe(req, worker.replica)
                if req.trace is not None:
                    req.trace.ev("shed", retry_after_s=e.retry_after_s)
                    if worker.ring is not None:
                        worker.ring.finish(req.trace, "shed")
                writer.write(_json_response(
                    429, {"error": str(e),
                          "retry_after_s": e.retry_after_s},
                    extra={"Retry-After":
                           str(max(int(e.retry_after_s), 1))}))
                await writer.drain()
                return
            worker.wake()
            if worker.is_alive() and not worker.failed \
                    and (worker.replica.healthy() or req.probe):
                break
            # raced a worker exit/failure: drain (thread checked its
            # queue empty and returned as this request landed),
            # _fail_all (flush drained this request or this check
            # catches it), or a probe that reached a replica whose
            # rebuild isn't live yet — nothing here will serve it;
            # take it back and RE-ROUTE once through the plain ladder
            # before giving up with a 503. A probe that hit
            # a FAILED/dead worker reports failure (re-opens, longer
            # backoff) — treating it as inconclusive would let a
            # permanently-unrebuildable replica turn every future
            # request into a doomed probe detour forever.
            if not worker.sched.cancel(req.request_id):
                # somebody already CLAIMED it — the worker's failover
                # drained its queue (resubmitting this request and
                # updating req.owner) or its queue flush errored it
                # into the sink. Either way events are coming;
                # enqueueing a second copy would serve the request on
                # two replicas into one sink. Probe accounting, if
                # any, was settled by the claimant.
                break
            _release_probe(req, worker.replica,
                           False if (worker.failed
                                     or not worker.is_alive())
                           else None)
        else:
            if worker.ring is not None and req.trace is not None:
                worker.ring.finish(req.trace, "error")
            writer.write(_json_response(
                503, {"error": "replica unavailable; retry"},
                extra={"Retry-After": "1"}))
            await writer.drain()
            return
        self._c_requests[req.slo].inc()
        # the claimed-race break above may have handed ownership to a
        # failover target already — never clobber that
        req.owner = req.owner or worker
        if req.stream:
            await self._stream_sse(worker, req, reader, writer)
        else:
            await self._wait_json(worker, req, reader, writer)

    def _on_disconnect(self, worker: _ReplicaWorker, req: ServeRequest):
        """Client dropped mid-request: cancel on the tick thread so the
        slot/blocks free immediately (a dropped stream never
        strands a slot). ``req.owner`` tracks failover moves, so the
        cancel lands on the replica CURRENTLY serving the request, not
        the one that accepted it."""
        self._c_disconnects.inc()
        w = req.owner or worker
        w.post(lambda: w.cancel_request(req.request_id, req))

    async def _stream_sse(self, worker, req, reader, writer):
        try:
            writer.write(_SSE_HEAD)
            await writer.drain()
        except (ConnectionError, OSError):
            self._on_disconnect(worker, req)
            return
        eof = asyncio.ensure_future(reader.read())
        try:
            while True:
                get = asyncio.ensure_future(req.sink.get())
                if eof is None:
                    ev = await get
                else:
                    done, _ = await asyncio.wait(
                        {get, eof},
                        return_when=asyncio.FIRST_COMPLETED)
                    if get not in done:
                        # read side closed. A dropped client AND a
                        # legal HTTP half-close (shutdown(SHUT_WR)
                        # after the body, still reading the response)
                        # both look like EOF here — probe with an SSE
                        # comment: only a truly dead peer fails the
                        # write. Later token writes keep catching
                        # disconnects once the watch is off.
                        get.cancel()
                        try:
                            writer.write(b": half-close probe\n\n")
                            await writer.drain()
                        except (ConnectionError, OSError):
                            self._on_disconnect(worker, req)
                            return
                        eof = None
                        continue
                    ev = get.result()
                try:
                    if ev[0] == "token":
                        payload = {"token": ev[1], "lp": ev[2]}
                        if faults.inject("stream_stall",
                                         request=str(req.request_id)):
                            # slow client / congested wire stand-in:
                            # stalls THIS coroutine only — the tick
                            # loop and sibling streams keep moving
                            await asyncio.sleep(
                                faults.stream_stall_seconds())
                    elif ev[0] == "done":
                        payload = dict(ev[1], done=True)
                    else:
                        payload = {"error": ev[2], "done": True}
                    writer.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                    await writer.drain()
                except (ConnectionError, OSError):
                    self._on_disconnect(worker, req)
                    return
                if ev[0] != "token":
                    return
        finally:
            if eof is not None and not eof.done():
                eof.cancel()

    async def _wait_json(self, worker, req, reader, writer):
        # no EOF watch here: a JSON response can't carry a mid-wait
        # probe, and a legal half-closing client must still get its
        # response — a vanished one costs only the final failed write
        while True:
            ev = await req.sink.get()
            if ev[0] == "token":
                continue
            try:
                if ev[0] == "error":
                    writer.write(_json_response(
                        ev[1], {"error": ev[2],
                                "request_id": req.request_id}))
                else:
                    info = ev[1]
                    reason = info.get("finish_reason", "stop")
                    if reason == "timeout":
                        writer.write(_json_response(
                            504, {"error": "deadline exceeded",
                                  "request_id": req.request_id,
                                  "finish_reason": reason}))
                    else:
                        writer.write(_json_response(
                            200, dict(info,
                                      request_id=req.request_id)))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            return
