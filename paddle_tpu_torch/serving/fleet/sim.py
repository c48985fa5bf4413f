"""Trace-driven fleet chaos simulator (counterpart of
``paddle_tpu/serving/fleet/sim.py``; reference:
discrete-event cluster simulators production control planes are
rehearsed in — Borg/Omega trace replay, Jepsen-style fault schedules —
restated in-process over THIS repo's real serving control plane).

Every hardening question at real fleet scale — probe storms at
hundreds of peers, gossip fan-out across N frontends, burn-rate alert
precision during a correlated AZ-style outage, scale-controller
behavior when a majority of signals goes stale — is untestable by a
CPU loadgen run. But the whole frontend stack was built model-free and
clock-injectable, so the sim instantiates the REAL objects:

- :class:`~.frontend.FleetFrontend` (its real
  :class:`~...router.PrefixAffinityRouter` makes every routing
  decision; its real :class:`~...supervisor.CircuitBreaker` instances
  run probation on the simulated clock),
- :class:`~.autoscaler.FleetAutoscaler` (``step(now)`` on the sim
  clock over a :class:`SimManager`),
- :class:`~...slo.BurnRateEngine` (batched outcome intake via
  ``observe_many`` — the alerts scored against injected incidents are
  produced by the production alerting math),
- the real probe schedule (:func:`~.remote.probe_phase` /
  :func:`~.remote.probe_delay` — shared verbatim with the live prober
  thread, so storm behavior measured in-sim IS the production
  schedule).

Only the replica itself is a stub: :class:`SimReplica` duck-types the
RemoteReplica seam (``healthy``/``load``/``has_prefix``/``signals``/
``metricsz``/``note_proxy_failure``/``adopt_digests``/``gossip_view``)
over a scriptable :class:`SimProcess` (latency, slots, prefix
distribution, up/down). ``real_objects()`` asserts the control-plane
classes are the production ones by identity — the sim cannot silently
fork the logic it claims to rehearse.

**Probe capacity model.** Probe rounds draw from a per-time-bin
execution budget (the frontend's finite probe concurrency). A round
that cannot find a free bin within ``probe_timeout_s`` FAILS like a
real timed-out probe — consecutive failures evict and open breakers.
A seeded, jittered schedule spreads demand and fits the budget; the
``peer_storm`` fault site collapses the jitter so every peer's round
fires at once, and the resulting timeout->eviction->page cascade is
exactly what the probe-storm schedule must detect (and what the
jittered clean twin must NOT).

**Scoring.** Chaos schedules carry ground-truth incident windows.
Page-rule fires inside an incident window (+ the slow-window grace)
are true positives; fires outside any window are false pages.
``precision`` / ``recall`` land in the banked rung beside routing
decisions/sec and scale-event counts.

**Frontend HA.** With ``n_frontends >= 2`` each frontend holds its
own adapter views over the shared processes (the real multi-frontend
topology), gossip flows through real :class:`~.ha.FrontendLink`
rounds, and :meth:`FleetSim.kill_frontend` severs one frontend
mid-run: every in-flight stream's client retries against a survivor
carrying its committed prefix through the ``resume_tokens`` seam —
the sim asserts zero lost and zero duplicated committed tokens.
"""
from __future__ import annotations

import argparse
import heapq
import json
import os
import math
import random
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...utils import faults
from ...utils import observability as obs
from ..router import NoReplicaError, PrefixAffinityRouter
from ..slo import BurnRateEngine
from ..supervisor import CircuitBreaker
from .autoscaler import FleetAutoscaler
from .frontend import FleetFrontend
from .ha import FrontendLink
from .remote import probe_delay, probe_phase

__all__ = ["SimClock", "SimProcess", "SimReplica", "SimManager",
           "Incident", "FleetSim", "SCENARIOS", "build_scenario",
           "arrivals_from_series", "arrivals_from_reqtrace"]


class SimClock:
    """Deterministic simulated monotonic clock. Injected everywhere a
    control-plane object accepts ``clock=`` (breakers via the
    frontend, autoscaler, burn engine, series sampler, stubs)."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, to: float):
        if to < self.now:
            raise ValueError(f"clock moved backwards: {to} < {self.now}")
        self.now = float(to)


class SimProcess:
    """The underlying replica gateway process: ground-truth state the
    per-frontend :class:`SimReplica` views observe through probes.
    Scriptable: ``service_s`` (base stream duration), ``slow_mult``
    (brownout), ``up`` (outage), ``slots`` (concurrency before
    queueing/shedding)."""

    def __init__(self, name: str, *, slots: int = 4,
                 service_s: float = 1.0):
        self.name = name
        self.up = True
        self.retired = False
        self.slots = max(int(slots), 1)
        self.service_s = float(service_s)
        self.slow_mult = 1.0
        self.active = 0
        self.completed = 0
        self.tokens = 0
        self.digests: set = set()
        # spilled tier: digests surviving only in the
        # process's host-RAM arena — populated by restart(spill=True),
        # promoted back to device-live by the next request that lands
        self.spilled: set = set()
        self.digest_gen = 0
        # probe connections landing on this process (sliding 1s
        # window): health checks run ON the serving process, so a
        # synchronized herd steals decode cycles — the coupling that
        # turns a probe storm into a latency incident
        self._probe_hits: List[float] = []

    def add_digest(self, d: str):
        if d not in self.digests:
            self.digests.add(d)
            self.spilled.discard(d)   # promoted back to device-live
            self.digest_gen += 1

    def restart(self, spill: bool = False):
        """Crash/rebuild the process's engine: device-live digests die
        with the pools. With a spill arena (``spill=True``) they move
        to the spilled tier instead — restorable, still routable —
        which is exactly the warm-restart contract of the spill tier."""
        if spill:
            self.spilled |= self.digests
        else:
            self.spilled.clear()
        self.digests.clear()
        self.digest_gen += 1

    def note_probe(self, now: float):
        hits = self._probe_hits
        hits.append(now)
        if len(hits) > 8 and hits[0] < now - 1.0:
            self._probe_hits = [t for t in hits if t >= now - 1.0]

    def probe_rate(self, now: float) -> float:
        return float(sum(1 for t in self._probe_hits
                         if t >= now - 1.0))

    def latency_s(self, rng: random.Random, now: float,
                  probe_load_cost: float = 0.0) -> float:
        """Stream duration for one request admitted NOW: base service
        time x brownout multiplier x a queueing factor once the
        process runs past its slot budget x the probe-pressure tax,
        +-10% seeded noise."""
        queue_factor = 1.0 + max(self.active - self.slots, 0) \
            / self.slots
        probe_factor = 1.0 + probe_load_cost * self.probe_rate(now)
        return self.service_s * self.slow_mult * queue_factor \
            * probe_factor * (0.9 + 0.2 * rng.random())


class SimReplica:
    """Per-frontend adapter view over one :class:`SimProcess`,
    duck-typed to the RemoteReplica seam the router/autoscaler/
    frontend read. Probe rounds (driven by the sim's event loop on
    the REAL seeded schedule) refresh the snapshot; the same
    staleness bound, failure latch, breaker-mediated rejoin and
    generation-guarded gossip adoption semantics as the live
    adapter."""

    def __init__(self, proc: SimProcess, clock: SimClock, *,
                 stale_after_s: float = 2.5, fail_threshold: int = 2):
        self.proc = proc
        self.name = proc.name
        self.host, self.port = "sim", 0
        self._clock = clock
        self.stale_after_s = float(stale_after_s)
        self.fail_threshold = max(int(fail_threshold), 1)
        self.breaker: Optional[CircuitBreaker] = None
        self._healthy = True
        self._fails = 0
        self._snap_t: Optional[float] = None
        self._load = 0.0
        self._queue_depth = 0
        self._free_slots = self._total_slots = 0
        self._digests: frozenset = frozenset()
        self._spilled: frozenset = frozenset()
        self._digest_gen = -1
        self._digest_t: Optional[float] = None
        self.probes_total = 0
        self.probe_failures_total = 0

    # ---------------------------------------------------- probe (sim-driven)
    def probe(self) -> bool:
        """One probe round landing NOW (the sim's stand-in for
        ``RemoteReplica.refresh``): success refreshes the snapshot
        (and, partition permitting, the gossiped digest set); failure
        counts toward the eviction latch exactly like the live
        adapter."""
        self.probes_total += 1
        if not self.proc.up:
            return self.probe_fail("down")
        now = self._clock()
        self._snap_t = now
        self._load = float(self.proc.active)
        self._queue_depth = max(self.proc.active - self.proc.slots, 0)
        self._free_slots = max(self.proc.slots - self.proc.active, 0)
        self._total_slots = self.proc.slots
        if not faults.inject("gossip_partition", replica=self.name):
            if self.proc.digest_gen != self._digest_gen:
                self._digests = frozenset(self.proc.digests)
                self._spilled = frozenset(self.proc.spilled)
                self._digest_gen = self.proc.digest_gen
            self._digest_t = now
        self._fails = 0
        if not self._healthy and self.breaker is None:
            self._healthy = True
        return True

    def probe_fail(self, reason: str) -> bool:
        self.probe_failures_total += 1
        self._fails += 1
        if self._fails >= self.fail_threshold and self._healthy:
            self._healthy = False
            obs.record_event("fleet_peer_down", peer=self.name,
                             fails=self._fails, reason=reason)
            if self.breaker is not None:
                self.breaker.record_failure()
        return False

    # ------------------------------------------------------ the router seam
    def _fresh(self) -> bool:
        return self._snap_t is not None \
            and self._clock() - self._snap_t <= self.stale_after_s

    def healthy(self) -> bool:
        return self._healthy and self._fresh()

    def mark(self, healthy: bool):
        self._healthy = bool(healthy)

    def load(self) -> float:
        return self._load

    def has_prefix(self, digest: str) -> bool:
        if self._digest_t is None \
                or self._clock() - self._digest_t > self.stale_after_s:
            return False
        # spilled tier counts as warm, mirroring the live adapter
        return digest in self._digests or digest in self._spilled

    def note_proxy_failure(self):
        self._healthy = False
        if self.breaker is not None:
            self.breaker.record_failure()

    def start(self):
        pass                    # the sim's event loop IS the prober

    def stop(self, timeout: float = 0.0):
        pass

    def refresh(self) -> bool:
        return self.probe()

    def set_metrics_window(self, window_s: float):
        pass

    def signals(self) -> Dict[str, Any]:
        return {
            "peer": self.name,
            "healthy": self.healthy(),
            "stale": not self._fresh(),
            "load": self._load,
            "queue_depth": self._queue_depth,
            "free_slots": self._free_slots,
            "total_slots": self._total_slots,
            "block_pool_free_frac": 1.0,
            "goodput_frac": 1.0,
        }

    def metricsz(self) -> Dict[str, Any]:
        age = None if self._snap_t is None \
            else self._clock() - self._snap_t
        return {"peer": self.name,
                "age_s": age,
                "stale": age is None or age > self.stale_after_s,
                "doc": {"enabled": True, "gateway": self.name,
                        "metrics": {}, "slo": {}}}

    def snapshot(self) -> Dict[str, Any]:
        out = {"peer": self.name, "healthy": self.healthy(),
               "stale": not self._fresh(),
               "probes": self.probes_total,
               "probe_failures": self.probe_failures_total,
               "gossip": {"digests": len(self._digests),
                          "spilled": len(self._spilled),
                          "generation": self._digest_gen}}
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        return out

    # ------------------------------------------------- frontend HA gossip
    def adopt_digests(self, digests, generation: int,
                      spilled=()) -> bool:
        gen = int(generation)
        if gen <= self._digest_gen:
            return False
        self._digests = frozenset(digests or ())
        self._spilled = frozenset(spilled or ())
        self._digest_gen = gen
        self._digest_t = self._clock()
        return True

    def gossip_view(self) -> Dict[str, Any]:
        out = {"digests": sorted(self._digests),
               "spilled": sorted(self._spilled),
               "generation": self._digest_gen,
               "healthy": self.healthy()}
        if self.breaker is not None:
            out["breaker"] = self.breaker.state
        return out


class SimManager:
    """The autoscaler's manager duck type over the sim fleet: spawns
    complete after ``cold_start_s`` of simulated time (a pending spawn
    counts toward the target, like the process manager's)."""

    def __init__(self, sim: "FleetSim", cold_start_s: float = 5.0):
        self.sim = sim
        self.name = "sim"
        self.cold_start_s = float(cold_start_s)
        self._pending = 0
        self.spawns = 0
        self.retires = 0

    def replicas(self) -> List[SimReplica]:
        return list(self.sim.frontends[0].peers)

    def pending(self) -> int:
        return self._pending

    def scale_up(self):
        self._pending += 1
        self.spawns += 1
        sim = self.sim
        name = f"sim{len(sim.procs)}"

        def _spawned():
            self._pending -= 1
            sim.add_process(SimProcess(
                name, slots=sim.slots, service_s=sim.service_s))
        sim.schedule(sim.clock.now + self.cold_start_s, _spawned)

    def scale_down(self):
        sim = self.sim
        for proc in reversed(sim.procs):
            if proc.up and not proc.retired:
                self.retires += 1
                sim.retire_process(proc)
                return


class _FleetRegistryView:
    """Registry facade that exposes only the fleet/SLO/fault metrics
    to the sim's sampler. The frontend registers its counters in the
    PROCESS registry (same code path as live serving), so a sim run
    inside a process that previously served real traffic — one pytest
    session, a notebook — would otherwise sample that unrelated
    history into its ``series`` dump and fleet_dash would classify
    the doc as a gateway doc instead of a sim doc."""

    _PREFIXES = ("fleet_", "slo_", "fault_")

    def _items(self):
        for item in obs.registry()._items():
            if item[0].startswith(self._PREFIXES):
                yield item


class Incident:
    """One ground-truth chaos window: ``apply(sim)`` at ``t0``,
    ``revert(sim)`` at ``t1``. ``page=True`` marks windows the page
    alert MUST detect (recall) — fires outside every window are false
    pages (precision)."""

    def __init__(self, kind: str, t0: float, t1: float, *,
                 page: bool, apply: Callable, revert: Callable):
        self.kind = kind
        self.t0, self.t1 = float(t0), float(t1)
        self.page = bool(page)
        self.apply, self.revert = apply, revert


class FleetSim:
    """Discrete-event fleet simulator over the real control plane.

    ``rate_fn(t) -> requests/s`` drives open-loop arrivals (seeded
    exponential inter-arrivals); ``arrival_times`` replays a recorded
    trace instead. ``incidents`` are ground-truth chaos windows."""

    def __init__(self, *, n_replicas: int = 100, n_frontends: int = 1,
                 duration_s: float = 300.0, seed: int = 0,
                 rate_fn: Optional[Callable[[float], float]] = None,
                 base_rate: float = 20.0, rate_amp: float = 0.0,
                 rate_cycles: float = 1.0,
                 arrival_times: Optional[List[float]] = None,
                 slots: int = 4, service_s: float = 1.0,
                 spill_margin: Optional[float] = None,
                 slo_latency_s: Optional[float] = None,
                 prefix_pool: int = 32, prefix_alpha: float = 1.2,
                 tokens_per_request: int = 32,
                 prompt_tokens: int = 128,
                 probe_interval_s: float = 1.0,
                 stale_after_s: float = 2.5,
                 jitter_frac: float = 0.2,
                 probe_bin_s: float = 0.05,
                 probe_capacity_per_bin: Optional[int] = None,
                 probe_timeout_s: float = 0.3,
                 probe_load_cost: float = 0.15,
                 fe_pressure_cost: float = 0.5,
                 gossip_interval_s: float = 1.0,
                 autoscale: bool = False,
                 scaler_kw: Optional[Dict[str, Any]] = None,
                 window_scale: float = 0.2,
                 failover_budget: int = 2,
                 slo_tick_s: float = 1.0,
                 incidents: Tuple[Incident, ...] = (),
                 kill_frontend_at: Optional[float] = None,
                 sample_interval_s: float = 2.0):
        self.seed = int(seed)
        self.rng = random.Random(f"fleet-sim:{seed}")
        self.clock = SimClock()
        self.duration_s = float(duration_s)
        self.slots, self.service_s = int(slots), float(service_s)
        # spill before the shed cliff: a warm pick running past its
        # slot budget must lose to a cold idle peer (the live margin
        # of 8 is sized for 8-slot gateways; scale it to the stubs')
        self.spill_margin = float(spill_margin) \
            if spill_margin is not None else float(self.slots)
        self.slo_latency_s = float(slo_latency_s) \
            if slo_latency_s is not None else 3.0 * self.service_s
        self.prefix_pool = int(prefix_pool)
        self.prefix_alpha = float(prefix_alpha)
        self.tokens_per_request = int(tokens_per_request)
        self.prompt_tokens = int(prompt_tokens)
        self.probe_interval_s = float(probe_interval_s)
        self.stale_after_s = float(stale_after_s)
        self.jitter_frac = float(jitter_frac)
        self.probe_bin_s = float(probe_bin_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe_load_cost = float(probe_load_cost)
        self.fe_pressure_cost = float(fe_pressure_cost)
        self.gossip_interval_s = float(gossip_interval_s)
        self.failover_budget = int(failover_budget)
        self.slo_tick_s = float(slo_tick_s)
        self.sample_interval_s = float(sample_interval_s)
        self.incidents = tuple(incidents)
        self.kill_frontend_at = kill_frontend_at
        # arrivals: replayed trace or rate-driven open loop
        if arrival_times is not None:
            self._arrivals = sorted(float(t) for t in arrival_times
                                    if 0.0 <= float(t) <= duration_s)
            self.rate_fn = None
        else:
            self._arrivals = None
            self.rate_fn = rate_fn or (
                lambda t: base_rate * (1.0 + rate_amp * math.sin(
                    2.0 * math.pi * rate_cycles * t / duration_s)))
        # probe budget PER FRONTEND (each frontend runs its own
        # prober threads off its own event loop/GIL): sized so the
        # JITTERED schedule fits with ~50% headroom; a storm-collapsed
        # schedule overflows it
        self.probe_capacity_per_bin = int(probe_capacity_per_bin) \
            if probe_capacity_per_bin is not None else max(
                4, int(1.5 * int(n_replicas) * self.probe_bin_s
                       / self.probe_interval_s))
        # ------------------------------------------------------ event loop
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = 0
        # (frontend idx, time bin) -> executed / attempted probe counts
        self._bins: Dict[Tuple[int, int], int] = {}
        self._attempts: Dict[Tuple[int, int], int] = {}
        self._inflight: Dict[int, Dict[str, Any]] = {}
        self._req_seq = 0
        self._rr = 0
        self._outcomes: List[Tuple[float, bool]] = []
        self.flight: List[Dict[str, Any]] = []
        # tallies
        self.decisions = 0
        self.verdicts: Dict[str, int] = {}
        self.requests = self.completed = self.failed = 0
        self.shed = self.no_replica = 0
        self.probe_rounds = self.probe_deferred = 0
        self.probe_timeouts = 0
        self.ha = {"severed_streams": 0, "resumed_streams": 0,
                   "synthesized_streams": 0, "corrupted_streams": 0,
                   "committed_tokens_preserved": 0,
                   "tokens_lost": 0, "tokens_duplicated": 0}
        # cross-replica KV transfer tier: spans a migrating
        # drain exported become fleet-fetchable (the /kvz wire path);
        # recompute_tokens counts every prefill token a drain forced a
        # survivor to re-run — the quantity migration exists to zero
        self.fleet_spill: set = set()
        self.xfer = {"drained_procs": 0, "migrated_requests": 0,
                     "xfer_hits": 0, "recompute_tokens": 0}
        self._wall_cpu: Optional[float] = None
        # ---------------------------------------------- the REAL objects
        self.procs: List[SimProcess] = []
        self.frontends: List[FleetFrontend] = []
        self.fe_alive: List[bool] = []
        for i in range(int(n_frontends)):
            fe = FleetFrontend(
                [], chunk_tokens=None, routing="prefix",
                spill_margin=self.spill_margin,
                failover_budget=self.failover_budget,
                breaker_backoff_s=1.0,
                name=f"simfe{i}", trace=False, clock=self.clock)
            self.frontends.append(fe)
            self.fe_alive.append(True)
        for i in range(int(n_replicas)):
            self.add_process(SimProcess(f"sim{i}", slots=self.slots,
                                        service_s=self.service_s),
                            initial=True)
        self.links: List[FrontendLink] = []
        for fe in self.frontends:
            for sib in self.frontends:
                if sib is not fe:
                    self.links.append(FrontendLink(
                        fe, sib, interval_s=self.gossip_interval_s,
                        jitter_frac=self.jitter_frac, seed=self.seed))
        self.engine = BurnRateEngine(window_scale=float(window_scale),
                                     min_window_events=24,
                                     max_events=65536,
                                     labels={"fleet": "sim"},
                                     clock=self.clock)
        self.manager = SimManager(self)
        self.scaler = None
        if autoscale:
            kw = dict(min_replicas=1,
                      max_replicas=max(2 * int(n_replicas), 4),
                      interval_s=1.0, clock=self.clock)
            kw.update(scaler_kw or {})
            self.scaler = FleetAutoscaler(self.manager, **kw)
            self.frontends[0].attach_autoscaler(self.scaler)
        self.series = obs.MetricsTimeSeries(
            name=f"sim{self.seed}", registry=_FleetRegistryView(),
            interval_s=self.sample_interval_s,
            capacity=2048, clock=self.clock)

    # ---------------------------------------------------------- membership
    def add_process(self, proc: SimProcess, initial: bool = False):
        self.procs.append(proc)
        for fe in self.frontends:
            view = SimReplica(proc, self.clock,
                              stale_after_s=self.stale_after_s)
            fe.add_peer(view)       # REAL membership path: breaker
            #                         attach (clock-injected) + router
            # first probe lands immediately (the manager's
            # spawn-then-refresh), then the seeded schedule
            view.probe()
            self._schedule_probe_chain(fe, view)

    def retire_process(self, proc: SimProcess):
        """Graceful scale-down: out of rotation everywhere, in-flight
        streams finish on their own (the live manager's drain)."""
        proc.retired = True
        for fe in self.frontends:
            for view in list(fe.peers):
                if view.proc is proc:
                    fe.remove_peer(view)

    def drain_one(self, migrate: bool):
        """One scale-down wave step: retire the MOST-loaded live proc
        — the worst case for a drain, maximum in-flight cut-overs."""
        cands = [p for p in self.procs if p.up and not p.retired]
        if len(cands) <= 1:
            return
        self.drain_process(max(cands, key=lambda p: p.active),
                           migrate=migrate)

    def drain_process(self, proc: SimProcess, migrate: bool):
        """Scale-down drain of ``proc``. With ``migrate``
        the retiring replica exports each live request's KV span to
        the fleet spill tier (the live stack's terminal ``migrated``
        event + ``/kvz`` wire path) and the request cuts over to a
        survivor that RESTORES the span — zero re-prefill. Without,
        the requests resubmit on the classic resume seam and the
        survivor re-prefills prompt+committed: exactly the recompute
        the migration exists to eliminate, scored per token in
        ``xfer["recompute_tokens"]``."""
        self.xfer["drained_procs"] += 1
        live = [rid for rid, req in self._inflight.items()
                if req["proc"] is proc and not req["cancelled"]]
        self._event("drain", proc=proc.name, migrate=migrate,
                    live=len(live))
        self.retire_process(proc)
        if migrate:
            # the replica's whole arena becomes fleet-fetchable —
            # the gossiped spilled tier, now served over the wire
            self.fleet_spill |= proc.digests | proc.spilled
        for rid in live:
            req = self._inflight.pop(rid)
            req["cancelled"] = True
            proc.active = max(proc.active - 1, 0)
            committed = req["resume_from"] + int(
                (self.tokens_per_request - req["resume_from"])
                * min((self.clock.now - req["t_start"])
                      / max(req["latency"], 1e-9), 1.0))
            if migrate:
                self.fleet_spill.add(f"req{rid}")
                self.xfer["migrated_requests"] += 1
                self.xfer["xfer_hits"] += 1
                # one D2H export + one H2D scatter on the survivor;
                # sub-chunk tail recompute is noise, scored as zero
            else:
                self.xfer["recompute_tokens"] += \
                    self.prompt_tokens + committed
            fe = req["fe"]
            if not self.fe_alive[self.frontends.index(fe)]:
                fe = self._live_frontend()
                if fe is None:
                    self._finish_outcome(False)
                    continue
            self._dispatch(rid, fe, req["digests"], hops=0,
                           resume_from=committed,
                           t_accept=req["t_accept"])

    # ------------------------------------------------------------ schedule
    def schedule(self, t: float, fn: Callable):
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, fn))

    def _event(self, kind: str, **fields):
        self.flight.append({"t": round(self.clock.now, 3),
                            "kind": kind, **fields})

    # -------------------------------------------------------------- probes
    def _schedule_probe_chain(self, fe: FleetFrontend,
                              view: SimReplica):
        key = f"{fe.name}:{view.name}"
        t0 = self.clock.now + probe_phase(
            key, self.probe_interval_s, seed=self.seed)
        self.schedule(t0, lambda: self._probe_round(fe, view, 0, t0))

    def _probe_round(self, fe: FleetFrontend, view: SimReplica,
                     rnd: int, t_req: float):
        fi = self.frontends.index(fe)
        if view not in fe.peers or not self.fe_alive[fi]:
            return                    # retired peer / dead frontend
        self.probe_rounds += 1
        b0 = int(t_req / self.probe_bin_s)
        self._attempts[(fi, b0)] = self._attempts.get((fi, b0), 0) + 1
        # capacity: claim the earliest bin with budget left inside the
        # timeout horizon; none -> the executor rejects the round
        # (fail-fast, never reaches the replica) and it counts as a
        # probe FAILURE
        b = b0
        horizon = b0 + max(int(self.probe_timeout_s
                               / self.probe_bin_s), 1)
        placed = None
        while b <= horizon:
            if self._bins.get((fi, b), 0) \
                    < self.probe_capacity_per_bin:
                self._bins[(fi, b)] = self._bins.get((fi, b), 0) + 1
                placed = b
                break
            b += 1
        if placed is None:
            self.probe_timeouts += 1
            view.probe_fail("probe_timeout")
        else:
            if placed > b0:
                self.probe_deferred += 1
            # an EXECUTED probe opens a connection against the serving
            # process: the probe tax that turns a monopolized storm
            # schedule into a latency incident on the winners' procs
            view.proc.note_probe(t_req)
            view.probe()
        # next round on the REAL seeded schedule (peer_storm collapses
        # the delay to 0 — the synchronized herd); floored at one bin,
        # the live prober's reconnect floor
        key = f"{fe.name}:{view.name}"
        dt = probe_delay(key, self.probe_interval_s, rnd + 1,
                         jitter_frac=self.jitter_frac, seed=self.seed)
        t_next = self.clock.now + max(dt, self.probe_bin_s)
        self.schedule(t_next,
                      lambda: self._probe_round(fe, view, rnd + 1,
                                                t_next))

    # -------------------------------------------------------------- gossip
    def _gossip_round(self, link: FrontendLink, rnd: int):
        i = self.frontends.index(link.frontend)
        j = self.frontends.index(link.sibling) \
            if link.sibling in self.frontends else -1
        if self.fe_alive[i] and (j < 0 or self.fe_alive[j]):
            link.exchange()           # REAL merge path (+ the
            #                           gossip_partition fault site)
        dt = probe_delay(link.name, self.gossip_interval_s, rnd + 1,
                         jitter_frac=self.jitter_frac, seed=self.seed)
        self.schedule(self.clock.now + max(dt, self.probe_bin_s),
                      lambda: self._gossip_round(link, rnd + 1))

    # ------------------------------------------------------------ requests
    def _pick_prefix(self) -> List[str]:
        """Zipf-ish draw over the shared-prefix pool (hot prefixes are
        the affinity routing signal)."""
        u = self.rng.random()
        k = int(self.prefix_pool * (u ** self.prefix_alpha))
        return [f"pfx{min(k, self.prefix_pool - 1)}"]

    def _live_frontend(self) -> Optional[FleetFrontend]:
        """Client-side LB: round-robin over frontends it can reach."""
        n = len(self.frontends)
        for _ in range(n):
            fe = self.frontends[self._rr % n]
            self._rr += 1
            if self.fe_alive[self.frontends.index(fe)]:
                return fe
        return None

    def _arrival(self):
        self.requests += 1
        self._req_seq += 1
        rid = self._req_seq
        fe = self._live_frontend()
        if fe is None:
            self._finish_outcome(False)
            return
        # tick the frontend's REAL request counter (the sim bypasses
        # its HTTP listener): the dumped series doc must show the
        # offered load, and arrivals_from_series must round-trip it
        fe._c_requests.inc()
        self._dispatch(rid, fe, self._pick_prefix(), hops=0,
                       resume_from=0, t_accept=self.clock.now)

    def _dispatch(self, rid: int, fe: FleetFrontend,
                  digests: List[str], *, hops: int, resume_from: int,
                  t_accept: float):
        """Route (REAL router ladder) + admit one stream attempt."""
        meta: Dict[str, Any] = {}
        try:
            view = fe._router.route(digests, allow_probe=hops == 0,
                                    meta=meta)
        except NoReplicaError:
            self.no_replica += 1
            self._finish_outcome(False)
            return
        self.decisions += 1
        v = meta.get("verdict", "?")
        self.verdicts[v] = self.verdicts.get(v, 0) + 1
        proc = view.proc
        probe = v == "probe"
        if not proc.up:
            # routed onto a corpse the staleness bound hasn't caught
            # yet: the proxy fails, the peer is evicted, the failover
            # loop retries — the frontend's own ladder semantics
            view.note_proxy_failure()
            fe._router.evict_unhealthy()
            if probe and view.breaker is not None:
                view.breaker.probe_done(False)
            self._failover(rid, fe, digests, hops, resume_from,
                           t_accept)
            return
        if proc.active >= 2 * proc.slots:
            # overloaded peer sheds (429): terminal, bad for the SLO,
            # no eviction, no budget charge
            if probe and view.breaker is not None:
                view.breaker.probe_done(None)
            self.shed += 1
            self._finish_outcome(False)
            return
        proc.add_digest(digests[0])   # prefill registers the prefix
        proc.active += 1
        latency = proc.latency_s(self.rng, self.clock.now,
                                 self.probe_load_cost) \
            * self._fe_pressure_factor(fe)
        self._inflight[rid] = {
            "fe": fe, "view": view, "proc": proc, "probe": probe,
            "digests": digests, "hops": hops,
            "resume_from": resume_from, "t_start": self.clock.now,
            "t_accept": t_accept, "latency": latency,
            "cancelled": False,
        }
        self.schedule(self.clock.now + latency,
                      lambda: self._complete(rid))

    def _fe_pressure_factor(self, fe: FleetFrontend) -> float:
        """Frontend executor overflow tax on PROXIED STREAMS: probe
        demand past the executor budget starves the same event loop
        that forwards tokens, so every stream through an overloaded
        frontend slows. At or under budget (any jittered schedule)
        the factor is 1.0; a storm-collapsed schedule at N× demand
        inflates fleet-wide latency — the page the storm schedule
        must produce at ANY fleet size."""
        if self.fe_pressure_cost <= 0.0:
            return 1.0
        fi = self.frontends.index(fe)
        b = int(self.clock.now / self.probe_bin_s)
        nb = max(int(1.0 / self.probe_bin_s), 1)
        demand = sum(self._attempts.get((fi, k), 0)
                     for k in range(b - nb, b))
        cap = self.probe_capacity_per_bin * nb
        pressure = demand / max(cap, 1)
        return 1.0 + self.fe_pressure_cost * max(pressure - 1.0, 0.0)

    def _failover(self, rid: int, fe: FleetFrontend,
                  digests: List[str], hops: int, resume_from: int,
                  t_accept: float):
        hops += 1
        if hops > self.failover_budget:
            fe._c_exhausted.inc()
            self.failed += 1
            self._finish_outcome(False)
            return
        fe._c_failovers.inc()
        self._dispatch(rid, fe, digests, hops=hops,
                       resume_from=resume_from, t_accept=t_accept)

    def _complete(self, rid: int):
        req = self._inflight.pop(rid, None)
        if req is None or req["cancelled"]:
            return
        proc, view = req["proc"], req["view"]
        proc.active = max(proc.active - 1, 0)
        if not proc.up:
            # died mid-stream: committed prefix survives with the
            # client; failover resubmits the remainder
            view.note_proxy_failure()
            req["fe"]._router.evict_unhealthy()
            if req["probe"] and view.breaker is not None:
                view.breaker.probe_done(False)
            committed = req["resume_from"] + int(
                (self.tokens_per_request - req["resume_from"])
                * min((self.clock.now - req["t_start"])
                      / max(req["latency"], 1e-9), 1.0))
            self._failover(rid, req["fe"], req["digests"],
                           req["hops"], committed, req["t_accept"])
            return
        proc.completed += 1
        emitted = self.tokens_per_request - req["resume_from"]
        proc.tokens += emitted
        req["fe"]._c_tokens.inc(emitted)
        req["fe"]._h_ttft.observe(
            (req["t_start"] - req["t_accept"]
             + req["latency"] / max(self.tokens_per_request, 1))
            * 1000.0)
        if req["probe"] and view.breaker is not None:
            view.breaker.probe_done(True)
        total_latency = self.clock.now - req["t_accept"]
        self.completed += 1
        self._finish_outcome(total_latency <= self.slo_latency_s)

    def _finish_outcome(self, ok: bool):
        self._outcomes.append((self.clock.now, bool(ok)))

    # ----------------------------------------------------- frontend HA kill
    def kill_frontend(self, idx: int):
        """SIGKILL stand-in for frontend ``idx`` mid-run: the real
        :meth:`FleetFrontend.kill` severs its listener/streams; every
        in-flight request through it loses its uncommitted tail and
        the CLIENT retries against a survivor carrying the committed
        prefix through the resume seam (fully-committed streams are
        synthesized client-side, never retried — the rule,
        one tier up)."""
        fe = self.frontends[idx]
        self.fe_alive[idx] = False
        fe.kill()
        self._event("frontend_kill", frontend=fe.name)
        for rid, req in list(self._inflight.items()):
            if req["fe"] is not fe or req["cancelled"]:
                continue
            req["cancelled"] = True
            del self._inflight[rid]
            req["proc"].active = max(req["proc"].active - 1, 0)
            self.ha["severed_streams"] += 1
            committed = req["resume_from"] + int(
                (self.tokens_per_request - req["resume_from"])
                * min((self.clock.now - req["t_start"])
                      / max(req["latency"], 1e-9), 1.0))
            committed_ids = list(range(committed))
            survivor = self._live_frontend()
            if survivor is None:
                self.ha["corrupted_streams"] += 1
                self._finish_outcome(False)
                continue
            if committed >= self.tokens_per_request:
                # client holds every token: synthesize, don't retry
                self.ha["synthesized_streams"] += 1
                self._check_stream(committed_ids, [])
                self._finish_outcome(True)
                continue
            self.ha["resumed_streams"] += 1
            self._resume_on(survivor, req, committed_ids)

    def _resume_on(self, survivor: FleetFrontend,
                   req: Dict[str, Any], committed_ids: List[int]):
        """Client retry against the survivor: resume_tokens carries
        the committed prefix; the survivor's REAL router places the
        remainder (warm/sticky state it gossiped from the dead
        sibling makes this a hit, not a cold miss)."""
        rid = self._req_seq = self._req_seq + 1
        resume_from = len(committed_ids)
        survivor._c_requests.inc()   # the retry is a new request
        self._dispatch(rid, survivor, req["digests"], hops=0,
                       resume_from=resume_from,
                       t_accept=req["t_accept"])
        live = self._inflight.get(rid)
        if live is None:
            self.ha["corrupted_streams"] += 1
            return
        # the remainder the survivor will emit, validated at once (the
        # sim's streams are deterministic ranges — emission content
        # does not depend on which peer serves it, like greedy decode)
        resumed_ids = list(range(resume_from,
                                 self.tokens_per_request))
        self._check_stream(committed_ids, resumed_ids)

    def _check_stream(self, committed_ids: List[int],
                      resumed_ids: List[int]):
        """The client-observed contract: committed + resumed must be
        exactly the uninterrupted stream — zero lost, zero duplicated
        committed tokens."""
        final = committed_ids + resumed_ids
        want = list(range(self.tokens_per_request)) \
            if resumed_ids else committed_ids
        dup = len(final) - len(set(final))
        lost = len(want) - len(final) if not dup else 0
        if final != want:
            self.ha["corrupted_streams"] += 1
            self.ha["tokens_duplicated"] += max(dup, 0)
            self.ha["tokens_lost"] += max(lost, 0)
        else:
            self.ha["committed_tokens_preserved"] += len(committed_ids)

    # ------------------------------------------------------------ main loop
    def _prime(self):
        # arrivals
        if self._arrivals is not None:
            for t in self._arrivals:
                self.schedule(t, self._arrival)
            self.requests_planned = len(self._arrivals)
        else:
            t = 0.0
            n = 0
            while t < self.duration_s:
                rate = max(self.rate_fn(t), 1e-6)
                t += self.rng.expovariate(rate)
                if t < self.duration_s:
                    self.schedule(t, self._arrival)
                    n += 1
            self.requests_planned = n
        # incidents
        for inc in self.incidents:
            self.schedule(inc.t0, lambda inc=inc: (
                self._event("incident_start", incident=inc.kind,
                            page_expected=inc.page),
                inc.apply(self)))
            self.schedule(inc.t1, lambda inc=inc: (
                self._event("incident_end", incident=inc.kind),
                inc.revert(self)))
        # periodic control loops
        if self.scaler is not None:
            def _scale_tick():
                self.scaler.step(self.clock.now)
                self.schedule(self.clock.now + self.scaler.interval_s,
                              _scale_tick)
            self.schedule(self.scaler.interval_s, _scale_tick)

        def _slo_tick():
            if self._outcomes:
                batch, self._outcomes = self._outcomes, []
                for ev in self.engine.observe_many(
                        "interactive", batch, now=self.clock.now):
                    self._event(f"alert_{ev['kind']}",
                                rule=ev["rule"], slo=ev["slo"],
                                burn_fast=ev["burn_fast"])
            self.schedule(self.clock.now + self.slo_tick_s, _slo_tick)
        self.schedule(self.slo_tick_s, _slo_tick)

        def _sample_tick():
            self.series.sample(self.clock.now)
            self.schedule(self.clock.now + self.sample_interval_s,
                          _sample_tick)
        self.schedule(self.sample_interval_s, _sample_tick)
        # gossip links
        for link in self.links:
            self.schedule(
                probe_phase(link.name, self.gossip_interval_s,
                            seed=self.seed),
                lambda link=link: self._gossip_round(link, 0))
        # frontend kill
        if self.kill_frontend_at is not None:
            self.schedule(float(self.kill_frontend_at),
                          lambda: self.kill_frontend(
                              len(self.frontends) - 1))

    def run(self) -> Dict[str, Any]:
        self.real_objects(check=True)
        self._prime()
        cpu0 = time.process_time()
        drain_until = self.duration_s + 10.0 * self.service_s
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > drain_until:
                break
            self.clock.advance(max(t, self.clock.now))
            fn()
        # flush the outcome tail through the alert engine
        if self._outcomes:
            batch, self._outcomes = self._outcomes, []
            self.engine.observe_many("interactive", batch,
                                     now=self.clock.now)
        self._wall_cpu = time.process_time() - cpu0
        return self.result()

    # -------------------------------------------------------------- results
    def real_objects(self, check: bool = False) -> Dict[str, str]:
        """Identity report (and assertion): the control plane under
        sim IS the production code, not a fork."""
        fe = self.frontends[0]
        view = fe.peers[0] if fe.peers else None
        objs = {
            "frontend": type(fe),
            "router": type(fe._router),
            "burn_engine": type(self.engine),
            "probe_schedule": probe_delay,
        }
        if self.scaler is not None:
            objs["autoscaler"] = type(self.scaler)
        if view is not None and view.breaker is not None:
            objs["breaker"] = type(view.breaker)
        if check:
            assert objs["frontend"] is FleetFrontend
            assert objs["router"] is PrefixAffinityRouter
            assert objs["burn_engine"] is BurnRateEngine
            if "autoscaler" in objs:
                assert objs["autoscaler"] is FleetAutoscaler
            if "breaker" in objs:
                assert objs["breaker"] is CircuitBreaker
            from . import remote as _remote
            assert probe_delay is _remote.probe_delay
        return {k: f"{v.__module__}.{v.__qualname__}"
                if hasattr(v, "__qualname__")
                else f"{v.__module__}.{type(v).__name__}"
                for k, v in objs.items()}

    def score_alerts(self, grace_s: Optional[float] = None
                     ) -> Dict[str, Any]:
        """Precision/recall of page fires against ground-truth
        incident windows (+ slow-window grace: a burn alert may
        legitimately confirm shortly after the incident clears)."""
        if grace_s is None:
            grace_s = max((r.slow_s for r in self.engine.rules),
                          default=60.0)
        fires = [a for a in self.engine.alerts
                 if a["kind"] == "fire" and a["rule"] == "page"]
        windows = [(i.t0, i.t1 + grace_s) for i in self.incidents
                   if i.page]
        matched = [a for a in fires
                   if any(lo <= a["t"] <= hi for lo, hi in windows)]
        detected = [1 for lo, hi in windows
                    if any(lo <= a["t"] <= hi for a in fires)]
        return {
            "page_fires": len(fires),
            "false_pages": len(fires) - len(matched),
            "incidents_paged_expected": len(windows),
            "incidents_detected": sum(detected),
            "precision": len(matched) / len(fires) if fires else 1.0,
            "recall": sum(detected) / len(windows)
            if windows else 1.0,
            "ticket_fires": sum(
                1 for a in self.engine.alerts
                if a["kind"] == "fire" and a["rule"] == "ticket"),
        }

    def result(self) -> Dict[str, Any]:
        wall = self._wall_cpu or 1e-9
        out = {
            "sim": {
                "replicas": len(self.procs),
                "frontends": len(self.frontends),
                "duration_s": self.duration_s,
                "seed": self.seed,
                "probe_interval_s": self.probe_interval_s,
                "probe_capacity_per_bin":
                    self.probe_capacity_per_bin,
                "incidents": [{"kind": i.kind, "t0": i.t0,
                               "t1": i.t1, "page": i.page}
                              for i in self.incidents],
            },
            "real_objects": self.real_objects(),
            "cpu_s": round(wall, 3),
            "decisions_total": self.decisions,
            "decisions_per_sec": round(self.decisions / wall, 1),
            "verdicts": dict(sorted(self.verdicts.items())),
            "requests": self.requests,
            "completed": self.completed,
            "shed": self.shed,
            "no_replica": self.no_replica,
            "probe": {
                "rounds": self.probe_rounds,
                "deferred": self.probe_deferred,
                "timeouts": self.probe_timeouts,
            },
            "alerts": self.score_alerts(),
            "gossip": [ln.snapshot() for ln in self.links],
        }
        if self.scaler is not None:
            # count from the per-INSTANCE event log (the registry
            # counters are process-global and would leak across sims)
            evs = self.scaler.events
            out["scale"] = {
                "ups": sum(1 for e in evs if e["action"] == "up"),
                "downs": sum(1 for e in evs if e["action"] == "down"),
                "freezes": sum(1 for e in evs
                               if e["action"] == "freeze"),
                "frozen": self.scaler.snapshot()["frozen"],
                "events": evs[-32:],
                "replica_seconds": round(
                    self.scaler.replica_seconds, 3),
            }
        if self.kill_frontend_at is not None \
                or len(self.frontends) > 1:
            out["ha"] = dict(self.ha)
        if self.xfer["drained_procs"]:
            out["xfer"] = dict(self.xfer,
                               fleet_spill_spans=len(self.fleet_spill))
        return out

    # --------------------------------------------------------------- dumps
    def dump_series(self, path: str) -> str:
        """The sim's telemetry history as a standard ``series/1`` doc
        (same writer, same validator, same ``fleet_dash`` renderer as
        live runs) with the alert log attached."""
        return self.series.dump(path, alerts=self.engine.alerts)

    def dump_flight(self, path: str) -> str:
        """The sim's incident/alert/kill timeline as a flight-recorder
        doc. Sim events carry simulated ``t``; ``wall`` is synthesized
        as ``dumped_wall - (clock_now - t)`` so ``fleet_dash`` puts an
        injected incident and its alert on one shared wall axis."""
        dumped_wall = time.time()
        now = self.clock.now
        merged = list(self.flight)
        if self.scaler is not None:
            # the scaler keeps its own per-instance event log; merge
            # it in as the same ``fleet_autoscale`` events a live
            # flight recorder carries, so fleet_dash marks them
            fleet = getattr(self.frontends[0], "name", "fleet")
            merged += [{"kind": "fleet_autoscale", "fleet": fleet,
                        **ev} for ev in self.scaler.events]
        merged.sort(key=lambda ev: ev["t"])
        events = [dict(ev, wall=dumped_wall - (now - ev["t"]))
                  for ev in merged]
        doc = {"run_id": f"fleet_sim_seed{self.seed}", "attempt": 0,
               "reason": "sim_end", "dumped_wall": dumped_wall,
               "clock_now": now, "capacity": len(events),
               "total_events": len(events), "events": events}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# ------------------------------------------------------- chaos schedules
def _outage(t0: float, t1: float, frac: float) -> Incident:
    killed: List[SimProcess] = []

    def apply(sim: FleetSim):
        n = max(int(len(sim.procs) * frac), 1)
        for proc in sim.procs[:n]:
            if proc.up:
                proc.up = False
                killed.append(proc)

    def revert(sim: FleetSim):
        for proc in killed:
            proc.up = True
        killed.clear()
    return Incident("correlated_outage", t0, t1, page=True,
                    apply=apply, revert=revert)


def _storm(t0: float, t1: float) -> Incident:
    def apply(sim: FleetSim):
        # arm the REAL fault site probe_delay checks: every armed
        # round's jitter collapses to zero — the synchronized herd
        faults.configure("peer_storm~1.0")

    def revert(sim: FleetSim):
        faults.configure(None)
    return Incident("probe_storm", t0, t1, page=True,
                    apply=apply, revert=revert)


def _partition(t0: float, t1: float) -> Incident:
    def apply(sim: FleetSim):
        faults.configure("gossip_partition~1.0")

    def revert(sim: FleetSim):
        faults.configure(None)
    return Incident("gossip_partition", t0, t1, page=False,
                    apply=apply, revert=revert)


def _brownout(t0: float, t1: float, frac: float,
              mult: float) -> Incident:
    slowed: List[SimProcess] = []

    def apply(sim: FleetSim):
        n = max(int(len(sim.procs) * frac), 1)
        for proc in sim.procs[:n]:
            proc.slow_mult = mult
            slowed.append(proc)

    def revert(sim: FleetSim):
        for proc in slowed:
            proc.slow_mult = 1.0
        slowed.clear()
    return Incident("slow_peer_brownout", t0, t1, page=True,
                    apply=apply, revert=revert)


def _spill_restart(t: float, frac: float, spill: bool) -> Incident:
    """One-shot mass engine rebuild at ``t`` (supervisor rebuild /
    rolling restart across a slice of the fleet): the affected
    processes stay UP but their device-live digests die — with a
    spill arena they move to the spilled tier and stay routable
    (warm restart); without, the fleet re-earns every prefix
    cold."""
    def apply(sim: FleetSim):
        n = max(int(len(sim.procs) * frac), 1)
        for proc in sim.procs[:n]:
            proc.restart(spill=spill)

    def revert(sim: FleetSim):
        pass                      # a restart has no un-restart
    return Incident("spill_restart", t, t + 1e-9, page=False,
                    apply=apply, revert=revert)


def _drain_wave(times: Tuple[float, ...],
                migrate: bool) -> Tuple[Incident, ...]:
    """One scale-down drain per listed time: each retires
    the most-loaded live proc, cutting its in-flight requests over
    (``migrate=True``) or resubmitting them cold. page=False — a
    planned drain must never page."""
    kind = "drain_migrate" if migrate else "drain_reprefill"

    def mk(t: float) -> Incident:
        return Incident(kind, t, t + 1e-9, page=False,
                        apply=lambda sim: sim.drain_one(migrate),
                        revert=lambda sim: None)
    return tuple(mk(t) for t in times)


SCENARIOS = ("clean", "outage", "storm", "partition", "brownout",
             "brownout_spill", "diurnal", "ha", "drain_migrate",
             "drain_reprefill")


def build_scenario(name: str, *, n_replicas: int = 100,
                   n_frontends: int = 1, duration_s: float = 300.0,
                   seed: int = 0, base_rate: float = 20.0,
                   **overrides) -> FleetSim:
    """Seeded chaos schedules over a common fleet shape. ``clean`` is
    the incident-free twin every chaos scenario is scored against —
    identical seed, arrivals and fleet, zero injected incidents, so
    any page it raises is a false page by construction."""
    T = float(duration_s)
    kw: Dict[str, Any] = dict(
        n_replicas=n_replicas, n_frontends=n_frontends,
        duration_s=T, seed=seed, base_rate=base_rate)
    if name == "clean":
        pass
    elif name == "outage":
        # kill down to ~half the capacity the offered load needs —
        # a fixed fraction of a lightly-utilized big fleet leaves
        # survivors with headroom and (correctly) no page
        service = float(overrides.get("service_s", 1.0))
        slots = int(overrides.get("slots", 4))
        survivors = max(int(0.4 * base_rate * service / slots), 1)
        frac = 1.0 - min(survivors / max(n_replicas, 1), 0.5)
        kw["incidents"] = (_outage(0.4 * T, 0.7 * T, frac),)
        # pinned floor: the scale story here is the mass-outage FREEZE
        # (survivors' low load must not read as scale-down pressure),
        # not routine capacity tracking
        kw.update(autoscale=True,
                  scaler_kw=dict(min_replicas=n_replicas,
                                 max_replicas=2 * n_replicas))
    elif name == "storm":
        kw["incidents"] = (_storm(0.4 * T, 0.6 * T),)
    elif name == "partition":
        kw["incidents"] = (_partition(0.4 * T, 0.7 * T),)
    elif name == "brownout":
        # fleet-WIDE slowdown (thermal throttle / noisy neighbor
        # across an AZ): a minority brownout is absorbed by the
        # load-aware ladder — measured, not assumed: at frac 0.3 the
        # router routes around it and the fleet stays in SLO
        kw["incidents"] = (_brownout(0.4 * T, 0.7 * T, 0.9, 8.0),)
    elif name == "brownout_spill":
        # brownout + mid-incident mass engine rebuild: the
        # throttled slice's supervisors rebuild their engines while the
        # fleet is already degraded. spill=True (the default) keeps the
        # rebuilt processes' digests routable through the spilled tier,
        # so warm routing survives the double hit; spill=False is the
        # cold twin the A/B compares against (override via
        # ``spill_restart=False``).
        spill = bool(overrides.pop("spill_restart", True))
        kw["incidents"] = (_brownout(0.4 * T, 0.7 * T, 0.5, 6.0),
                           _spill_restart(0.55 * T, 0.5, spill))
    elif name == "diurnal":
        # start the fleet at trough size so the peak genuinely forces
        # scale-ups (and the falling edge, scale-downs)
        # fresher probes: at peak, 1s-stale load lets the warm/sticky
        # ladder pile bursts onto one replica past its shed cliff —
        # the small diurnal fleet needs the 0.5s cadence to stay clean
        kw.update(rate_amp=0.8, rate_cycles=1.0, autoscale=True,
                  probe_interval_s=0.5,
                  n_replicas=max(n_replicas // 4, 2),
                  scaler_kw=dict(min_replicas=max(n_replicas // 4, 2),
                                 max_replicas=4 * n_replicas,
                                 hold_s=1.0, hold_down_s=8.0,
                                 cooldown_s=4.0))
    elif name == "ha":
        kw.update(n_frontends=max(n_frontends, 2),
                  kill_frontend_at=0.5 * T)
    elif name in ("drain_migrate", "drain_reprefill"):
        # scale-down wave mid-traffic: ~1/3 of the fleet retires one
        # replica at a time, each drain hitting the busiest survivor
        # candidate. drain_migrate cuts live requests over through
        # the fleet spill tier (recompute ~0); drain_reprefill is the
        # control twin — identical seed/arrivals/wave times, requests
        # resubmit cold and the survivors re-prefill prompt+committed.
        # The recompute-amplification bound (>= 10x) is scored across
        # the pair.
        migrate = bool(overrides.pop("migrate",
                                     name == "drain_migrate"))
        waves = max(int(overrides.pop("drain_waves",
                                      max(n_replicas // 3, 1))), 1)
        kw["incidents"] = _drain_wave(
            tuple(T * (0.3 + 0.5 * k / waves) for k in range(waves)),
            migrate)
    else:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"known: {SCENARIOS}")
    kw.update(overrides)
    return FleetSim(**kw)


# --------------------------------------------------------- trace replay
def arrivals_from_series(doc: Dict[str, Any],
                         metric: str = "gateway_requests_total",
                         scale: float = 1.0) -> List[float]:
    """Recover request arrival times from a recorded ``series_*.json``
    doc: walk the cumulative request-counter samples, spread each
    inter-sample delta uniformly across its interval, shift t to 0.
    ``scale`` multiplies the replayed rate."""
    out: List[float] = []
    for full, view in (doc.get("metrics") or {}).items():
        if full.split("{", 1)[0] != metric:
            continue
        samples = view.get("samples") or []
        prev_t = prev_v = None
        for s in samples:
            t, v = float(s[0]), float(s[1])
            if prev_t is not None and v > prev_v and t > prev_t:
                n = int(round((v - prev_v) * scale))
                for k in range(n):
                    out.append(prev_t + (t - prev_t) * (k + 0.5) / n)
            prev_t, prev_v = t, v
    if not out:
        raise ValueError(f"no {metric!r} rate recoverable from "
                         "series doc")
    t0 = min(out)
    return sorted(t - t0 for t in out)


def arrivals_from_reqtrace(doc: Dict[str, Any],
                           scale: float = 1.0) -> List[float]:
    """Arrival offsets from a dumped reqtrace ring (per-entry
    ``wall_accept``), shifted to 0. ``scale`` compresses (>1) or
    stretches (<1) the replayed timeline."""
    walls = [float(e["wall_accept"])
             for e in (doc.get("entries") or [])
             if e.get("wall_accept") is not None]
    if not walls:
        raise ValueError("no wall_accept entries in reqtrace doc")
    t0 = min(walls)
    return sorted((w - t0) / float(scale) for w in walls)


# ------------------------------------------------------------------- CLI
_CLI_DOC = """Fleet-scale chaos simulator CLI: rehearse the 1000-replica
incidents without 1000 processes.

    python -m paddle_tpu_torch.serving.fleet.sim [--check]
        [--scenario NAME ...] [--replicas N] [--frontends N]
        [--replay-series PATH | --replay-reqtrace PATH] [--dump-dir DIR]
        [--out RUNG.json]

Instantiates the REAL control plane (FleetFrontend +
PrefixAffinityRouter + FleetAutoscaler + BurnRateEngine +
CircuitBreaker — ``run()`` asserts their identity) against in-process
SimReplica stubs on a simulated clock, replays seeded chaos schedules
(``--scenario``) or recorded traces, and scores the alerting plane
against the injected ground truth. Prints one ``SIM_JSON {...}`` line
per run (the full ``FleetSim.result()``); ``--out`` also writes the
aggregated rung (decisions/s, alert precision/recall, scale events, HA
stream accounting), and ``--dump-dir`` a ``series/1`` telemetry doc and
a flight-recorder doc per run. ``--check`` runs a small pinned matrix
(the clean twin silent, outage and storm each paging, the planned drain
migrating, the frontend-kill drill losing no committed token) and exits
non-zero on any violation.
"""


def _run_one(name, ns, seed, arrivals=None):
    """One scenario run: fresh fault plan, build, run, optional dumps.
    Returns the full result dict (plus scenario/seed tags)."""
    faults.reset()
    overrides = {}
    for flag, key in (("slots", "slots"), ("service_s", "service_s"),
                      ("tokens", "tokens_per_request"),
                      ("probe_interval_s", "probe_interval_s"),
                      ("gossip_interval_s", "gossip_interval_s")):
        v = getattr(ns, flag)
        if v is not None:
            overrides[key] = v
    if arrivals is not None:
        overrides["arrival_times"] = arrivals
    try:
        sim = build_scenario(name, n_replicas=ns.replicas,
                             n_frontends=ns.frontends,
                             duration_s=ns.duration, seed=seed,
                             base_rate=ns.rate, **overrides)
        res = sim.run()
        res["scenario"], res["seed"] = name, seed
        if ns.dump_dir:
            os.makedirs(ns.dump_dir, exist_ok=True)
            stem = os.path.join(ns.dump_dir, f"sim_{name}_s{seed}")
            res["dumps"] = {
                "series": sim.dump_series(stem + "_series.json"),
                "flight": sim.dump_flight(stem + "_flight.json"),
            }
        return res
    finally:
        faults.reset()


def _aggregate(results):
    """Micro-aggregate alert quality over every run that HAD injected
    incidents (the clean twin contributes its false-page count only)
    — one precision/recall pair for the rung, not a per-scenario
    forest a reader would have to interpret."""
    fires = false = expected = detected = 0
    for r in results:
        a = r["alerts"]
        fires += a["page_fires"]
        false += a["false_pages"]
        expected += a["incidents_paged_expected"]
        detected += a["incidents_detected"]
    return {
        "page_fires": fires, "false_pages": false,
        "incidents_expected": expected, "incidents_detected": detected,
        "alert_precision": (fires - false) / fires if fires else 1.0,
        "alert_recall": detected / expected if expected else 1.0,
    }


def _write_rung(results, ns):
    agg = _aggregate(results)
    section = {
        # headline: routing throughput of the REAL ladder under sim
        # load — max over runs (the biggest fleet dominates)
        "sim_decisions_per_sec": max(r["decisions_per_sec"]
                                     for r in results),
        "sim_replicas": max(r["sim"]["replicas"] for r in results),
        "sim_frontends": max(r["sim"]["frontends"] for r in results),
        "sim_cpu_s": round(sum(r["cpu_s"] for r in results), 3),
        "scenarios": sorted({r["scenario"] for r in results}),
        "seeds": sorted({r["seed"] for r in results}),
        **agg,
        "scale_ups": sum(r.get("scale", {}).get("ups", 0)
                         for r in results),
        "scale_downs": sum(r.get("scale", {}).get("downs", 0)
                           for r in results),
        "scale_freezes": sum(r.get("scale", {}).get("freezes", 0)
                             for r in results),
    }
    ha_runs = [r for r in results if "ha" in r]
    if ha_runs:
        ha = {k: sum(r["ha"][k] for r in ha_runs)
              for k in ha_runs[0]["ha"]}
        section["ha"] = ha
    xfer_runs = [r for r in results if "xfer" in r]
    if xfer_runs:
        section["xfer"] = {k: sum(r["xfer"][k] for r in xfer_runs)
                           for k in xfer_runs[0]["xfer"]}
        mig = sum(r["xfer"]["recompute_tokens"] for r in xfer_runs
                  if r["scenario"] == "drain_migrate")
        ctl = sum(r["xfer"]["recompute_tokens"] for r in xfer_runs
                  if r["scenario"] == "drain_reprefill")
        if ctl:
            # the recompute-amplification bound: prefill
            # tokens the re-prefill control twin burned per token the
            # migrating drain burned (same seed, arrivals, wave times)
            section["xfer"]["recompute_amplification"] = round(
                ctl / max(mig, 1), 2)
    doc = {"started": time.strftime("%Y-%m-%d %H:%M:%S"),
           # the sim runs on the host clock and never touches a card
           "device": "cpu", "argv": sys.argv[1:],
           "fleet_sim": section}
    tmp = ns.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, ns.out)
    return doc


# ------------------------------------------------------------------ check
def check(ns) -> int:
    """Pinned self-test: tiny fleet, fixed seed, four scenarios, hard
    assertions on alert precision/recall and HA stream accounting.
    This is the quick gate for the whole sim stack — it exercises
    probe scheduling, routing, breakers, burn-rate paging, the
    autoscaler freeze and the leaderless frontend failover in ~2s."""
    kw = dict(replicas=16, frontends=1, duration=80.0, rate=8.0,
              slots=None, service_s=None, tokens=None,
              probe_interval_s=None, gossip_interval_s=None,
              dump_dir=None)
    ns2 = argparse.Namespace(**kw)
    bad = []

    def expect(cond, what):
        if not cond:
            bad.append(what)

    r = _run_one("clean", ns2, 1)
    a = r["alerts"]
    expect(a["page_fires"] == 0, f"clean twin paged: {a}")
    expect(r["shed"] == 0, f"clean twin shed {r['shed']}")
    expect(r["completed"] == r["requests"],
           f"clean twin dropped requests: {r['completed']}"
           f"/{r['requests']}")

    r = _run_one("outage", ns2, 1)
    a = r["alerts"]
    expect(a["recall"] >= 1.0 and a["false_pages"] == 0,
           f"outage alert quality: {a}")
    expect(r["scale"]["freezes"] >= 1,
           f"mass outage did not freeze the autoscaler: {r['scale']}")

    r = _run_one("storm", ns2, 1)
    a = r["alerts"]
    expect(a["recall"] >= 1.0 and a["false_pages"] == 0,
           f"storm alert quality: {a}")
    expect(r["probe"]["timeouts"] > 0,
           "storm produced no probe-capacity overflow")

    r = _run_one("brownout_spill", ns2, 1)
    a = r["alerts"]
    expect(a["false_pages"] == 0,
           f"brownout_spill false-paged: {a}")
    expect(r["completed"] + r["shed"] == r["requests"],
           f"brownout_spill dropped requests: {r}")

    rm = _run_one("drain_migrate", ns2, 1)
    rc = _run_one("drain_reprefill", ns2, 1)
    xm, xc = rm["xfer"], rc["xfer"]
    expect(rm["alerts"]["page_fires"] == 0,
           f"planned drain paged: {rm['alerts']}")
    expect(xm["migrated_requests"] >= 1,
           f"drain wave cut no live requests over: {xm}")
    expect(xm["recompute_tokens"] == 0,
           f"migrating drain recomputed prefill: {xm}")
    expect(xc["recompute_tokens"] > 0,
           f"re-prefill control twin recomputed nothing: {xc}")
    expect(rm["requests"] == rc["requests"],
           f"drain twins diverged: {rm['requests']} != "
           f"{rc['requests']}")
    amp = xc["recompute_tokens"] / max(xm["recompute_tokens"], 1)
    expect(amp >= 10.0,
           f"recompute amplification {amp:.1f}x < 10x bound "
           f"(migrate={xm}, control={xc})")
    expect(rm["completed"] + rm["shed"] == rm["requests"],
           f"drain_migrate dropped requests: {rm['completed']}"
           f"/{rm['requests']} shed={rm['shed']}")

    ns2.frontends = 2
    r = _run_one("ha", ns2, 1)
    ha, a = r["ha"], r["alerts"]
    expect(a["false_pages"] == 0, f"ha drill paged: {a}")
    expect(ha["severed_streams"] >= 1,
           f"frontend kill severed no streams: {ha}")
    expect(ha["severed_streams"] == ha["resumed_streams"]
           + ha["synthesized_streams"],
           f"severed streams unaccounted for: {ha}")
    expect(ha["corrupted_streams"] == 0 and ha["tokens_lost"] == 0
           and ha["tokens_duplicated"] == 0,
           f"frontend kill corrupted streams: {ha}")

    if bad:
        for line in bad:
            print(f"FLEET_SIM CHECK FAIL: {line}", file=sys.stderr)
        return 1
    print("fleet_sim check ok: clean twin silent, outage+storm each "
          "paged with freeze, frontend kill lost zero committed "
          "tokens")
    return 0


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=_CLI_DOC.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="pinned self-test matrix; nonzero exit on "
                         "any alert/HA violation")
    ap.add_argument("--scenario", action="append", default=None,
                    choices=SCENARIOS + ("all",),
                    help="repeatable; default: all seeded schedules")
    ap.add_argument("--replicas", type=int, default=100)
    ap.add_argument("--frontends", type=int, default=1,
                    help="HA: >=2 shares routing state via gossip; "
                         "the ha scenario forces 2")
    ap.add_argument("--duration", type=float, default=None,
                    help="simulated seconds (not wall time); default "
                         "300, or the replayed trace's span — chaos "
                         "windows are placed relative to this, so it "
                         "must cover the arrivals")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered load, requests/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="run seeds seed..seed+N-1")
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--service-s", type=float, default=None,
                    dest="service_s")
    ap.add_argument("--tokens", type=int, default=None,
                    help="tokens per request")
    ap.add_argument("--probe-interval-s", type=float, default=None,
                    dest="probe_interval_s")
    ap.add_argument("--gossip-interval-s", type=float, default=None,
                    dest="gossip_interval_s")
    ap.add_argument("--replay-series", default=None, metavar="PATH",
                    help="replay arrivals from a series_*.json doc "
                         "instead of the seeded open loop")
    ap.add_argument("--replay-reqtrace", default=None, metavar="PATH",
                    help="replay arrivals from a dumped reqtrace ring")
    ap.add_argument("--replay-scale", type=float, default=1.0,
                    help="rate multiplier applied to the replayed "
                         "trace")
    ap.add_argument("--replay-metric",
                    default="gateway_requests_total",
                    help="request counter to recover arrivals from "
                         "(a sim-produced series doc uses "
                         "fleet_requests_total)")
    ap.add_argument("--dump-dir", default=None,
                    help="write per-run series + flight docs here")
    ap.add_argument("--out", default="",
                    help="rung JSON path (default: none written)")
    ap.add_argument("--no-rung", action="store_true",
                    help="skip writing the rung file")
    ns = ap.parse_args(argv)

    if ns.check:
        return check(ns)

    arrivals = None
    if ns.replay_series and ns.replay_reqtrace:
        ap.error("--replay-series and --replay-reqtrace are "
                 "exclusive")
    if ns.replay_series:
        with open(ns.replay_series) as f:
            arrivals = arrivals_from_series(json.load(f),
                                            metric=ns.replay_metric,
                                            scale=ns.replay_scale)
    elif ns.replay_reqtrace:
        with open(ns.replay_reqtrace) as f:
            arrivals = arrivals_from_reqtrace(json.load(f),
                                              scale=ns.replay_scale)
    if ns.duration is None:
        # the replayed trace defines the timeline (chaos windows are
        # fractions of it); a hair past the last arrival so every
        # replayed request drains
        ns.duration = arrivals[-1] + 1.0 if arrivals is not None \
            else 300.0

    names = ns.scenario or ["all"]
    if "all" in names:
        names = list(SCENARIOS)
    results = []
    for name in names:
        for seed in range(ns.seed, ns.seed + max(ns.seeds, 1)):
            res = _run_one(name, ns, seed, arrivals=arrivals)
            results.append(res)
            a = res["alerts"]
            print(f"# {name} seed={seed}: "
                  f"decisions/s={res['decisions_per_sec']} "
                  f"completed={res['completed']}/{res['requests']} "
                  f"shed={res['shed']} pages={a['page_fires']} "
                  f"false={a['false_pages']} "
                  f"recall={a['recall']:.2f} cpu={res['cpu_s']}s",
                  file=sys.stderr)
            print("SIM_JSON " + json.dumps(res))
    if ns.out and not ns.no_rung:
        doc = _write_rung(results, ns)
        print(f"# rung -> {ns.out}: "
              + json.dumps({k: doc["fleet_sim"][k] for k in
                            ("sim_decisions_per_sec",
                             "alert_precision", "alert_recall")}),
          file=sys.stderr)
    agg = _aggregate(results)
    return 0 if agg["false_pages"] == 0 \
        and agg["alert_recall"] >= 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
