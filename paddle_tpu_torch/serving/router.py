"""Prefix-cache-aware multi-replica routing (counterpart of
``paddle_tpu/serving/router.py``; reference:
session-affinity LB policies in production LLM serving — SGLang's
cache-aware router, vLLM's prefix-aware scheduling — restated over
PagedEngine's SHA-256 chain digests).

A PagedEngine replica that already holds a prompt's shared-prefix
blocks (system prompt, few-shot preamble) serves it with the prefill
for that span SKIPPED — but only if the request lands on THAT replica.
The router keys affinity off ``PagedEngine.prefix_digest()``: the same
chain digest the engine's prefix cache is keyed by, so "does replica X
have this prefix warm" is one dict lookup (``has_prefix``), not a
heuristic.

Routing order for a request carrying ``digest``:

1. **warm** — healthy replicas whose engine reports the digest live in
   its prefix cache; least-loaded among them wins (a hit).
2. **sticky** — no replica is warm yet, but an earlier request with
   the same digest was routed somewhere and may still be prefilling:
   follow it so the second request arrives after the first registered
   the blocks (a hit — this is what turns a burst of same-prefix
   requests into one miss + N-1 hits instead of N misses).
3. **fallback** — least-loaded healthy replica (a miss; the sticky map
   remembers the choice).

A warm/sticky target that is ``spill_margin`` load units more loaded
than the least-loaded replica is abandoned for the fallback: affinity
is a latency optimization, not a priority override, and a hot prefix
must not melt one replica while others idle.

Health eviction: a replica whose ``healthy()`` is False is skipped and
its sticky entries drop (when it comes back it re-earns affinity by
getting warm again). All replicas unhealthy raises
:class:`NoReplicaError` (the gateway's 503).

Rejoin: eviction is no longer one-way. A replica carrying a
:class:`~.supervisor.CircuitBreaker` re-enters rotation through it —
when the breaker's backoff elapses it goes half-open and the router
diverts exactly ONE request at a time to that replica as a probation
probe (verdict ``probe``; the gateway marks the request so its
terminal path reports ``probe_done``). Enough probe successes close
the breaker, the supervisor flips ``healthy()`` back, and the replica
is back in the warm -> sticky -> least-loaded ladder; a probe failure
re-opens with a longer backoff. The probe check runs FIRST so a
recovering replica gets its probe even while healthy siblings could
absorb the traffic — and the failover path protects the probe request
if the replica is still bad.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ..utils import observability as obs

__all__ = ["NoReplicaError", "EngineReplica", "PrefixAffinityRouter"]


class NoReplicaError(RuntimeError):
    """Every replica is unhealthy/evicted — nothing can take traffic."""


class EngineReplica:
    """Default replica adapter over a local ``PagedEngine``. The
    gateway wraps it to fold its scheduler depth into ``load()`` and to
    flip ``healthy`` on tick-thread failures; remote replicas would
    implement the same three methods over RPC."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self._healthy = True
        # circuit breaker: attached by the gateway's
        # supervisor; None = legacy one-way health eviction. While the
        # breaker is half-open the replica stays healthy()==False and
        # re-enters rotation only via the router's probation probe.
        self.breaker = None

    def healthy(self) -> bool:
        return self._healthy

    def mark(self, healthy: bool):
        self._healthy = bool(healthy)

    def has_prefix(self, digest: str) -> bool:
        return self.engine.has_prefix(digest)

    def load(self) -> float:
        """Outstanding work units: live slots + engine-queued requests.
        Read cross-thread without the engine's tick thread stopping —
        both are O(1) host bookkeeping reads and a slightly stale load
        only costs routing optimality, never correctness."""
        eng = self.engine
        return (sum(s is not None for s in eng.slots) + len(eng.queue))


class PrefixAffinityRouter:
    """Pick a replica per request. ``policy``: ``"prefix"`` (default,
    the full affinity ladder), ``"least_loaded"``, or
    ``"round_robin"`` (the A/B baseline the loadgen compares against).
    """

    POLICIES = ("prefix", "least_loaded", "round_robin")

    def __init__(self, replicas: List[Any], policy: str = "prefix",
                 spill_margin: float = 8.0, sticky_capacity: int = 1024,
                 labels: Optional[Dict[str, str]] = None):
        # an EMPTY initial list is legal (a fleet frontend
        # starts bare and grows through add_replica); routing with no
        # healthy replica raises NoReplicaError as always
        if policy not in self.POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}")
        self.replicas = list(replicas)
        self.policy = policy
        self.spill_margin = float(spill_margin)
        self._sticky: "OrderedDict[str, Any]" = OrderedDict()
        self._sticky_cap = int(sticky_capacity)
        self._rr = 0
        self._tie_rr = 0
        self._lock = threading.Lock()
        labels = labels or {}
        reg = obs.registry()
        self._c_hit = reg.counter("gateway_prefix_route_hits_total",
                                  **labels)
        self._c_miss = reg.counter("gateway_prefix_route_misses_total",
                                   **labels)

    # ------------------------------------------------------------ helpers
    def _healthy(self) -> List[Any]:
        up = [r for r in self.replicas if r.healthy()]
        if not up:
            raise NoReplicaError("all replicas unhealthy")
        return up

    def _least_loaded(self, cands: List[Any]):
        """Minimum load, rotating among ties. ``min()`` alone herds:
        load signals are probe snapshots quantized to whole slots, so
        a large mostly-idle fleet has hundreds of replicas tied at
        0.0 and first-minimum sends EVERY miss of a staleness window
        to the same lowest-index replica — at 1000 replicas the fleet
        sim measured ~6% of a light clean load shed off that one herd
        target. One read per candidate (load() takes the peer lock)."""
        loads = [r.load() for r in cands]
        lo = min(loads)
        tied = [i for i, l in enumerate(loads) if l <= lo]
        if len(tied) == 1:
            return cands[tied[0]]
        pick = cands[tied[self._tie_rr % len(tied)]]
        self._tie_rr += 1
        return pick

    def _remember(self, digest: str, replica):
        self._sticky[digest] = replica
        self._sticky.move_to_end(digest)
        while len(self._sticky) > self._sticky_cap:
            self._sticky.popitem(last=False)

    # -------------------------------------------------------------- route
    def route(self, digests=None, trace=None, allow_probe=True,
              meta=None):
        """Choose a replica for a request whose affinity keys are
        ``digests`` — the prompt's chunk-grid digest CHAIN, longest
        span first (a bare str is accepted as a one-element chain;
        None/empty = no shared prefix: pure load balancing). The whole
        chain is probed because a request whose unique tail crosses a
        chunk boundary shares only its SHORTER spans with its
        siblings — the longest digest alone would miss the warm
        replica.

        ``trace``: a :class:`~.reqtrace.RequestTrace` to
        record the route DECISION on — which replica won and WHY
        (``warm``/``sticky``/``miss``/``least_loaded``/
        ``round_robin``/``probe``), so a slow request's timeline says
        whether it missed its warm replica. ``meta``: an
        optional dict the verdict is written into (``meta["verdict"]``)
        — the gateway's authoritative "was this the probation probe"
        signal (inferring it from ``healthy()`` after the fact races a
        concurrent replica failure and could mislabel a normal request
        as the probe, corrupting the real probe's accounting)."""

        def _ev(verdict, pick):
            if meta is not None:
                meta["verdict"] = verdict
            if trace is not None:
                trace.ev("route", verdict=verdict,
                         replica=getattr(pick, "name", str(pick)),
                         policy=self.policy, spans=len(digests))
            return pick

        if isinstance(digests, str):
            digests = [digests]
        digests = [d for d in (digests or ()) if d]
        with self._lock:
            # circuit-breaker probation: a half-open replica
            # with a free probe slot takes this request as its probe —
            # checked before the ladder so recovery is traffic-driven,
            # and before _healthy() so a fleet that is ALL half-open
            # probes instead of 503ing. ``allow_probe=False`` is the
            # gateway's race-retry: a request whose probe target died
            # re-routes through the plain ladder.
            if allow_probe:
                for r in self.replicas:
                    b = getattr(r, "breaker", None)
                    if b is not None and not r.healthy() \
                            and b.try_probe():
                        if digests:
                            self._c_miss.inc()
                        return _ev("probe", r)
            up = self._healthy()
            if self.policy == "round_robin":
                pick = up[self._rr % len(up)]
                self._rr += 1
                if digests:
                    self._c_miss.inc()
                return _ev("round_robin", pick)
            floor = self._least_loaded(up)
            if self.policy == "least_loaded" or not digests:
                if digests:
                    self._c_miss.inc()
                return _ev("least_loaded", floor)
            cap = floor.load() + self.spill_margin
            for d in digests:            # longest shared span wins
                warm = [r for r in up if r.has_prefix(d)]
                if warm:
                    pick = self._least_loaded(warm)
                    if pick.load() <= cap:
                        self._c_hit.inc()
                        self._remember(digests[0], pick)
                        return _ev("warm", pick)
                    break                # overloaded: spill, don't scan on
            for d in digests:
                sticky = self._sticky.get(d)
                if sticky is not None and sticky in up \
                        and sticky.load() <= cap:
                    self._c_hit.inc()
                    self._sticky.move_to_end(d)
                    return _ev("sticky", sticky)
            self._c_miss.inc()
            for d in digests:            # future siblings of ANY span
                self._remember(d, floor)
            return _ev("miss", floor)

    def add_replica(self, replica):
        """Fleet membership grows at runtime (the autoscaler
        spawning a replica, a rejoining peer). Idempotent."""
        with self._lock:
            if replica not in self.replicas:
                self.replicas.append(replica)

    def remove_replica(self, replica):
        """Drop a replica from rotation (autoscaler drain / permanent
        peer death) and forget its sticky affinity — a future replica
        reusing the name re-earns warmth. Idempotent."""
        with self._lock:
            if replica in self.replicas:
                self.replicas.remove(replica)
            for k in [k for k, r in self._sticky.items()
                      if r is replica]:
                del self._sticky[k]

    def evict_unhealthy(self):
        """Drop sticky entries pointing at replicas that are down, so a
        recovered replica re-earns affinity instead of inheriting stale
        routing decisions."""
        with self._lock:
            dead = {k for k, r in self._sticky.items()
                    if not r.healthy()}
            for k in dead:
                del self._sticky[k]

    # -------------------------------------------- HA sticky-state gossip
    def export_sticky(self) -> Dict[str, str]:
        """Sticky map as ``{digest: replica NAME}`` (frontend
        HA): names, not objects, because the map crosses a process
        boundary to a sibling frontend holding its OWN adapter objects
        for the same peers."""
        with self._lock:
            return {d: getattr(r, "name", str(r))
                    for d, r in self._sticky.items()}

    def merge_sticky(self, entries: Dict[str, str],
                     by_name: Dict[str, Any]) -> int:
        """Adopt a sibling frontend's sticky assignments for digests
        we have NO local opinion on (never overriding our own — local
        routing history is fresher evidence than gossip), resolving
        names through ``by_name``. Unknown names are skipped (the
        sibling may know peers we don't yet). Returns adopted count."""
        n = 0
        with self._lock:
            for d, name in (entries or {}).items():
                if d in self._sticky:
                    continue
                r = by_name.get(name)
                if r is None:
                    continue
                self._remember(d, r)
                n += 1
        return n

    def snapshot(self) -> Dict[str, Any]:
        snap = {
            "policy": self.policy,
            "replicas_up": sum(r.healthy() for r in self.replicas),
            "replicas": len(self.replicas),
            "prefix_route_hits": int(self._c_hit.value),
            "prefix_route_misses": int(self._c_miss.value),
            "sticky_entries": len(self._sticky),
        }
        breakers = {r.name: r.breaker.state for r in self.replicas
                    if getattr(r, "breaker", None) is not None}
        if breakers:
            snap["breakers"] = breakers
        return snap
