"""Remote replica adapter + prefix-digest gossip (counterpart of
``paddle_tpu/serving/fleet/remote.py``; reference: the control-plane
side of multi-host LLM serving fleets — envoy/k8s-style health
probing + SGLang's cache-aware routing lifted from one process to N —
restated stdlib-only over the gateway's existing HTTP surface).

The router's replica seam is duck-typed on purpose
(``healthy``/``load``/``has_prefix`` — see ``serving/router.py``):
:class:`RemoteReplica` implements those three methods over HTTP probes
of a PEER GATEWAY PROCESS, so the same
:class:`~paddle_tpu_torch.serving.router.PrefixAffinityRouter` ladder
(warm -> sticky -> least-loaded, circuit-breaker probation) that
places requests on local tick threads places them on remote gateways
— without touching routing policy. The fleet frontend
(:mod:`.frontend`) then proxies ``/v1/generate`` streams to the chosen
peer byte-for-byte.

Probing is CACHED with a staleness bound: the router calls
``healthy()``/``load()``/``has_prefix()`` synchronously on the serving
path, so those reads must never block on the network. A background
prober refreshes two snapshots per peer:

- ``GET /healthz`` — draining flag, per-replica slot/queue occupancy
  (the ``load()`` the ladder sorts by) and the autoscaler signal
  quartet (queue depth, free slots, block-pool free fraction, goodput
  fraction — the gateway's autoscaler gauges, read remotely in one
  fetch).
- ``GET /debugz/prefix?if_gen=N`` — the peer's prefix-digest set.
  The monotonic ``generation`` counter makes the
  poll conditional: an unchanged set answers a tiny marker instead of
  re-shipping the digest list, so sub-second gossip stays cheap. The
  gossiped set is what turns the prefix cache into a FLEET asset: the
  router can place a request on ANY warm peer, not just the one an
  earlier request happened to land on.
- ``GET /metricsz?window_s=N`` — the peer's WINDOWED telemetry view:
  counter rates, gauge means, windowed histogram
  quantiles and the SLO burn/alert block, cached per probe round so
  the frontend's federated ``/metricsz`` is an O(peers) cache walk.
  Best-effort: a peer without the endpoint stays healthy — live
  metrics are a lens, not a liveness signal.

A peer whose probes stop landing is evicted two ways: consecutive
probe failures flip the health latch (and open the breaker when one is
attached), and a snapshot older than ``stale_after_s`` fails
``healthy()`` even before the failure count does — a wedged prober or
a silently black-holed peer can never keep serving stale "healthy"
answers to the router. The ``peer_slow`` fault site injects probe
latency to exercise exactly that bound.
"""
from __future__ import annotations

import hashlib
import http.client
import json
import random
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils import faults
from ...utils import observability as obs

__all__ = ["RemoteReplica", "prefix_digest_chain", "probe_phase",
           "probe_delay"]


# -------------------------------------------------- probe round scheduling
# every peer used to probe on the same fixed
# interval, so N frontends x M peers synchronize into one thundering
# herd of /healthz+/debugz+/metricsz rounds (the storm the fleet sim
# flags). The schedule is now seeded per peer: a start PHASE spreads
# round 0 across the interval, and per-round JITTER keeps rounds from
# re-synchronizing over time. Both are pure functions of
# (seed, name, round) — deterministic across runs, shared verbatim by
# the live prober thread AND the simulator's probe events, so what the
# sim measures about storm behavior is the schedule production runs.

def probe_phase(name: str, interval_s: float, seed: int = 0) -> float:
    """Deterministic per-peer start offset in ``[0, interval_s)``."""
    u = random.Random(f"probe-phase:{seed}:{name}").random()
    return float(interval_s) * u


def probe_delay(name: str, interval_s: float, round_idx: int, *,
                jitter_frac: float = 0.2, seed: int = 0) -> float:
    """Wait before probe round ``round_idx``: ``interval * (1 +-
    jitter_frac)``, seeded per (peer, round). The ``peer_storm`` fault
    site collapses the delay to 0 — every armed peer's next round
    fires NOW, re-creating the synchronized herd on purpose (what the
    sim's probe-storm schedule and the storm tests arm)."""
    if faults.inject("peer_storm", replica=name, round=round_idx):
        return 0.0
    if jitter_frac <= 0.0:
        return float(interval_s)
    u = random.Random(f"probe:{seed}:{name}:{round_idx}").random()
    return float(interval_s) * (1.0 + float(jitter_frac)
                                * (2.0 * u - 1.0))


def prefix_digest_chain(input_ids, chunk_tokens: int,
                        max_tokens: Optional[int] = None) -> List[str]:
    """The chunk-grid digest chain of a prompt, shortest span first —
    byte-for-byte the keys ``PagedEngine.prefix_digests`` returns for
    the same ``chunk_prefill_tokens`` (pinned by test). The fleet
    frontend has no engine, so it computes routing keys standalone:
    digest_k = SHA256(digest_{k-1} || int64 tokens of chunk k), for
    every span k*C <= cap (default cap ``len(ids) - 1`` — at least one
    live token must remain to prefill, the engine's own rule)."""
    C = int(chunk_tokens)
    if C <= 0:
        return []
    ids = [int(t) for t in np.asarray(input_ids).reshape(-1)]
    cap = len(ids) - 1 if max_tokens is None \
        else min(int(max_tokens), len(ids))
    digests: List[str] = []
    d = b""
    k = 1
    while k * C <= cap:
        h = hashlib.sha256(d)
        h.update(np.asarray(ids[(k - 1) * C:k * C], np.int64).tobytes())
        d = h.digest()
        digests.append(d.hex())
        k += 1
    return digests


class RemoteReplica:
    """One peer gateway process, adapted to the router's replica seam.

    ``healthy()``/``load()``/``has_prefix()`` read the cached probe
    snapshots only (never the network); :meth:`refresh` runs one
    synchronous probe round (what the background prober loops, and
    what deterministic tests call directly). ``breaker`` is attached
    by the fleet frontend — while present, a peer evicted by probe
    failures rejoins through the router's probation-probe ladder, not
    by its probes merely coming back (a peer that answers /healthz but
    drops every proxied stream must not re-enter rotation for free).
    """

    def __init__(self, name: str, host: str, port: int, *,
                 probe_interval_s: float = 0.2,
                 probe_timeout_s: float = 1.0,
                 stale_after_s: float = 2.0,
                 fail_threshold: int = 2,
                 metrics_window_s: float = 5.0,
                 jitter_frac: float = 0.2,
                 metrics_every_rounds: int = 1,
                 seed: int = 0,
                 clock=time.monotonic):
        self.name = name
        self.host = host
        self.port = int(port)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.stale_after_s = float(stale_after_s)
        self.fail_threshold = max(int(fail_threshold), 1)
        self.metrics_window_s = float(metrics_window_s)
        # seeded probe-schedule decorrelation (phase +
        # per-round jitter) and optional round-batching of the
        # best-effort /metricsz fetch (every k-th round; the health +
        # gossip legs run every round — they are the liveness and
        # routing signal, metrics are a lens)
        self.jitter_frac = float(jitter_frac)
        self.metrics_every_rounds = max(int(metrics_every_rounds), 1)
        self.seed = int(seed)
        self._round = 0
        self._clock = clock
        self.breaker = None           # attached by the fleet frontend
        self._lock = threading.Lock()
        self._healthy = True
        self._fails = 0
        self._snap: Dict[str, Any] = {}
        self._snap_t: Optional[float] = None
        # gossiped digest set: hex digests + the peer's
        # generation counter the conditional fetch keys on
        self._digests: frozenset = frozenset()
        # spilled tier: digests the peer holds only in its
        # host-RAM spill arena — cheaper than device-live (a restore
        # beats a re-prefill, a live hit beats both) but still warm
        # for routing purposes
        self._spilled: frozenset = frozenset()
        self._digest_gen = -1
        self._digest_t: Optional[float] = None
        self.probes_total = 0
        self.probe_failures_total = 0
        self.gossip_fetches_total = 0
        self.gossip_unchanged_total = 0
        # federated live metrics: the peer's windowed
        # /metricsz doc, cached per probe round like the health snap —
        # the frontend's fleet view reads only these caches, never the
        # network
        self._metricsz: Dict[str, Any] = {}
        self._metricsz_t: Optional[float] = None
        self.metricsz_failures_total = 0
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- probing
    def _get_json(self, path: str) -> Dict[str, Any]:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.probe_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise ConnectionError(
                    f"{path} answered {resp.status}")
            return json.loads(payload)
        finally:
            conn.close()

    def fetch_kv(self, digest_hex: str,
                 timeout_s: Optional[float] = None) -> Optional[bytes]:
        """``GET /kvz?digest=`` on this peer: one spill-arena span as
        a kvxfer wire record, on the same bounded transport the probes
        use (peer fetch). Returns the raw blob — the CALLER
        runs the decode ladder against its own geometry — or None on
        any miss/timeout/error; never raises. ``timeout_s`` overrides
        the probe timeout (the fetch side's ``xfer_timeout_s`` bound:
        a slow transfer is a counted re-prefill fallback, not a stall).
        """
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=float(timeout_s) if timeout_s is not None
            else self.probe_timeout_s)
        try:
            conn.request("GET", f"/kvz?digest={digest_hex}")
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                return None
            return payload
        except (OSError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def fetch_profilez(self, duration_s: float,
                       timeout_s: Optional[float] = None
                       ) -> Optional[Dict[str, Any]]:
        """``GET /profilez?duration_s=`` on this peer (federated
        capture): trigger a bounded tick-phase + torch.profiler
        capture on the peer gateway and return its report dict, or
        None on any error — never raises. The default timeout covers
        the capture window plus transport slack (the peer holds the
        response open for ``duration_s`` wall seconds)."""
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=float(timeout_s) if timeout_s is not None
            else float(duration_s) + max(self.probe_timeout_s, 5.0))
        try:
            conn.request("GET", f"/profilez?duration_s={duration_s}")
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                return None
            return json.loads(payload)
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    @staticmethod
    def _fold_health(doc: Dict[str, Any]) -> Dict[str, Any]:
        """Collapse a peer /healthz doc into the numbers the router and
        autoscaler read: load units (live slots + engine queue +
        scheduler queue), free/total slots, mean block-pool free
        fraction, scheduler queue depth, goodput fraction, draining."""
        load = 0.0
        free_slots = total_slots = queue_depth = 0
        block_free = []
        for rep in (doc.get("replicas") or {}).values():
            eng = rep.get("engine") or {}
            sched = rep.get("scheduler") or {}
            active = int(eng.get("active_slots", 0))
            queued = int(eng.get("queued", 0))
            sq = int(sched.get("queued", 0))
            load += active + queued + sq
            total = int(eng.get("max_slots", 0))
            total_slots += total
            free_slots += max(total - active, 0)
            queue_depth += sq
            tb = int(eng.get("total_blocks", 0))
            if tb:
                block_free.append(
                    (int(eng.get("free_blocks", 0))
                     + int(eng.get("cached_free_blocks", 0))) / tb)
        return {
            "draining": bool(doc.get("draining", False)),
            "load": load,
            "free_slots": free_slots,
            "total_slots": total_slots,
            "queue_depth": queue_depth,
            "block_pool_free_frac": round(
                sum(block_free) / len(block_free), 4)
            if block_free else 1.0,
            "goodput_frac": float(doc.get("goodput_frac", 1.0)),
            "completed": int(doc.get("completed", 0)),
            "tokens": int(doc.get("tokens", 0)),
        }

    def _probe_once(self):
        """One probe round: /healthz, then the conditional gossip
        fetch. Raises on any failure (the caller counts)."""
        if faults.inject("peer_slow", replica=self.name):
            time.sleep(faults.peer_slow_seconds())
        snap = self._fold_health(self._get_json("/healthz"))
        now = self._clock()
        with self._lock:
            self._snap = snap
            self._snap_t = now
            self._round += 1
            rnd = self._round
        if faults.inject("gossip_partition", replica=self.name):
            # a partition of the GOSSIP channel only: the
            # peer stays healthy and routable, but its digest set and
            # metrics caches age toward the staleness bound — warm
            # routing degrades to least-loaded, never to an eviction
            return
        # gossip: skip the digest list when the peer's generation
        # still matches what we hold (the cheap poll)
        doc = self._get_json(
            f"/debugz/prefix?if_gen={self._digest_gen}")
        self.gossip_fetches_total += 1
        with self._lock:
            if doc.get("unchanged"):
                self.gossip_unchanged_total += 1
            else:
                self._digests = frozenset(doc.get("digests") or ())
                self._spilled = frozenset(doc.get("spilled") or ())
                self._digest_gen = int(doc.get("generation", -1))
            self._digest_t = self._clock()
        # federated metrics: cache the peer's windowed view
        # on the SAME probe round — no new connections beyond the
        # round's, and the frontend's fleet /metricsz reads the cache.
        # Best-effort: a peer without the endpoint (older build) or
        # with its sampler off must not read as unhealthy — health is
        # /healthz's verdict alone. The fetch is batched to
        # every k-th round (metrics_every_rounds) — at 1000 peers the
        # metrics leg is the expensive one, and a k-round-old window
        # is still a window.
        if (rnd - 1) % self.metrics_every_rounds != 0:
            return
        try:
            mz = self._get_json(
                f"/metricsz?window_s={self.metrics_window_s:g}")
            with self._lock:
                self._metricsz = mz
                self._metricsz_t = self._clock()
        except (OSError, ValueError, ConnectionError,
                http.client.HTTPException):
            self.metricsz_failures_total += 1

    def refresh(self) -> bool:
        """One synchronous probe round; returns success. Updates the
        health latch: ``fail_threshold`` consecutive failures evict
        (opening the breaker when one is attached); a success clears
        the failure count and — breakerless only — re-admits."""
        self.probes_total += 1
        try:
            self._probe_once()
        except (OSError, ValueError, ConnectionError,
                http.client.HTTPException):
            self.probe_failures_total += 1
            with self._lock:
                self._fails += 1
                evict = self._fails >= self.fail_threshold \
                    and self._healthy
                if evict:
                    self._healthy = False
            if evict:
                obs.record_event("fleet_peer_down", peer=self.name,
                                 fails=self._fails)
                if self.breaker is not None:
                    self.breaker.record_failure()
            return False
        with self._lock:
            self._fails = 0
            rejoin = not self._healthy and self.breaker is None
            if rejoin:
                # no breaker: probes coming back IS the rejoin. With a
                # breaker, rejoin goes through the router's probation
                # probe (frontend closes it -> on_state marks healthy).
                self._healthy = True
        if rejoin:
            obs.record_event("fleet_peer_up", peer=self.name)
        return True

    # ---------------------------------------------------- background prober
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._halt.clear()
        self._thread = threading.Thread(
            target=self._probe_loop, daemon=True,
            name=f"fleet-probe-{self.name}")
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._halt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _probe_loop(self):
        # seeded phase + per-round jitter: the same
        # schedule functions the fleet sim replays, so decorrelation
        # behavior measured in-sim is the live thread's behavior
        if self._halt.wait(probe_phase(self.name,
                                       self.probe_interval_s,
                                       seed=self.seed)):
            return
        rnd = 0
        while True:
            try:
                self.refresh()
            except Exception as e:  # the prober must outlive any bug
                obs.record_event("fleet_probe_error", peer=self.name,
                                 err=repr(e))
            rnd += 1
            if self._halt.wait(probe_delay(
                    self.name, self.probe_interval_s, rnd,
                    jitter_frac=self.jitter_frac, seed=self.seed)):
                return

    # ------------------------------------------------------ the router seam
    def _fresh(self) -> bool:
        t = self._snap_t
        return t is not None \
            and self._clock() - t <= self.stale_after_s

    def healthy(self) -> bool:
        """Staleness-bounded: a peer whose last good probe is older
        than ``stale_after_s`` is unhealthy even before the failure
        count evicts it — the router must never trust an answer nobody
        has verified recently."""
        with self._lock:
            return self._healthy and self._fresh() \
                and not self._snap.get("draining", False)

    def mark(self, healthy: bool):
        with self._lock:
            self._healthy = bool(healthy)

    def load(self) -> float:
        with self._lock:
            return float(self._snap.get("load", 0.0))

    def has_prefix(self, digest: str) -> bool:
        """Fleet-wide prefix awareness: True when the peer's GOSSIPED
        digest set holds ``digest`` and the set is fresh. A stale set
        answers False — a wrong warm-verdict only costs one prefill,
        but the bound keeps the error window explicit."""
        with self._lock:
            if self._digest_t is None \
                    or self._clock() - self._digest_t \
                    > self.stale_after_s:
                return False
            # the spilled tier counts as warm: a restore on the peer
            # still skips the span's prefill
            return digest in self._digests or digest in self._spilled

    def set_metrics_window(self, window_s: float):
        """Change the window the NEXT probe rounds fetch (the
        frontend's ``?window_s=N`` pass-through — cached federation
        converges to the new window within one probe interval)."""
        self.metrics_window_s = float(window_s)

    def metricsz(self) -> Dict[str, Any]:
        """The cached windowed-metrics doc, staleness-
        tagged: a peer nobody probed within ``stale_after_s`` reports
        ``stale`` and the frontend excludes it from fleet totals —
        the same freshness bound ``healthy()`` applies."""
        with self._lock:
            age = None if self._metricsz_t is None \
                else self._clock() - self._metricsz_t
            return {
                "peer": self.name,
                "age_s": round(age, 3) if age is not None else None,
                "stale": age is None or age > self.stale_after_s,
                "doc": dict(self._metricsz) if self._metricsz
                else None,
            }

    def note_proxy_failure(self):
        """The frontend observed this peer fail an in-flight proxied
        stream (conn drop / 5xx): evict immediately — stronger
        evidence than a missed health probe."""
        with self._lock:
            self._healthy = False
        if self.breaker is not None:
            self.breaker.record_failure()

    # ------------------------------------------------- frontend HA gossip
    def adopt_digests(self, digests, generation: int,
                      spilled=()) -> bool:
        """Adopt a SIBLING FRONTEND's fresher view of this peer's
        prefix-digest set (HA gossip). Generation-guarded:
        only a strictly newer generation wins — our own probe loop is
        the authority whenever it is at least as current, so gossip can
        only ever move a frontend FORWARD in time, never roll it back.
        Returns True when adopted."""
        gen = int(generation)
        with self._lock:
            if gen <= self._digest_gen:
                return False
            self._digests = frozenset(digests or ())
            self._spilled = frozenset(spilled or ())
            self._digest_gen = gen
            self._digest_t = self._clock()
            return True

    def gossip_view(self) -> Dict[str, Any]:
        """What a sibling frontend may adopt about this peer: the
        gossiped digest set + its generation (authoritative: the PEER's
        own counter, comparable across frontends), plus health and
        breaker state as HINTS (each frontend re-derives those from its
        own probes; hints only pre-warm a cold sibling)."""
        with self._lock:
            out = {
                "digests": sorted(self._digests),
                "spilled": sorted(self._spilled),
                "generation": self._digest_gen,
                "healthy": self._healthy and self._fresh()
                and not self._snap.get("draining", False),
            }
        b = self.breaker
        if b is not None:
            out["breaker"] = b.snapshot().get("state")
        return out

    # ------------------------------------------------------------- exports
    def signals(self) -> Dict[str, Any]:
        """The autoscaler's per-peer signal read (cached, O(1))."""
        with self._lock:
            return {
                "peer": self.name,
                "healthy": self._healthy and self._fresh()
                and not self._snap.get("draining", False),
                "stale": not self._fresh(),
                "load": float(self._snap.get("load", 0.0)),
                "queue_depth": int(self._snap.get("queue_depth", 0)),
                "free_slots": int(self._snap.get("free_slots", 0)),
                "total_slots": int(self._snap.get("total_slots", 0)),
                "block_pool_free_frac": float(
                    self._snap.get("block_pool_free_frac", 1.0)),
                "goodput_frac": float(
                    self._snap.get("goodput_frac", 1.0)),
            }

    def snapshot(self) -> Dict[str, Any]:
        """/debugz view of this peer's adapter state."""
        with self._lock:
            snap = dict(self._snap)
            out = {
                "peer": self.name,
                "url": f"{self.host}:{self.port}",
                "healthy_latch": self._healthy,
                "healthy": self._healthy and self._fresh()
                and not snap.get("draining", False),
                "stale": not self._fresh(),
                "consecutive_probe_failures": self._fails,
                "probes": self.probes_total,
                "probe_failures": self.probe_failures_total,
                "snap": snap,
                "gossip": {
                    "digests": len(self._digests),
                    "spilled": len(self._spilled),
                    "generation": self._digest_gen,
                    "fetches": self.gossip_fetches_total,
                    "unchanged_skips": self.gossip_unchanged_total,
                },
                "metricsz": {
                    "window_s": self.metrics_window_s,
                    "cached": bool(self._metricsz),
                    "age_s": round(self._clock() - self._metricsz_t,
                                   3)
                    if self._metricsz_t is not None else None,
                    "failures": self.metricsz_failures_total,
                },
            }
        b = self.breaker
        if b is not None:
            out["breaker"] = b.snapshot()
        return out
