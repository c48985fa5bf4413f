"""Leaderless frontend HA: sibling gossip links (counterpart of
``paddle_tpu/serving/fleet/ha.py``;
reference: the peer-to-peer state exchange of leaderless edge tiers —
envoy xDS-less mesh mode, SWIM-style dissemination — restated
stdlib-only over the fleet's existing probe transport).

The FleetFrontend was the fleet's last single point of failure: N
replica gateways survive SIGKILLs bitwise, but one frontend process
owned all routing state. HA here is LEADERLESS — every frontend is a
full peer:

- Each frontend runs its OWN probers against every replica and
  re-derives health/breaker state locally (authoritative state that
  must never travel: a partitioned sibling's "peer X is dead" verdict
  would blind the whole tier).
- What IS gossiped — over ``GET /gossipz``, the same HTTP surface the
  probers already ride — is the state that is expensive or impossible
  to re-derive quickly: per-peer prefix-digest sets (guarded by the
  PEER's own generation counter, so the fresher view wins regardless
  of which frontend probed last), and sticky routing assignments (a
  sibling adopts only digests it has no local opinion on).
- Failover is client-driven: a client whose frontend dies mid-stream
  retries against any surviving sibling carrying its committed
  ``(token, logprob)`` prefix as ``resume_tokens``/``resume_lps`` —
  the same resume seam peers' own failover uses, one tier
  up. No committed token is ever lost or duplicated; greedy streams
  stay bitwise.

:class:`FrontendLink` is one directed gossip edge: a background
thread polling a sibling's ``/gossipz`` on the seeded jittered
schedule (:func:`~.remote.probe_delay` — the storm-decorrelated
rounds the fleet sim validates) and merging each doc via
``FleetFrontend.apply_gossip``. :func:`link_frontends` wires the full
mesh (N*(N-1) directed links; at the 2-4 frontends a fleet tier runs,
mesh beats epidemic fan-out on simplicity and convergence time).

The ``gossip_partition`` fault site severs links deterministically —
the partitioned tier must keep serving on locally re-derived state,
degrading only warm-routing optimality.
"""
from __future__ import annotations

import http.client
import json
import threading
from typing import Any, Dict, List, Optional

from ...utils import faults
from ...utils import observability as obs
from .remote import probe_delay, probe_phase

__all__ = ["FrontendLink", "link_frontends"]


class FrontendLink:
    """One directed gossip edge: ``frontend`` polls ``sibling``'s
    ``/gossipz`` and merges the doc into its own state.

    ``sibling`` may be given as a live :class:`FleetFrontend` (same
    process — the loadgen/sim topology: the fetch is then a direct
    method call, no socket) or as a ``(host, port)`` address of a
    sibling in another process. Either way the merge path —
    ``gossipz()`` doc in, ``apply_gossip()`` out — is identical, so
    in-process tests exercise the exact protocol the multi-process
    tier runs."""

    def __init__(self, frontend, sibling, *,
                 interval_s: float = 0.5,
                 timeout_s: float = 2.0,
                 jitter_frac: float = 0.2,
                 seed: int = 0):
        self.frontend = frontend
        self.sibling = sibling
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.jitter_frac = float(jitter_frac)
        self.seed = int(seed)
        self.rounds_total = 0
        self.failures_total = 0
        self.partitioned_total = 0
        self.adopted_digest_sets = 0
        self.adopted_sticky = 0
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- naming
    @property
    def name(self) -> str:
        return f"{self.frontend.name}<-{self._sibling_name()}"

    def _sibling_name(self) -> str:
        if isinstance(self.sibling, tuple):
            return f"{self.sibling[0]}:{self.sibling[1]}"
        return getattr(self.sibling, "name", str(self.sibling))

    # ------------------------------------------------------------ one round
    def _fetch(self) -> Dict[str, Any]:
        if not isinstance(self.sibling, tuple):
            return self.sibling.gossipz()
        host, port = self.sibling
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.timeout_s)
        try:
            conn.request("GET", "/gossipz")
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise ConnectionError(f"/gossipz answered {resp.status}")
            return json.loads(payload)
        finally:
            conn.close()

    def exchange(self) -> bool:
        """One synchronous gossip round (what the background thread
        loops and what deterministic tests/the sim call directly).
        Returns success; a partitioned or failed round leaves local
        state untouched — gossip is an accelerant, never a
        dependency."""
        self.rounds_total += 1
        if faults.inject("gossip_partition", link=self.name):
            self.partitioned_total += 1
            return False
        try:
            doc = self._fetch()
        except (OSError, ValueError, ConnectionError,
                http.client.HTTPException):
            self.failures_total += 1
            return False
        merged = self.frontend.apply_gossip(doc)
        self.adopted_digest_sets += merged["digest_sets"]
        self.adopted_sticky += merged["sticky"]
        return True

    # ------------------------------------------------------------- thread
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._halt.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fleet-gossip-{self.name}")
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._halt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _loop(self):
        # the probe scheduler's seeded phase+jitter: N
        # frontends' gossip rounds must not synchronize into the same
        # herd the probe storm sim flags
        if self._halt.wait(probe_phase(self.name, self.interval_s,
                                       seed=self.seed)):
            return
        rnd = 0
        while True:
            try:
                self.exchange()
            except Exception as e:   # the link must outlive any bug
                obs.record_event("fleet_gossip_error", link=self.name,
                                 err=repr(e))
            rnd += 1
            if self._halt.wait(probe_delay(
                    self.name, self.interval_s, rnd,
                    jitter_frac=self.jitter_frac, seed=self.seed)):
                return

    def snapshot(self) -> Dict[str, Any]:
        return {
            "link": self.name,
            "rounds": self.rounds_total,
            "failures": self.failures_total,
            "partitioned": self.partitioned_total,
            "adopted_digest_sets": self.adopted_digest_sets,
            "adopted_sticky": self.adopted_sticky,
        }


def link_frontends(frontends: List[Any], *, interval_s: float = 0.5,
                   jitter_frac: float = 0.2, seed: int = 0,
                   start: bool = True) -> List[FrontendLink]:
    """Wire the full gossip mesh over in-process sibling frontends:
    one directed :class:`FrontendLink` per ordered pair. Returns the
    links (started unless ``start=False`` — the sim drives rounds
    itself on the simulated clock)."""
    links = []
    for fe in frontends:
        for sib in frontends:
            if sib is fe:
                continue
            links.append(FrontendLink(
                fe, sib, interval_s=interval_s,
                jitter_frac=jitter_frac, seed=seed))
    if start:
        for ln in links:
            ln.start()
    return links
