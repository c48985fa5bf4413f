"""Closed-loop fleet autoscaling (counterpart of
``paddle_tpu/serving/fleet/autoscaler.py``; reference: the
goodput-per-chip cost framing of the TPU-serving comparison paper in
PAPERS.md — replicas cost chip-seconds whether or not they serve, so
the controller's objective is goodput per replica-second, not raw
queue draining).

:class:`FleetAutoscaler` closes the loop the gateway's gauges were
exported for: it reads the signal quartet — ``gateway_queue_depth``,
``engine_free_slots``, ``block_pool_free_frac``,
``gateway_goodput_frac`` — off each peer's cached probe snapshot
(:meth:`~.remote.RemoteReplica.signals`; one ``/healthz`` fetch per
peer per probe interval, no new wire protocol) and drives a replica
COUNT through a manager's ``scale_up()``/``scale_down()``:

- **Scale up** when queue depth per replica, slot saturation, block
  pressure, or a sagging goodput fraction stays over threshold for
  ``hold_s`` — sustained pressure, not a one-poll blip.
- **Scale down** when the fleet is demonstrably idle (no queue, load
  under ``down_load_frac``) for ``hold_down_s``.
- **Hysteresis + cooldown** — the up and down thresholds leave a dead
  band between them, both conditions must HOLD for their window, and
  any action opens a ``cooldown_s`` lockout: a diurnal load trace
  scales up the ramp and back down the far side instead of flapping
  at the crest. Spawns in flight count toward the target (a slow
  cold-start must not trigger a second spawn).
- **Windowed signals** — ``signal_mode="windowed"``
  (default) compares thresholds against each pressure signal's MEAN
  over the last ``signal_window_s`` seconds instead of the latest
  probe sample: one noisy tick can neither open a hold window nor
  reset a legitimately-running one, so a spiky trace produces
  strictly fewer scale events (pinned by test) while steady traffic
  decides identically to ``"instant"``, the A/B reference.

Replica processes come and go under the existing SIGTERM-drain
semantics: the manager's ``scale_down`` SIGTERMs a gateway process,
whose ``run_until_shutdown`` latches draining (503 new work, finish
in-flight, flush, exit) — the autoscaler never drops a live stream.

The controller is deliberately synchronous and clock-injectable:
``step(now)`` makes one decision and is what unit tests drive;
``start()`` wraps it in a daemon thread for real fleets. Accounting
(``replica_seconds``, the goodput-per-replica denominator) rides the
same loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ...utils import observability as obs

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Replica-count controller over a manager.

    ``manager`` duck type: ``replicas()`` -> list of objects with
    ``signals()`` (:class:`~.remote.RemoteReplica` or a test fake),
    ``pending()`` -> spawns in flight, ``scale_up()``,
    ``scale_down()``. The local-process implementation is
    :class:`~.manager.LocalProcessManager`."""

    def __init__(self, manager, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_queue_depth: float = 2.0,
                 up_free_slot_frac: float = 0.125,
                 up_block_free_frac: float = 0.10,
                 goodput_floor: Optional[float] = None,
                 down_load_frac: float = 0.25,
                 hold_s: float = 1.0, hold_down_s: float = 3.0,
                 cooldown_s: float = 5.0,
                 interval_s: float = 0.25,
                 signal_mode: str = "windowed",
                 signal_window_s: float = 2.0,
                 outage_freeze_frac: float = 0.5,
                 migrate_on_scale_down: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        """``signal_mode``: ``"windowed"`` (default) bases
        every pressure comparison on the MEAN of each signal over the
        last ``signal_window_s`` seconds of ``step()`` samples —
        one noisy probe tick can no longer open (or reset) a hold
        window, so a spiky trace scales strictly less than it did on
        instantaneous gauges. ``"instant"`` keeps the single-sample
        decision as the A/B reference (decision parity on steady
        traffic is pinned by test: constant signals make the windowed
        mean equal the instant value). Capacity facts (live/pending
        replica counts, slot totals) always read instant — a scale
        decision must see the fleet it is actually scaling."""
        if signal_mode not in ("windowed", "instant"):
            raise ValueError(f"unknown signal_mode {signal_mode!r}")
        self.signal_mode = signal_mode
        self.signal_window_s = float(signal_window_s)
        self._sig_hist: deque = deque(maxlen=4096)
        self.manager = manager
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.up_queue_depth = float(up_queue_depth)
        self.up_free_slot_frac = float(up_free_slot_frac)
        self.up_block_free_frac = float(up_block_free_frac)
        self.goodput_floor = goodput_floor
        self.down_load_frac = float(down_load_frac)
        self.hold_s = float(hold_s)
        self.hold_down_s = float(hold_down_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        # correlated mass-outage guard: when live peers
        # drop to <= replicas * (1 - frac) the loop FREEZES instead of
        # acting — survivors' low aggregate load during an outage is
        # an artifact of excluded stale signals, and scaling down on
        # it is the classic SRE failure. <= 0 disables the guard.
        self.outage_freeze_frac = float(outage_freeze_frac)
        # planned scale-down is the BEST-case migration trigger
        # the retiring replica is healthy and has the
        # whole drain window to cut live requests over — a manager
        # whose scale_down accepts migrate= gets the flag, others
        # keep their SIGTERM semantics (the gateway's own
        # migrate_on_drain still decides what SIGTERM does)
        self.migrate_on_scale_down = bool(migrate_on_scale_down)
        self._frozen = False
        self._clock = clock
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._last_action: Optional[float] = None
        self._last_t: Optional[float] = None
        self.replica_seconds = 0.0
        self.events: List[Dict[str, Any]] = []
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        labels = {"fleet": getattr(manager, "name", "fleet")}
        reg = obs.registry()
        self._g_replicas = reg.gauge("fleet_autoscale_replicas",
                                     **labels)
        self._c_up = reg.counter("fleet_scale_ups_total", **labels)
        self._c_down = reg.counter("fleet_scale_downs_total", **labels)
        self._c_freeze = reg.counter("fleet_autoscale_freezes_total",
                                     **labels)

    # ------------------------------------------------------------- signals
    def aggregate(self) -> Dict[str, Any]:
        """Fold the per-peer signal quartet into the fleet view the
        decision reads. Only HEALTHY peers contribute load numbers —
        a dead peer's stale queue must not hold replicas up."""
        sigs = [r.signals() for r in self.manager.replicas()]
        live = [s for s in sigs if s.get("healthy")]
        n = len(live)
        qd = sum(s["queue_depth"] for s in live)
        free = sum(s["free_slots"] for s in live)
        total = sum(s["total_slots"] for s in live)
        return {
            "replicas": len(sigs),
            "live": n,
            "stale": sum(1 for s in sigs if s.get("stale")),
            "pending": int(self.manager.pending()),
            "queue_depth": qd,
            "queue_depth_per_replica": qd / max(n, 1),
            "free_slots": free,
            "total_slots": total,
            "free_slot_frac": free / total if total else 1.0,
            "load_frac": 1.0 - (free / total) if total else 0.0,
            "block_pool_free_frac": min(
                (s["block_pool_free_frac"] for s in live),
                default=1.0),
            "goodput_frac": min((s["goodput_frac"] for s in live),
                                default=1.0),
        }

    # the pressure signals the windowed mode smooths; capacity facts
    # (replicas/live/pending/free_slots/total_slots) stay instant
    _WINDOWED_FIELDS = ("queue_depth", "queue_depth_per_replica",
                        "free_slot_frac", "load_frac",
                        "block_pool_free_frac", "goodput_frac")

    def _effective(self, agg: Dict[str, Any],
                   now: float) -> Dict[str, Any]:
        """Fold this tick's aggregate into the signal history and
        return the view the decision reads: the instant aggregate in
        ``instant`` mode, the per-field window MEAN in ``windowed``
        mode (the same trajectory-not-point shift the
        /metricsz plane makes, applied to the control loop)."""
        self._sig_hist.append(
            (now, {k: agg[k] for k in self._WINDOWED_FIELDS}))
        lo = now - self.signal_window_s
        while self._sig_hist and self._sig_hist[0][0] < lo:
            self._sig_hist.popleft()
        if self.signal_mode == "instant":
            return agg
        eff = dict(agg)
        n = len(self._sig_hist)
        for k in self._WINDOWED_FIELDS:
            eff[k] = sum(s[1][k] for s in self._sig_hist) / n
        return eff

    # ------------------------------------------------------------ decision
    def step(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One control decision. Returns the (mode-effective)
        aggregate it saw plus the action taken
        (``"up"``/``"down"``/``None``)."""
        now = self._clock() if now is None else now
        agg = self._effective(self.aggregate(), now)
        # replica-seconds accounting: the goodput-per-replica
        # denominator (chip cost proxy — a pending spawn is already
        # paying its cold start, count it)
        if self._last_t is not None:
            self.replica_seconds += \
                (agg["live"] + agg["pending"]) * max(
                    now - self._last_t, 0.0)
        self._last_t = now
        n_eff = agg["live"] + agg["pending"]
        self._g_replicas.set(n_eff)
        action = None
        # mass-outage freeze: a majority of peers stale at
        # once is an OUTAGE, not low demand — the survivors' aggregate
        # (stale peers excluded) would read as idle and trigger the
        # classic scale-down-during-the-incident. Freeze every action,
        # fire the alert event, and let recovery (or the operator)
        # thaw the loop; hold windows reset so post-thaw decisions
        # start from honest signals.
        frozen = (self.outage_freeze_frac > 0.0
                  and agg["replicas"] >= 2
                  and agg["live"] <= agg["replicas"]
                  * (1.0 - self.outage_freeze_frac))
        if frozen != self._frozen:
            self._frozen = frozen
            ev = {"t": round(now, 3),
                  "action": "freeze" if frozen else "thaw",
                  "replicas_before": n_eff,
                  "replicas": agg["replicas"], "live": agg["live"],
                  "stale": agg.get("stale", 0)}
            self.events.append(ev)
            obs.record_event("fleet_autoscale_freeze", **ev)
            if frozen:
                self._c_freeze.inc()
        if frozen:
            self._up_since = self._down_since = None
            return dict(agg, action=None, frozen=True)
        pressure_up = (
            agg["live"] > 0
            and (agg["queue_depth_per_replica"] > self.up_queue_depth
                 or agg["free_slot_frac"] <= self.up_free_slot_frac
                 or agg["block_pool_free_frac"]
                 <= self.up_block_free_frac
                 or (self.goodput_floor is not None
                     and agg["goodput_frac"] < self.goodput_floor)))
        pressure_down = (
            agg["queue_depth"] == 0
            and agg["load_frac"] <= self.down_load_frac)
        # hold windows: sustained pressure only (hysteresis lives in
        # the dead band between up_* and down_* thresholds, plus the
        # separate hold windows). Explicit None checks: t=0.0 is a
        # legitimate window-open timestamp under an injected clock.
        if pressure_up:
            if self._up_since is None:
                self._up_since = now
        else:
            self._up_since = None
        if pressure_down:
            if self._down_since is None:
                self._down_since = now
        else:
            self._down_since = None
        cooled = self._last_action is None \
            or now - self._last_action >= self.cooldown_s
        if (self._up_since is not None
                and now - self._up_since >= self.hold_s
                and cooled and n_eff < self.max_replicas):
            self.manager.scale_up()
            self._c_up.inc()
            action = "up"
        elif (self._down_since is not None
                and now - self._down_since >= self.hold_down_s
                and cooled and agg["pending"] == 0
                and agg["live"] > self.min_replicas):
            try:
                self.manager.scale_down(
                    migrate=self.migrate_on_scale_down)
            except TypeError:
                # older manager duck type: no migrate kwarg
                self.manager.scale_down()
            self._c_down.inc()
            action = "down"
        if action is not None:
            self._last_action = now
            self._up_since = self._down_since = None
            ev = {"t": round(now, 3), "action": action,
                  "replicas_before": n_eff,
                  "signal_mode": self.signal_mode,
                  "migrate": (self.migrate_on_scale_down
                              if action == "down" else None),
                  "queue_depth_per_replica":
                      round(agg["queue_depth_per_replica"], 2),
                  "free_slot_frac": round(agg["free_slot_frac"], 3),
                  "goodput_frac": round(agg["goodput_frac"], 3)}
            self.events.append(ev)
            obs.record_event("fleet_autoscale", **ev)
        return dict(agg, action=action)

    # ------------------------------------------------------------- thread
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._halt.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-autoscaler")
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._halt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _loop(self):
        while not self._halt.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # control must outlive any bug
                obs.record_event("fleet_autoscale_error", err=repr(e))

    # ------------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, Any]:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "scale_ups": int(self._c_up.value),
            "scale_downs": int(self._c_down.value),
            "freezes": int(self._c_freeze.value),
            "frozen": self._frozen,
            "outage_freeze_frac": self.outage_freeze_frac,
            "replica_seconds": round(self.replica_seconds, 3),
            "cooldown_s": self.cooldown_s,
            "signal_mode": self.signal_mode,
            "signal_window_s": self.signal_window_s,
            "events": list(self.events[-32:]),
            "aggregate": self.aggregate(),
        }
