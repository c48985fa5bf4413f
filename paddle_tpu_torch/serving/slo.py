"""SLO error budgets & multi-window burn-rate alerting (counterpart of
``paddle_tpu/serving/slo.py``; reference: the multiwindow, multi-burn-
rate alerting recipe of SRE practice — page when the error budget is
burning fast enough to matter AND has been for long enough to be real,
resolve with hysteresis so a flapping signal doesn't page twice).

The gateway already classifies every request terminal outcome (the
reqtrace ring's ``outcome`` + TTFT attribution); what it
could not say is whether the CURRENT error rate is sustainable.
:class:`BurnRateEngine` closes that gap:

- **Error budget** — each SLO class has a success target (e.g.
  interactive 0.99); the budget is ``1 - target``. An observation is
  *bad* when the request failed its class's promise (the gateway
  feeds ``outcome != stop``, and for interactive also a TTFT over the
  SLO threshold — the same rule its goodput gauge uses).
- **Burn rate** — over a window W, ``(bad/n) / budget``: 1.0 means
  "burning exactly the budget", 10 means "the whole budget gone in a
  tenth of the period". No traffic burns nothing.
- **Multi-window rules** — each :class:`BurnRule` pairs a FAST window
  (is it burning *now*?) with a SLOW window (has it been burning long
  enough to be real?) and fires only when BOTH exceed the threshold —
  the classic page/ticket pair, scaled to serving-fleet seconds.
  ``window_scale`` multiplies every window so the same rule table
  runs production-shaped (minutes) or CI-shaped (sub-second,
  ``serve_loadgen --slo-windows``).
- **Hysteresis** — an active alert resolves only when the FAST burn
  falls under ``threshold * resolve_frac`` (default half): between
  the fire and resolve lines the alert holds steady.

Every fire/resolve emits a typed ``alert_fire`` / ``alert_resolve``
event into the flight recorder (the postmortem sees the SLO incident
beside the replica failures that caused it), sets the
``slo_burn_rate{class=,window=}`` gauges, and appends to a bounded
alert log the loadgen rungs bank. Deliberately clock-injectable and
evaluated both on ``observe()`` (prompt fires) and from the metrics
sampler's hook (alerts resolve on wall time even when traffic stops).
"""
from __future__ import annotations

import threading
import time
from collections import deque, namedtuple
from typing import Any, Dict, List, Optional, Tuple

from ..utils import observability as obs

__all__ = ["BurnRule", "BurnRateEngine", "DEFAULT_TARGETS",
           "DEFAULT_RULES"]

BurnRule = namedtuple("BurnRule", ("name", "fast_s", "slow_s",
                                   "threshold"))

# success-fraction targets per SLO class (budget = 1 - target);
# unknown classes auto-register at DEFAULT_TARGET
DEFAULT_TARGETS = {"interactive": 0.99, "batch": 0.95}
DEFAULT_TARGET = 0.99

# the fast/slow pairs, serving-fleet scaled (seconds, not the SRE
# book's hours — window_scale stretches them back out for production):
#   page:   10% of the budget gone in the last minute, confirmed over
#           5 minutes
#   ticket: a slow steady leak over 5/30 minutes
DEFAULT_RULES = (BurnRule("page", 60.0, 300.0, 10.0),
                 BurnRule("ticket", 300.0, 1800.0, 2.0))


class BurnRateEngine:
    """Per-SLO-class error budgets + multi-window burn-rate alerts.

    ``observe(slo, ok)`` feeds one terminal request outcome (the
    gateway wires this to the reqtrace ring's idempotent finish, so a
    disconnect racing a tick finish can never double-count);
    ``evaluate()`` walks the rule table and fires/resolves. Both are
    thread-safe; ``clock`` is injectable for deterministic tests."""

    def __init__(self, targets: Optional[Dict[str, float]] = None,
                 rules=None, *, window_scale: float = 1.0,
                 resolve_frac: float = 0.5,
                 min_window_events: int = 0,
                 max_events: int = 8192, max_alerts: int = 512,
                 labels: Optional[Dict[str, str]] = None,
                 clock=time.monotonic):
        """``min_window_events``: a rule may only FIRE when
        its slow window holds at least this many outcomes — a burn
        ratio over single-digit samples is noise, and the fleet sim's
        cold-start showed exactly that false page (3 sheds in an
        almost-empty bootstrap window pages at burn 18). 0 (the
        default) keeps the historical fire-on-any-traffic behavior;
        resolves are never gated, so an active alert can always
        clear."""
        self.targets = dict(DEFAULT_TARGETS)
        self.targets.update(targets or {})
        self.window_scale = float(window_scale)
        self.rules: Tuple[BurnRule, ...] = tuple(
            BurnRule(r[0], float(r[1]) * self.window_scale,
                     float(r[2]) * self.window_scale, float(r[3]))
            for r in (rules if rules is not None else DEFAULT_RULES))
        if not self.rules:
            raise ValueError("at least one burn rule required")
        self.resolve_frac = float(resolve_frac)
        self.min_window_events = max(int(min_window_events), 0)
        self.max_events = int(max_events)
        self.max_alerts = int(max_alerts)
        self.labels = {k: str(v) for k, v in (labels or {}).items()}
        self._clock = clock
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {}      # class -> (t, bad)
        self._active: Dict[Tuple[str, str], dict] = {}
        self.alerts: List[dict] = []             # bounded fire/resolve log
        self.fires_total = 0
        self.peak_burn: Dict[str, float] = {}    # class -> max fast burn
        self._horizon = max(r.slow_s for r in self.rules)
        # every distinct rule window, ascending — the one-pass
        # evaluation grid (containment in a window implies containment
        # in every larger one)
        self._windows: Tuple[float, ...] = tuple(sorted(
            {w for r in self.rules for w in (r.fast_s, r.slow_s)}))
        self._gauges: Dict[Tuple[str, str], Any] = {}
        self._c_fires: Dict[str, Any] = {}

    # ------------------------------------------------------------- intake
    def observe(self, slo: str, ok: bool,
                now: Optional[float] = None) -> List[dict]:
        """One terminal request outcome; returns any alert transitions
        this observation triggered."""
        now = self._clock() if now is None else float(now)
        slo = str(slo)
        with self._lock:
            dq = self._events.get(slo)
            if dq is None:
                dq = self._events[slo] = deque(maxlen=self.max_events)
                self.targets.setdefault(slo, DEFAULT_TARGET)
            dq.append((now, not ok))
            while dq and dq[0][0] < now - self._horizon:
                dq.popleft()
        return self.evaluate(now)

    def observe_many(self, slo: str, outcomes,
                     now: Optional[float] = None) -> List[dict]:
        """Batched intake (the fleet sim replays thousands
        of trace outcomes per simulated tick): one lock acquisition
        and ONE evaluation for the whole batch. ``outcomes`` is an
        iterable of ``(t, ok)`` pairs, ascending in ``t``; ``now``
        defaults to the last outcome's time. Decision-equivalent to
        per-outcome :meth:`observe` calls evaluated at the batch end —
        only intermediate evaluations (which the sim's tick cadence
        would skip anyway) are elided."""
        slo = str(slo)
        last = None
        with self._lock:
            dq = self._events.get(slo)
            if dq is None:
                dq = self._events[slo] = deque(maxlen=self.max_events)
                self.targets.setdefault(slo, DEFAULT_TARGET)
            for t, ok in outcomes:
                last = float(t)
                dq.append((last, not ok))
            if last is not None:
                while dq and dq[0][0] < last - self._horizon:
                    dq.popleft()
        if now is None:
            now = self._clock() if last is None else last
        return self.evaluate(float(now))

    # ----------------------------------------------------------- the math
    def burn_rate(self, slo: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """``(bad/n) / budget`` over the last ``window_s`` seconds
        (0.0 with no traffic in the window)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            dq = self._events.get(slo, ())
            lo = now - float(window_s)
            n = bad = 0
            for t, b in dq:
                if t >= lo:
                    n += 1
                    bad += b
        if n == 0:
            return 0.0
        budget = max(1.0 - self.targets.get(slo, DEFAULT_TARGET),
                     1e-9)
        return (bad / n) / budget

    def _class_burns(self, slo: str, now: float
                     ) -> Tuple[Dict[float, float], Dict[float, int]]:
        """Every rule window's (burn, event count) for one class in
        ONE pass — ONE lock acquisition and one event walk, where
        per-window ``burn_rate()`` calls would re-lock and re-scan
        2×rules times. ``evaluate()`` runs on every request finish, so
        this is the hot shape. Same per-event comparison as
        :meth:`burn_rate` (``t >= now - w``), so results are
        bit-identical: each event charges its SMALLEST containing
        window, then a running suffix sum folds it into every larger
        one."""
        windows = self._windows
        with self._lock:
            events = list(self._events.get(slo, ()))
        budget = max(1.0 - self.targets.get(slo, DEFAULT_TARGET),
                     1e-9)
        k = len(windows)
        first_n = [0] * k
        first_bad = [0] * k
        for t, b in events:
            for i in range(k):
                if t >= now - windows[i]:
                    first_n[i] += 1
                    first_bad[i] += b
                    break
        out: Dict[float, float] = {}
        counts: Dict[float, int] = {}
        cn = cb = 0
        for i, w in enumerate(windows):
            cn += first_n[i]
            cb += first_bad[i]
            out[w] = (cb / cn) / budget if cn else 0.0
            counts[w] = cn
        return out, counts

    def _gauge(self, slo: str, window_s: float):
        key = (slo, f"{window_s:g}s")
        g = self._gauges.get(key)
        if g is None:
            g = obs.registry().gauge("slo_burn_rate",
                                     **{"class": slo,
                                        "window": key[1],
                                        **self.labels})
            self._gauges[key] = g
        return g

    # ----------------------------------------------------------- decision
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Walk every (class, rule) pair: fire when BOTH windows burn
        over the threshold, resolve when the fast window falls under
        ``threshold * resolve_frac``. Returns the transitions."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            classes = sorted(set(self._events) | set(self.targets))
        out: List[dict] = []
        for slo in classes:
            budget = max(1.0 - self.targets.get(slo, DEFAULT_TARGET),
                         1e-9)
            burns, counts = self._class_burns(slo, now)
            for w, b in burns.items():
                self._gauge(slo, w).set(b)
            for rule in self.rules:
                bf = burns[rule.fast_s]
                bs = burns[rule.slow_s]
                key = (slo, rule.name)
                with self._lock:
                    if bf > self.peak_burn.get(slo, 0.0):
                        self.peak_burn[slo] = bf
                    active = key in self._active
                ev = None
                if not active and bf >= rule.threshold \
                        and bs >= rule.threshold \
                        and counts[rule.slow_s] \
                        >= self.min_window_events:
                    ev = self._transition(
                        "fire", slo, rule, bf, bs, budget, now)
                elif active and bf <= rule.threshold \
                        * self.resolve_frac:
                    ev = self._transition(
                        "resolve", slo, rule, bf, bs, budget, now)
                if ev is not None:
                    out.append(ev)
        return out

    def _transition(self, kind: str, slo: str, rule: BurnRule,
                    bf: float, bs: float, budget: float,
                    now: float) -> Optional[dict]:
        """Commit one fire/resolve. The state check re-runs UNDER the
        lock (the caller's pre-check was a separate acquisition):
        concurrent evaluators — a request-finish observe() racing the
        sampler-hook heartbeat — must produce exactly one transition,
        never a double fire or an unpaired resolve. Returns None when
        another thread already committed it."""
        ev = {"kind": kind, "slo": slo, "rule": rule.name,
              "t": round(now, 3), "wall": time.time(),
              "fast_s": rule.fast_s, "slow_s": rule.slow_s,
              "threshold": rule.threshold,
              "burn_fast": round(bf, 3), "burn_slow": round(bs, 3),
              "budget": round(budget, 6)}
        with self._lock:
            if kind == "fire":
                if (slo, rule.name) in self._active:
                    return None
                self._active[(slo, rule.name)] = ev
                self.fires_total += 1
            else:
                fired = self._active.pop((slo, rule.name), None)
                if fired is None:
                    return None
                ev["fired_t"] = fired["t"]
            self.alerts.append(ev)
            if len(self.alerts) > self.max_alerts:
                del self.alerts[:len(self.alerts) - self.max_alerts]
        # the flight recorder sees the SLO incident beside the replica
        # failures that caused it
        obs.record_event(f"alert_{kind}", slo=slo, rule=rule.name,
                         burn_fast=round(bf, 3),
                         burn_slow=round(bs, 3),
                         threshold=rule.threshold, **self.labels)
        c = self._c_fires.get(slo)
        if c is None:
            c = self._c_fires[slo] = obs.registry().counter(
                "slo_alert_transitions_total",
                **{"class": slo, **self.labels})
        c.inc()
        return ev

    # ------------------------------------------------------------ exports
    def active(self) -> List[dict]:
        with self._lock:
            return list(self._active.values())

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/metricsz`` / ``/debugz`` SLO block: current burn per
        (class, window), active alerts, the recent alert log, and the
        run's peak burn per class."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            classes = sorted(set(self._events) | set(self.targets))
            peak = {k: round(v, 3) for k, v in self.peak_burn.items()}
        return {
            "targets": dict(self.targets),
            "window_scale": self.window_scale,
            "rules": [r._asdict() for r in self.rules],
            "burn": {slo: {f"{w:g}s": round(b, 3)
                           for w, b in self._class_burns(
                               slo, now)[0].items()}
                     for slo in classes},
            "active": self.active(),
            "fires_total": self.fires_total,
            "peak_burn": peak,
            "alerts": list(self.alerts[-16:]),
        }
