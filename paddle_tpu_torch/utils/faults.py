"""Deterministic fault injection + retry/backoff (chaos hardening): the
port's copy of ``paddle_tpu/utils/faults.py``, with the registry listing
only the sites the port wires (training, data loading and checkpoints,
the eager collectives, serving, the fleet, the spill tier, the KV wire).

The optimistic halves of fault tolerance (StepWatchdog, elastic
supervise, orbax auto-resume) only matter if the recovery paths they
feed actually run. This module makes failures *injectable on purpose* —
seeded, occurrence-addressed, and identical run-to-run — so every
recovery path has a tier-1 test that kills/corrupts/overloads and
asserts the run still converges or degrades gracefully.

Two control channels, one registry:

- env var ``PADDLE_TPU_FAULTS`` — read per ``inject()`` call (cheap, and
  it propagates into spawned DataLoader workers / elastic relaunches for
  free);
- context manager ``scoped(spec)`` — scoped arming for in-process tests.

Spec grammar (comma-separated entries)::

    site[@WHEN][xCOUNT][~PROB]

    step_nan                 fire on every occurrence
    step_nan@8               fire only on occurrence 8 (0-based call count)
    ckpt_corrupt@2+          every occurrence >= 2
    worker_crash@1-3         occurrences 1..3 inclusive
    collective_fail x2       at most 2 fires total (spaces optional)
    hang~0.1                 each occurrence fires with p=0.1 from a PRNG
                             seeded by PADDLE_TPU_FAULT_SEED + site name
                             (deterministic across runs)

``inject(site, **ctx)`` answers "should this site's fault fire now?" —
the *call-site* owns what firing means (NaN the params, flip bytes,
``os._exit``, sleep, raise), keeping each fault's blast radius next to
the code it breaks. The wired sites are listed in ``SITES`` and printed
by ``python -m paddle_tpu_torch.utils.faults --list``.

``retry_with_backoff`` is the shared transient-failure helper (jittered
exponential backoff, max-attempts, retryable-exception filter).
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

ENV_VAR = "PADDLE_TPU_FAULTS"
# per-site stderr/flight-event verbosity cap (storm-class
# sites fire thousands of times per armed window)
VERBOSE_FIRES_PER_SITE = 8
SEED_ENV_VAR = "PADDLE_TPU_FAULT_SEED"
HANG_ENV_VAR = "PADDLE_TPU_FAULT_HANG_S"
PREFETCH_STALL_ENV_VAR = "PADDLE_TPU_FAULT_PREFETCH_STALL_S"
DISPATCH_HANG_ENV_VAR = "PADDLE_TPU_FAULT_DISPATCH_HANG_S"
STREAM_STALL_ENV_VAR = "PADDLE_TPU_FAULT_STREAM_STALL_S"
SLOW_REPLICA_ENV_VAR = "PADDLE_TPU_FAULT_SLOW_REPLICA_S"
PEER_SLOW_ENV_VAR = "PADDLE_TPU_FAULT_PEER_SLOW_S"
SPILL_SLOW_ENV_VAR = "PADDLE_TPU_FAULT_SPILL_SLOW_S"
XFER_SLOW_ENV_VAR = "PADDLE_TPU_FAULT_XFER_SLOW_S"

__all__ = [
    "SITES", "inject", "scoped", "configure", "reset", "parse_spec",
    "retry_with_backoff", "BackpressureError", "RequestTimeoutError",
    "hang_seconds", "prefetch_stall_seconds", "dispatch_hang_seconds",
    "stream_stall_seconds", "slow_replica_seconds",
    "peer_slow_seconds", "spill_slow_seconds", "xfer_slow_seconds",
    "main",
]

# ------------------------------------------------------------- inventory
# site name -> (wired location, what firing does there). ONE source of
# truth: the CLI prints this, and tests assert every listed site is
# actually wired.
SITES: Dict[str, Tuple[str, str]] = {
    # --- training and data-loading chaos
    "step_nan": (
        "paddle_tpu_torch/trainer.py:Trainer.train",
        "poison the just-finished step: loss and float params become NaN "
        "(numeric divergence; exercises StepWatchdog nan_patience + the "
        "Trainer's bounded checkpoint-rollback loop)"),
    "ckpt_corrupt": (
        "paddle_tpu_torch/checkpoint/distributed_ckpt.py:"
        "DistributedCheckpoint._write_manifest",
        "flip bytes in a committed checkpoint step's files AFTER its "
        "manifest is written (bit rot; exercises checksum verification "
        "and the previous-complete-step restore fallback)"),
    "worker_crash": (
        "paddle_tpu_torch/io/worker.py:_worker_loop",
        "hard-exit (os._exit) a DataLoader worker process while a batch "
        "is outstanding (OOM-kill stand-in; exercises the pool's "
        "dead-worker detection instead of an eternal queue.get)"),
    "hang": (
        "paddle_tpu_torch/trainer.py:Trainer.train",
        "sleep PADDLE_TPU_FAULT_HANG_S (default 3600) seconds before the "
        "next step (preempted-chip stand-in; exercises the StepWatchdog "
        "hang path: checkpoint + exit for the elastic supervisor)"),
    "preempt": (
        "paddle_tpu_torch/trainer.py:Trainer.train",
        "request graceful shutdown at the next step boundary (SIGTERM "
        "stand-in for a scheduler preemption notice): the Trainer "
        "checkpoints its exact step, drains the async writer, and exits "
        "PREEMPTED_RC — which elastic.supervise restarts without "
        "consuming a max_restarts attempt"),
    "collective_fail": (
        "paddle_tpu_torch/distributed/collective.py:_eager",
        "raise CollectiveError before an eager collective runs (transient "
        "link failure stand-in; exercises retry_with_backoff around the "
        "eager_* collectives)"),
    "prefetch_stall": (
        "paddle_tpu_torch/io/device_prefetch.py:_PrefetchIterator._produce",
        "sleep PADDLE_TPU_FAULT_PREFETCH_STALL_S (default 30) in the "
        "device-prefetch producer thread before its next fetch (slow or "
        "wedged host input pipeline stand-in; the consumer's stall "
        "timeout degrades the trainer to synchronous feeding instead of "
        "deadlocking the step loop)"),
    # --- serving chaos: the replica-level sites the supervisor and
    # failover tests arm, wired into the gateway's replica tick loop
    # and SSE writer
    "tick_crash": (
        "paddle_tpu_torch/serving/gateway.py:_ReplicaWorker.run",
        "raise RuntimeError on the replica's tick thread before the "
        "next engine.step() (software crash stand-in; exercises "
        "_fail_all's failover hand-off: live requests resubmit to a "
        "surviving replica, the supervisor rebuilds the engine and "
        "rejoins it through the circuit breaker)"),
    "dispatch_hang": (
        "paddle_tpu_torch/serving/gateway.py:_ReplicaWorker.run",
        "sleep PADDLE_TPU_FAULT_DISPATCH_HANG_S (default 3600) on the "
        "tick thread with the dispatch-busy marker set (wedged "
        "dispatch stand-in; exercises the supervisor watchdog's "
        "dispatch-to-drain deadline: the replica is abandoned, its "
        "requests fail over, the engine is rebuilt)"),
    "replica_drop": (
        "paddle_tpu_torch/serving/gateway.py:_ReplicaWorker.run",
        "hard-exit the replica's tick thread with NO cleanup (process "
        "kill stand-in; exercises the supervisor's dead-thread "
        "detection + failover — nothing on the dying thread runs)"),
    "stream_stall": (
        "paddle_tpu_torch/serving/gateway.py:Gateway._stream_sse",
        "sleep PADDLE_TPU_FAULT_STREAM_STALL_S (default 5) in the SSE "
        "writer before the next token event (slow client / congested "
        "wire stand-in; one stalled stream must not stall the replica "
        "tick loop or corrupt the stream's token order)"),
    "slow_replica": (
        "paddle_tpu_torch/serving/gateway.py:_ReplicaWorker.run",
        "sleep PADDLE_TPU_FAULT_SLOW_REPLICA_S (default 0.05) per tick "
        "on the replica's tick thread (degraded-host stand-in; the "
        "watchdog must NOT fire below its deadline, and least-loaded "
        "routing shifts traffic off the slow replica)"),
    # --- fleet chaos: remote-replica sites wired into the fleet
    # frontend's proxy path and the peer prober (the remote analogues
    # of tick_crash/slow_replica), and the frontend tier's own failure
    # modes, exercised by the fleet sim's chaos schedules and the load
    # generator's --frontend-kill
    "peer_conn_drop": (
        "paddle_tpu_torch/serving/fleet/frontend.py:"
        "FleetFrontend._proxy_stream",
        "sever the frontend->peer connection of an in-flight proxied "
        "stream (peer gateway process death / network partition "
        "stand-in; exercises the fleet failover path: resubmit "
        "prompt+committed on a surviving peer, greedy streams stay "
        "bitwise the uninterrupted run)"),
    "peer_slow": (
        "paddle_tpu_torch/serving/fleet/remote.py:"
        "RemoteReplica._probe_once",
        "sleep PADDLE_TPU_FAULT_PEER_SLOW_S (default 0.05) in a remote "
        "replica's health/gossip probe (congested peer stand-in; the "
        "staleness bound must evict a peer whose probes stop landing, "
        "never wedge the router)"),
    "frontend_conn_drop": (
        "paddle_tpu_torch/serving/fleet/frontend.py:"
        "FleetFrontend._proxy_stream",
        "sever the CLIENT->frontend leg of an in-flight proxied "
        "stream (frontend process death stand-in; the client holds "
        "only its committed prefix and must resume against a "
        "surviving sibling frontend via resume_tokens — zero lost, "
        "zero duplicated committed tokens)"),
    "gossip_partition": (
        "paddle_tpu_torch/serving/fleet/remote.py:"
        "RemoteReplica._probe_once",
        "partition the GOSSIP channel only: the health leg lands but "
        "digest/metrics fetches are dropped (also severs "
        "frontend<->frontend /gossipz links in serving/fleet/ha.py); "
        "peers stay routable while warm routing degrades toward "
        "least-loaded — a partition must never read as an outage"),
    "peer_storm": (
        "paddle_tpu_torch/serving/fleet/remote.py:probe_delay",
        "collapse the seeded probe-round jitter to zero delay so "
        "every armed peer's next round fires NOW (thundering-herd "
        "stand-in at N frontends x M peers; the fleet sim's "
        "probe-storm schedule arms it and must page, while the "
        "jittered clean twin stays quiet)"),
    # --- KV spill tier chaos: the host-RAM arena's own failure modes,
    # wired inside KVSpillArena so every producer (eviction spill,
    # drain spill) and consumer (warm-miss restore) inherits them
    "spill_corrupt": (
        "paddle_tpu_torch/serving/kvspill.py:KVSpillArena.spill",
        "flip one byte of a span's host payload AFTER its crc32 is "
        "banked (silent host-RAM bit rot stand-in; the take-side "
        "checksum must catch it, drop the record, count "
        "kv_spill_checksum_failures_total, and fall back to re-prefill "
        "with the greedy stream bitwise identical to spill-off)"),
    "spill_slow": (
        "paddle_tpu_torch/serving/kvspill.py:KVSpillArena.take",
        "sleep PADDLE_TPU_FAULT_SPILL_SLOW_S (default 0.05) in the "
        "arena's D2H spill / H2D restore path (host memory-bandwidth "
        "contention stand-in; a slow arena must only delay the one "
        "admission, never wedge the engine tick loop or corrupt "
        "restored spans)"),
    "spill_drop": (
        "paddle_tpu_torch/serving/kvspill.py:KVSpillArena.spill",
        "refuse a span's store outright (arena allocation failure / "
        "capacity-pressure stand-in; the span is counted in "
        "kv_spill_drops_total and its next warm miss re-prefills "
        "normally — a lost spill costs latency, never tokens)"),
    # --- cross-replica KV transfer chaos: corrupt/trunc live in the
    # kvxfer encoder so every sender (the /kvz endpoint, drain
    # migration blobs) inherits them; slow lives in the gateway
    # handler, bounded by the fetch side's xfer_timeout_s
    "xfer_corrupt": (
        "paddle_tpu_torch/serving/kvxfer.py:encode_span",
        "flip one payload byte of a wire record AFTER its header crc32 "
        "is banked (wire bit rot stand-in; the receiver's decode ladder "
        "must catch it, count kv_xfer_checksum_failures_total, and fall "
        "back to re-prefill — a corrupted transfer never emits a "
        "token)"),
    "xfer_trunc": (
        "paddle_tpu_torch/serving/kvxfer.py:encode_span",
        "cut a wire record to half its length (transfer severed "
        "mid-body; the receiver's byte-count rung refuses it, counts "
        "kv_xfer_fallbacks_total, and the stream re-prefills bitwise "
        "identically)"),
    "xfer_slow": (
        "paddle_tpu_torch/serving/gateway.py:Gateway._dispatch_http",
        "sleep PADDLE_TPU_FAULT_XFER_SLOW_S (default 0.05) before "
        "serving a GET /kvz span (congested inter-replica link "
        "stand-in; the fetch side bounds the wait with xfer_timeout_s "
        "and falls back to re-prefill on expiry — a slow transfer "
        "costs latency, never tokens)"),
}


# ------------------------------------------------------------ exceptions
class BackpressureError(RuntimeError):
    """Serving admission queue at capacity: the request was rejected
    immediately rather than queued (the caller should back off/shed)."""


class RequestTimeoutError(TimeoutError):
    """A served request exceeded its per-request deadline and was
    cancelled before (or instead of) completing."""


# ------------------------------------------------------------- fault plan
@dataclass
class _Rule:
    site: str
    lo: int = 0                      # first firing occurrence (inclusive)
    hi: Optional[int] = None         # last firing occurrence (inclusive)
    times: Optional[int] = None      # max total fires
    prob: Optional[float] = None     # per-occurrence probability
    fired: int = 0

    def matches(self, occ: int, rng: random.Random) -> bool:
        if occ < self.lo or (self.hi is not None and occ > self.hi):
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """Parsed spec + per-site occurrence counters. Deterministic: the
    probabilistic stream is seeded by (seed, site), and occurrence
    counters advance once per ``inject()`` call regardless of outcome."""

    def __init__(self, rules: List[_Rule], seed: int = 0, raw: str = ""):
        self.raw = raw
        self.rules: Dict[str, List[_Rule]] = {}
        for r in rules:
            self.rules.setdefault(r.site, []).append(r)
        self._occ: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self._rng: Dict[str, random.Random] = {
            s: random.Random(f"{seed}:{s}") for s in self.rules}
        self._lock = threading.Lock()

    def should_fire(self, site: str) -> Tuple[bool, int, int]:
        """Returns (fired, occurrence index, fire index). The fire
        index drives per-site verbosity capping — high-frequency sites
        (``peer_storm`` fires every armed probe round; the fleet sim
        arms it at thousands of rounds) must not flood stderr or evict
        the flight-recorder window."""
        with self._lock:
            occ = self._occ.get(site, 0)
            self._occ[site] = occ + 1
            for rule in self.rules.get(site, ()):
                if rule.matches(occ, self._rng[site]):
                    n = self._fires.get(site, 0)
                    self._fires[site] = n + 1
                    return True, occ, n
        return False, occ, self._fires.get(site, 0)

    def occurrences(self, site: str) -> int:
        with self._lock:
            return self._occ.get(site, 0)


def parse_spec(spec: str, seed: Optional[int] = None) -> FaultPlan:
    """Parse a spec string (grammar in the module docstring). Unknown
    site names raise: a typo'd chaos experiment that silently never
    fires is worse than no experiment."""
    if seed is None:
        seed = int(os.environ.get(SEED_ENV_VAR, "0"))
    rules = []
    for entry in spec.split(","):
        entry = entry.replace(" ", "")
        if not entry:
            continue
        prob = None
        if "~" in entry:
            entry, p = entry.split("~", 1)
            prob = float(p)
        times = None
        if "x" in entry:
            # the times suffix is "<site>x<N>": split on the LAST "x"
            # and only when an integer follows, so site names that
            # themselves contain an "x" (xfer_corrupt, ...) parse
            head, t = entry.rsplit("x", 1)
            if t.isdigit():
                entry, times = head, int(t)
        lo, hi = 0, None
        if "@" in entry:
            entry, when = entry.split("@", 1)
            if when.endswith("+"):
                lo = int(when[:-1])
            elif "-" in when:
                a, b = when.split("-", 1)
                lo, hi = int(a), int(b)
            else:
                lo = hi = int(when)
        if entry not in SITES:
            raise ValueError(
                f"unknown fault site {entry!r}; known: {sorted(SITES)}")
        rules.append(_Rule(entry, lo=lo, hi=hi, times=times, prob=prob))
    return FaultPlan(rules, seed=seed, raw=spec)


# ------------------------------------------------------------ global state
_env_plan: Optional[FaultPlan] = None   # cache keyed by the raw env value
_configured: Optional[FaultPlan] = None
_scoped_stack: List[FaultPlan] = []
_state_lock = threading.Lock()


def _active_plan() -> Optional[FaultPlan]:
    with _state_lock:
        if _scoped_stack:
            return _scoped_stack[-1]
        if _configured is not None:
            return _configured
        global _env_plan
        raw = os.environ.get(ENV_VAR, "")
        if not raw:
            _env_plan = None
        elif _env_plan is None or _env_plan.raw != raw:
            # re-read on change so monkeypatched env in tests (and the
            # spawned-worker inheritance path) takes effect without an
            # explicit reset; counters restart with the new plan
            _env_plan = parse_spec(raw)
        return _env_plan


def inject(site: str, **ctx) -> bool:
    """Injection-site hook: True iff the armed plan says this occurrence
    of ``site`` should fail. Unarmed (the production default) this is a
    dict lookup + env read — cheap enough for per-step call sites."""
    if site not in SITES:
        raise ValueError(f"unregistered fault site {site!r}")
    plan = _active_plan()
    if plan is None:
        return False
    fired, occ, nth = plan.should_fire(site)
    if fired:
        # verbose for the first few fires per site, then one suppression
        # notice: a storm-class site fires thousands of times per armed
        # window and must not flood stderr or evict the flight window
        # (the counter keeps the full tally either way)
        if nth < VERBOSE_FIRES_PER_SITE:
            info = " ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
            print(f"[faults] firing {site} (occurrence {occ})"
                  + (f" {info}" if info else ""),
                  file=sys.stderr, flush=True)
        elif nth == VERBOSE_FIRES_PER_SITE:
            print(f"[faults] {site} keeps firing; further fires "
                  f"logged only to fault_fires_total",
                  file=sys.stderr, flush=True)
        # observability: the early fires land in the flight recorder
        # (the postmortem window must show WHICH chaos preceded the
        # crash) and every fire in a per-site counter. Imported lazily
        # on the fired path; the unarmed hot path stays a dict lookup
        # + env read.
        try:
            from . import observability as obs
            if nth <= VERBOSE_FIRES_PER_SITE:
                obs.record_event("fault_fire", site=site,
                                 occurrence=occ, **ctx)
            obs.counter("fault_fires_total", site=site).inc()
        except Exception:
            pass      # telemetry must never break the chaos experiment
    return fired


def configure(spec: Optional[str], seed: Optional[int] = None) -> None:
    """Install a process-global plan (None reverts to env-var control)."""
    global _configured
    with _state_lock:
        _configured = parse_spec(spec, seed=seed) if spec else None


class scoped:
    """``with faults.scoped("ckpt_corrupt@1"):`` — arm a plan for the
    dynamic extent of the block, then restore whatever was active."""

    def __init__(self, spec: str, seed: Optional[int] = None):
        self.plan = parse_spec(spec, seed=seed)

    def __enter__(self) -> FaultPlan:
        with _state_lock:
            _scoped_stack.append(self.plan)
        return self.plan

    def __exit__(self, *exc):
        with _state_lock:
            _scoped_stack.remove(self.plan)
        return False


def reset() -> None:
    """Drop all armed plans and counters (tests)."""
    global _configured, _env_plan
    with _state_lock:
        _configured = None
        _env_plan = None
        _scoped_stack.clear()


def hang_seconds() -> float:
    """How long a fired ``hang`` site should sleep."""
    return float(os.environ.get(HANG_ENV_VAR, "3600"))


def prefetch_stall_seconds() -> float:
    """How long a fired ``prefetch_stall`` site wedges the producer."""
    return float(os.environ.get(PREFETCH_STALL_ENV_VAR, "30"))


def dispatch_hang_seconds() -> float:
    """How long a fired ``dispatch_hang`` site wedges the tick thread."""
    return float(os.environ.get(DISPATCH_HANG_ENV_VAR, "3600"))


def stream_stall_seconds() -> float:
    """How long a fired ``stream_stall`` site delays the SSE writer."""
    return float(os.environ.get(STREAM_STALL_ENV_VAR, "5"))


def slow_replica_seconds() -> float:
    """Per-tick delay of a fired ``slow_replica`` site."""
    return float(os.environ.get(SLOW_REPLICA_ENV_VAR, "0.05"))


def peer_slow_seconds() -> float:
    """Per-probe delay of a fired ``peer_slow`` site."""
    return float(os.environ.get(PEER_SLOW_ENV_VAR, "0.05"))


def spill_slow_seconds() -> float:
    """Per-copy delay of a fired ``spill_slow`` site."""
    return float(os.environ.get(SPILL_SLOW_ENV_VAR, "0.05"))


def xfer_slow_seconds() -> float:
    """Per-span delay of a fired ``xfer_slow`` site."""
    return float(os.environ.get(XFER_SLOW_ENV_VAR, "0.05"))


# ---------------------------------------------------------------- retry
def retry_with_backoff(fn: Callable, *, max_attempts: int = 3,
                       base_delay: float = 0.05, factor: float = 2.0,
                       max_delay: float = 30.0, jitter: float = 0.25,
                       retryable=(Exception,),
                       on_retry: Optional[Callable] = None,
                       sleep: Callable[[float], None] = time.sleep,
                       seed: Optional[int] = None):
    """Call ``fn()``; on a ``retryable`` exception, sleep a jittered
    exponential backoff and try again, up to ``max_attempts`` total
    attempts (then re-raise the last exception). Non-retryable
    exceptions propagate immediately.

    delay_k = min(max_delay, base_delay * factor**k) * (1 + jitter*u_k).
    By default u_k is seeded per-process (pid), so a preempted FLEET does
    not retry in lockstep — jitter's whole job is decorrelating the
    herd. Pass an explicit ``seed`` for a reproducible schedule (tests;
    the injection layer's determinism contract).
    ``on_retry(exc, attempt, delay)`` observes each retry.
    """
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    rng = random.Random(os.getpid() if seed is None else seed)
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except retryable as e:
            if attempt == max_attempts:
                raise
            delay = min(max_delay, base_delay * (factor ** (attempt - 1)))
            delay *= 1.0 + jitter * rng.random()
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    """``python -m paddle_tpu_torch.utils.faults --list`` — self-describing
    inventory of the wired injection sites."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("--list", "list"):
        try:
            print(f"fault injection sites (arm via ${ENV_VAR} or "
                  f"paddle_tpu_torch.utils.faults.scoped):")
            for name in sorted(SITES):
                where, what = SITES[name]
                print(f"\n  {name}")
                print(f"      wired: {where}")
                print(f"      fires: {what}")
            print(f"\nspec grammar: site[@WHEN][xCOUNT][~PROB], "
                  f"comma-separated; seed via ${SEED_ENV_VAR}")
        except BrokenPipeError:   # `... --list | head` is fine
            pass
        return 0
    print("usage: python -m paddle_tpu_torch.utils.faults --list",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
