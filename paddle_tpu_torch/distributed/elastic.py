"""Elastic relaunch supervisor (the port's copy of
``paddle_tpu/distributed/elastic.py``; reference:
paddle.distributed.elastic / fleet elastic launch, the agent that
restarts failed trainers so a preemption costs a resume, not the run).

The recovery contract: (1) trainers checkpoint periodically and on hang
(``Trainer.hang_timeout_s``) or preemption, (2) this supervisor
relaunches the training process, (3) the Trainer's auto-resume restores
the latest COMPLETE checkpoint (``checkpoint.distributed_ckpt`` commits
a step by a rename and checks its manifest, so half-written saves are
invisible). The JAX package's compile-cache hook (``compile_cache_dir``)
is not carried over: the port has no compile cache yet.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Any, Callable, List, Optional, Sequence

from ..utils import observability as obs
from ..utils.faults import retry_with_backoff
from ..utils.shutdown import PREEMPTED_RC

__all__ = ["supervise", "PREEMPTED_RC"]


def _default_topology() -> Optional[Any]:
    """Cheap world-size probe for the relaunch log (the child, not the
    supervisor, owns the card). Prefers a FILE
    (``$PADDLE_TPU_WORLD_SIZE_FILE``) the scheduler/launcher can rewrite
    between relaunches — the supervisor's own env is frozen at launch,
    so a bare env var can only describe the initial topology."""
    path = os.environ.get("PADDLE_TPU_WORLD_SIZE_FILE")
    if path:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None
    return os.environ.get("PADDLE_TPU_WORLD_SIZE")


class _RestartableExit(RuntimeError):
    """Child exited with a relaunch-worthy code (retry_with_backoff's
    retryable filter keys on this)."""

    def __init__(self, rc: int):
        super().__init__(f"restartable child exit rc={rc}")
        self.rc = rc


def supervise(argv: Sequence[str], max_restarts: int = 3,
              backoff_s: float = 1.0,
              restart_codes: Optional[Sequence[int]] = None,
              timeout_s: Optional[float] = None,
              preempt_rc: Optional[int] = PREEMPTED_RC,
              max_preemptions: Optional[int] = None,
              probe_topology: Optional[Callable[[], Any]]
              = _default_topology,
              run_dir: Optional[str] = None) -> int:
    """Run ``argv`` as a subprocess; relaunch on failure with jittered
    exponential backoff (the shared utils.faults.retry_with_backoff —
    ``backoff_s`` seeds the base delay, doubling per consecutive
    failure so a crash-looping job doesn't hammer the scheduler).

    restart_codes: exit codes that trigger a relaunch (None = any
    non-zero, plus death-by-signal). Returns the final exit code (0 on
    eventual success). Each relaunch resumes from the latest complete
    checkpoint via the Trainer's own auto-resume — the supervisor carries
    no training state.

    preempt_rc: the graceful-shutdown exit code (Trainer's
    ``preempt_exit_code``, default utils.shutdown.PREEMPTED_RC). A child
    exiting with it was *preempted, not broken* — it already checkpointed
    its exact step — so it is ALWAYS relaunched and never consumes a
    ``max_restarts`` attempt (``max_preemptions`` bounds a pathological
    preemption storm; None = unlimited, preemption is the steady state
    on spot/preemptible pods). ``probe_topology`` is sampled before each
    launch and changes are logged — the job may come back with a
    different world size, which the Trainer reconciles from its
    topology manifest on resume.

    run_dir: where to land the SUPERVISOR'S OWN telemetry on exit —
    ``flight_supervisor.json`` (child launch/exit events with rcs) and
    ``metrics_supervisor.prom`` (restart/preemption counters). Children
    write their attempt-numbered ``flight_<k>``/``trace_<k>`` files
    themselves; without this the supervisor's view — the only place the
    cross-attempt launch/exit/rc story lives — is write-only and dies
    with the process. Pass the child's ``<output_dir>/runs`` so one dir
    holds both sides. None (default) keeps the old behavior.
    """
    # every (re)launch gets an explicit environment: the shared run id
    # and a per-launch attempt number (the child's observability names
    # its artifacts flight_<attempt>.json / trace_<attempt>.json, so an
    # elastic run's attempts sit side by side in one run dir)
    base_env = dict(os.environ)
    base_env[obs.ENV_RUN_ID] = obs.run_id()
    launches = [0]
    preemptions = [0]
    # PER-CALL recorder/registry, not the process globals: a caller
    # supervising two jobs back-to-back must not report job A's
    # preemption counters and launch events in job B's artifacts
    recorder = obs.FlightRecorder()
    registry = obs.MetricsRegistry()
    c_restarts = registry.counter("elastic_restarts_total")
    c_preempts = registry.counter("elastic_preemptions_total")
    last_topo: List[Any] = [probe_topology() if probe_topology else None]

    def check_topology():
        if probe_topology is None:
            return
        topo = probe_topology()
        if topo != last_topo[0]:
            print(f"[elastic] topology changed between attempts: "
                  f"{last_topo[0]!r} -> {topo!r} (the trainer reconciles "
                  f"sampler shards and grad accumulation on resume)",
                  file=sys.stderr, flush=True)
            last_topo[0] = topo

    def attempt() -> int:
        while True:
            check_topology()
            env = dict(base_env)
            env[obs.ENV_ATTEMPT] = str(launches[0])
            recorder.record("elastic_child_launch", attempt=launches[0],
                            argv0=argv[0])
            launches[0] += 1
            try:
                proc = subprocess.run(list(argv), timeout=timeout_s,
                                      env=env)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                # a child hung before its own watchdog could fire (e.g.
                # stuck in startup): that IS the case this supervisor
                # exists for
                rc = 124
            recorder.record("elastic_child_exit",
                            attempt=launches[0] - 1, rc=rc)
            if rc == 0:
                return 0
            if preempt_rc is not None and rc == preempt_rc:
                preemptions[0] += 1
                c_preempts.inc()
                if max_preemptions is not None and \
                        preemptions[0] > max_preemptions:
                    print(f"[elastic] preemption budget exhausted "
                          f"({max_preemptions}); giving up",
                          file=sys.stderr, flush=True)
                    return rc
                print(f"[elastic] child preempted (rc={rc}, preemption "
                      f"{preemptions[0]}): it checkpointed before "
                      f"exiting; relaunching WITHOUT consuming a "
                      f"restart attempt", file=sys.stderr, flush=True)
                time.sleep(min(backoff_s, 1.0))
                continue
            restartable = (restart_codes is None) or (rc in restart_codes) \
                or rc < 0 or rc == 124  # negative = killed by signal
            if restartable:
                raise _RestartableExit(rc)
            return rc

    def on_retry(exc, attempt_no, delay):
        c_restarts.inc()
        print(f"[elastic] attempt {attempt_no}/{max_restarts + 1}: "
              f"rc={exc.rc}; relaunching in {delay:.1f}s",
              file=sys.stderr, flush=True)

    def flush_supervisor_telemetry():
        if run_dir is None:
            return
        try:
            os.makedirs(run_dir, exist_ok=True)
            recorder.dump(
                os.path.join(run_dir, "flight_supervisor.json"),
                "supervise_exit")
            prom = os.path.join(run_dir, "metrics_supervisor.prom")
            with open(prom + ".tmp", "w") as f:
                f.write(registry.prometheus_text())
            os.replace(prom + ".tmp", prom)
        except OSError:
            pass   # telemetry must never mask the child's exit code

    try:
        return retry_with_backoff(attempt, max_attempts=max_restarts + 1,
                                  base_delay=backoff_s, factor=2.0,
                                  max_delay=max(backoff_s, 60.0),
                                  retryable=(_RestartableExit,),
                                  on_retry=on_retry)
    except _RestartableExit as e:
        return e.rc
    finally:
        flush_supervisor_telemetry()


def main(args: Optional[List[str]] = None) -> int:
    """CLI: ``python -m paddle_tpu_torch.distributed.elastic
    [--max-restarts N] [--run-dir DIR] -- cmd args...``"""
    args = list(sys.argv[1:] if args is None else args)
    max_restarts = 3
    run_dir = None
    while args and args[0] in ("--max-restarts", "--run-dir"):
        if len(args) < 2 or args[1] == "--":
            # flag without a value: fall through to the usage message
            # instead of an IndexError (or eating the -- separator)
            args = []
            break
        if args[0] == "--max-restarts":
            max_restarts = int(args[1])
        else:
            run_dir = args[1]
        args = args[2:]
    if args and args[0] == "--":
        args = args[1:]
    if not args:
        print("usage: python -m paddle_tpu_torch.distributed.elastic "
              "[--max-restarts N] [--run-dir DIR] -- cmd ...",
              file=sys.stderr)
        return 2
    return supervise(args, max_restarts=max_restarts, run_dir=run_dir)


if __name__ == "__main__":
    sys.exit(main())
