"""Multi-process launch (counterpart of ``paddle_tpu/distributed/launch.py``;
reference: python/paddle/distributed/launch, which starts one worker per
device and wires them together).

On a TPU pod slice one host process drives every local chip, so the JAX
package's launcher only initialises the JAX distributed runtime and runs
the script in-process. Here each rank is a process of its own with one
device, as Paddle's own launcher does it:

    python -m paddle_tpu_torch.distributed.launch --nproc N [--cpu]
        [--timeout S] [--grace S] (script.py | -m module) [args...]

starts N copies of the script (or of ``python -m module``) with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set (rank r drives card r; with ``--cpu`` the ranks run
on the CPU over gloo). The rendezvous store is the launcher's own: it
binds a ``TCPStore`` server to a port the OS picks before it starts a
rank, holds it for the job, and the ranks join it as clients
(``TORCHELASTIC_USE_AGENT_STORE``, as under torchrun). No port is
chosen free and handed on, so another job starting beside this one
cannot take it before rank 0 binds. The job ends with the exit code of
the first rank to exit non-zero (a thread a rank records the order):
the others are stopped (SIGTERM, then SIGKILL after ``--grace``
seconds), so a dead rank never hangs the job. A SIGTERM to
the launcher reaches every rank, and the job then ends with the ranks'
own codes (0 when each exits 0 within the grace period, as a draining
server's ranks do). ``--nproc`` defaults to the number of cards.

In the script, :func:`init_distributed` (called by
``env.init_parallel_env`` and ``fleet.init`` when no process group is up)
reads that environment, or the JAX package's names for it, and
initialises the process group with an explicit timeout.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

import torch

# stop the other ranks this long after SIGTERM before SIGKILL
GRACE_S = 10.0


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     timeout_s: Optional[float] = None) -> dict:
    """Initialise the default process group from the environment.

    Resolution order, as the JAX package's: explicit arguments >
    PADDLE_TPU_* > Paddle's PADDLE_* > torch's MASTER_ADDR / WORLD_SIZE /
    RANK (``coordinator_address`` is "host:port", or a host with
    ``MASTER_PORT``). NCCL for a card, gloo for the CPU (``device``, as
    :func:`..env.init_parallel_env` resolves it). Without a complete
    setting this is a world of one and nothing is initialised. Returns
    {process_index, process_count, local_devices, global_devices}."""
    import torch.distributed as dist
    from .env import DEFAULT_TIMEOUT_S, _resolve_device
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    coord = coordinator_address or _env(
        "PADDLE_TPU_COORDINATOR", "COORDINATOR_ADDRESS", "PADDLE_MASTER",
        "MASTER_ADDR")
    nproc = num_processes if num_processes is not None else _env(
        "PADDLE_TPU_NUM_PROCESSES", "PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env(
        "PADDLE_TPU_PROCESS_ID", "PADDLE_TRAINER_ID", "RANK")
    explicit = coord is not None and nproc is not None and pid is not None
    if explicit and not dist.is_initialized():
        dev = device if isinstance(device, torch.device) \
            else _resolve_device(device)
        if ":" not in coord:
            coord = f"{coord}:{_env('MASTER_PORT', default='29500')}"
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coord}", world_size=int(nproc),
            rank=int(pid), timeout=datetime.timedelta(seconds=timeout_s),
            **kw)
    up = dist.is_initialized()
    info = {"process_index": dist.get_rank() if up else 0,
            "process_count": dist.get_world_size() if up else 1,
            "local_devices": 1,
            "global_devices": dist.get_world_size() if up else 1}
    os.environ.setdefault("PADDLE_TRAINER_ID", str(info["process_index"]))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(info["process_count"]))
    return info


def rendezvous_store(timeout_s: float = 1800.0):
    """The job's rendezvous: a ``TCPStore`` server on 127.0.0.1 at a port
    the OS picks, bound before any rank starts. Read its ``port``; keep
    it until the ranks have exited."""
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


# the ranks join the launcher's store as clients (torch's rendezvous
# reads these, as it does under torchrun)
AGENT_STORE_ENV = {"TORCHELASTIC_USE_AGENT_STORE": "True",
                   "TORCHELASTIC_RESTART_COUNT": "0"}


def _exit_order(procs: List[subprocess.Popen]) -> list:
    """A list that gets (monotonic time, exit code) of each process as it
    exits, from one waiting thread a process: when a rank dies and a
    peer fails on the broken connection a moment later, both may have
    exited by the next poll, and the job's code must be the first
    one's."""
    exits = []

    def wait(p):
        code = p.wait()
        exits.append((time.monotonic(), code))
    for p in procs:
        threading.Thread(target=wait, args=(p,), daemon=True).start()
    return exits


def _stop(procs: List[subprocess.Popen], grace_s: float = GRACE_S):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _split_module(argv: List[str]):
    """(the launcher's own arguments, the module after ``-m`` or None,
    the module's arguments): like ``python -m``, everything after the
    module's name is the module's."""
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "-m":
            if i + 1 >= len(argv):
                raise SystemExit("launch: -m needs a module name")
            return argv[:i], argv[i + 1], argv[i + 2:]
        if not tok.startswith("-"):
            break                   # the script: the rest is its own
        i += 1 if "=" in tok or tok in ("--cpu", "-h", "--help") else 2
    return argv, None, []


def launch(argv=None) -> int:
    """The CLI (see the module docstring). Returns the job's exit code:
    0 when every rank exits 0, else the code of the first rank to exit
    non-zero (124 when ``--timeout`` ran out)."""
    own, module, module_args = _split_module(
        list(sys.argv[1:] if argv is None else argv))
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Start one process per rank of a torch.distributed job.")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to start (default: the number of cards)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU over gloo")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before the whole job is stopped")
    ap.add_argument("--grace", type=float, default=GRACE_S,
                    help="seconds the ranks get to exit after a SIGTERM "
                         "before SIGKILL")
    ap.add_argument("script", nargs=None if module is None else "?")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(own)
    if module is not None:
        cmd = [sys.executable, "-m", module, *module_args]
    else:
        cmd = [sys.executable, a.script, *a.args]
    n = a.nproc if a.nproc is not None else (
        1 if a.cpu else torch.cuda.device_count())
    if n < 1:
        print("launch: no card found; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2
    store = rendezvous_store()
    port = store.port
    # a SIGTERM to the launcher (a scheduler's preemption, a fleet's
    # drain) reaches every rank; the ranks then get the grace period
    term = []
    signal.signal(signal.SIGTERM, lambda *_: term.append(time.monotonic()))
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), **AGENT_STORE_ENV)
        if a.cpu:
            env["PADDLE_TPU_DIST_DEVICE"] = "cpu"
        procs.append(subprocess.Popen(cmd, env=env))
    print(f"paddle_tpu_torch.launch: {n} rank(s) on "
          f"{'the CPU' if a.cpu else 'the cards'}, port {port}",
          file=sys.stderr)
    deadline = None if a.timeout is None else time.monotonic() + a.timeout
    rc = 0
    forwarded = False
    exits = _exit_order(procs)
    try:
        while True:
            codes = [c for _, c in sorted(exits)]
            bad = [c for c in codes if c != 0]
            if bad:
                rc = bad[0]
                break
            if len(codes) == n:
                break
            if term and not forwarded:
                forwarded = True
                for p in procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGTERM)
            if term and time.monotonic() > term[0] + a.grace:
                rc = 128 + signal.SIGTERM
                break
            if deadline is not None and time.monotonic() > deadline:
                print("launch: --timeout ran out; stopping every rank",
                      file=sys.stderr)
                rc = 124
                break
            time.sleep(0.1)
    finally:
        _stop(procs, a.grace)
        del store
    return rc


if __name__ == "__main__":
    sys.exit(launch())
