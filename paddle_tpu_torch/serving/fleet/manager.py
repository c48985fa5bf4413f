"""Local replica-process manager (counterpart of
``paddle_tpu/serving/fleet/manager.py``): the process backend the
autoscaler and the fleet loadgen drive — spawn a gateway PROCESS
(:mod:`.replica_main`), wait for its readiness line, wrap it in a
:class:`~.remote.RemoteReplica` and join it to the frontend; drain one
back out under the gateway's existing SIGTERM semantics.

One machine, N processes is the honest local shape of the multi-host
fleet (each process owns its engines, its port and its prefix cache;
nothing is shared but HTTP) — pointing ``spawn_cmd`` at ssh/k8s is the
only change a real multi-host deployment needs, which is why the
manager speaks only argv + readiness line + SIGTERM.

Children are started with ``subprocess`` (``sys.executable -m``), never
``fork``: the parent may already hold a CUDA context. With ``tp=N`` a
replica is a tensor-parallel one: the manager starts
``paddle_tpu_torch.distributed.launch --nproc N`` over ``replica_main
--tp N`` (with ``ep=M`` too, ``--nproc N*M`` over ``--tp N --ep M``: an
MoE model's experts split over ep) in a session of its own, gives it its
N (x M) cards of its own
(``CUDA_VISIBLE_DEVICES``; the launcher picks a free port a replica), and
its ``kill`` and drain reach every rank (a SIGKILL goes to the whole
process group; a SIGTERM to the launcher, which passes it on, and rank 0
drains and then stops the other ranks). Replicas on the
card run the hand-written kernels from the checkout's build directory;
two cold children building the same library at once is safe (each
compiles to a file of its own and renames it into place), and a parent
that built the kernels first (``ops.kernels._build.build_all``) spares
them the build.
"""
from __future__ import annotations

import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ...utils import observability as obs
from .remote import RemoteReplica

__all__ = ["LocalProcessManager"]

READY_PREFIX = "FLEET_REPLICA_READY"


class LocalProcessManager:
    """Spawn/drain gateway subprocesses for a
    :class:`~.frontend.FleetFrontend`.

    Implements the autoscaler's manager duck type (``replicas`` /
    ``pending`` / ``scale_up`` / ``scale_down``) plus the chaos hook
    ``kill`` (SIGKILL — the real process-death the remote failover
    path must survive)."""

    def __init__(self, frontend, *, model: str = "stub",
                 chunk_tokens: int = 8,
                 device: Optional[str] = None,
                 seed: int = 0,
                 engines_per_replica: int = 1,
                 spawn_timeout_s: float = 120.0,
                 probe_interval_s: float = 0.1,
                 stale_after_s: float = 1.5,
                 extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 tp: Optional[int] = None,
                 ep: Optional[int] = None,
                 drain_grace_s: float = 30.0):
        """``device``: the replicas' device (None: the CUDA card;
        ``"cpu"`` asks for the CPU), passed on as ``--device``. ``seed``:
        the Llama models' weights (``--seed``). ``tp``: each replica a
        tensor-parallel one of ``tp`` rank processes under the launcher
        (None: one process), each on ``tp`` of this process's visible
        cards that no other replica holds. ``ep``: with ``tp``, each
        replica's MoE experts split over ``ep`` more ranks (``tp * ep``
        processes and cards). ``drain_grace_s``: how long a drained
        replica may take before SIGKILL."""
        # frontend HA: ``frontend`` may be a LIST — every
        # frontend gets its OWN RemoteReplica adapter per spawned
        # process (own probe thread, own breaker, own staleness
        # clock), under the SAME peer name so gossiped sticky/digest
        # state resolves across siblings. The first frontend is the
        # primary: the autoscaler duck type reads its peer list.
        self.frontends = list(frontend) if isinstance(
            frontend, (list, tuple)) else [frontend]
        self.frontend = self.frontends[0]
        self.name = getattr(self.frontend, "name", "fleet")
        self.model = model
        self.chunk_tokens = int(chunk_tokens)
        self.device = device
        self.seed = int(seed)
        self.engines_per_replica = int(engines_per_replica)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.probe_interval_s = float(probe_interval_s)
        self.stale_after_s = float(stale_after_s)
        self.extra_args = list(extra_args or ())
        self.env = dict(env or {})
        self.log_dir = log_dir
        self.tp = None if tp is None else int(tp)
        if ep is not None and tp is None:
            raise ValueError("ep needs tp: an ep replica is a tp one's "
                             "ranks times ep")
        self.ep = None if ep is None else int(ep)
        # rank processes a replica (tp x ep), None for one process
        self.ranks = None if tp is None else self.tp * (self.ep or 1)
        self.drain_grace_s = float(drain_grace_s)
        self._taken: Dict[str, List[int]] = {}
        self._counter = 0
        self._pending = 0
        self._lock = threading.Lock()
        self.procs: Dict[str, subprocess.Popen] = {}

    # ----------------------------------------------------- the duck type
    def replicas(self) -> List[RemoteReplica]:
        return list(self.frontend.peers)

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def scale_up(self):
        """Asynchronous spawn (a cold start takes seconds; the
        autoscaler counts the pending spawn toward the target so it
        never double-fires)."""
        with self._lock:
            self._pending += 1
        threading.Thread(target=self._spawn_bg, daemon=True,
                         name=f"fleet-spawn-{self.name}").start()

    def _spawn_bg(self):
        try:
            self.spawn()
        except Exception as e:
            obs.record_event("fleet_spawn_failed", fleet=self.name,
                             err=repr(e))
        finally:
            with self._lock:
                self._pending -= 1

    def scale_down(self, migrate: bool = False):
        """Drain the least-loaded live peer: leave rotation first (no
        new traffic), then SIGTERM — ``run_until_shutdown`` finishes
        in-flight work and exits. A reaper escalates to SIGKILL only
        past the drain grace. ``migrate`` records the autoscaler's
        intent in the scale-down event; whether SIGTERM actually cuts
        live requests over is the replica's own ``--migrate`` flag
        (argv is the only channel the manager speaks, and migration
        semantics belong to the process being drained)."""
        peers = [p for p in self.frontend.peers if p.name in self.procs]
        if not peers:
            return
        peer = min(peers, key=lambda p: p.load())
        self._remove_everywhere(peer.name)
        proc = self.procs.pop(peer.name, None)
        obs.record_event("fleet_scale_down", fleet=self.name,
                         peer=peer.name, migrate=bool(migrate))
        if proc is not None:
            threading.Thread(target=self._reap,
                             args=(proc, self.drain_grace_s,
                                   peer.name), daemon=True).start()

    def _remove_everywhere(self, peer_name: str):
        """Drop the named peer's adapter from EVERY frontend (each
        holds its own object for the same process)."""
        for fe in self.frontends:
            for p in list(fe.peers):
                if p.name == peer_name:
                    fe.remove_peer(p)

    def _reap(self, proc: subprocess.Popen, grace_s: float = 30.0,
              name: Optional[str] = None):
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            return
        try:
            proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            self._sigkill(proc)
            proc.wait(5)
        self._free_cards(name)

    def _sigkill(self, proc: subprocess.Popen):
        """SIGKILL the replica: a tp replica's whole process group (the
        launcher and every rank), else the one process."""
        if self.tp is None:
            proc.kill()
            return
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _free_cards(self, name: Optional[str]):
        with self._lock:
            self._taken.pop(name, None)

    def _take_cards(self, name: str) -> Optional[str]:
        """``CUDA_VISIBLE_DEVICES`` for a tp replica's ``tp x ep`` cards
        (None on the CPU or for a one-process replica)."""
        if self.tp is None or self.device == "cpu":
            return None
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible:
            pool = list(range(len(visible.split(","))))
        else:
            import torch
            pool = list(range(torch.cuda.device_count()))
        with self._lock:
            used = {c for cs in self._taken.values() for c in cs}
            free = [c for c in pool if c not in used]
            if len(free) < self.ranks:
                raise RuntimeError(
                    f"a replica of {self.ranks} ranks needs as many free "
                    f"cards; {len(free)} of {len(pool)} are free")
            mine = free[:self.ranks]
            self._taken[name] = mine
        ids = visible.split(",") if visible else None
        return ",".join(ids[c].strip() if ids else str(c) for c in mine)

    # -------------------------------------------------------------- spawn
    def spawn(self) -> RemoteReplica:
        """Start one gateway process, wait for readiness, join it."""
        with self._lock:
            idx = self._counter
            self._counter += 1
        name = f"peer{idx}"
        cmd = [sys.executable, "-m",
               "paddle_tpu_torch.serving.fleet.replica_main",
               "--port", "0", "--model", self.model,
               "--chunk-tokens", str(self.chunk_tokens),
               "--seed", str(self.seed),
               "--engines", str(self.engines_per_replica),
               "--name", f"{self.name}-{name}"]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        cmd += self.extra_args
        env = {**os.environ, **self.env}
        if self.tp is not None:
            cmd = [sys.executable, "-m",
                   "paddle_tpu_torch.distributed.launch",
                   "--nproc", str(self.ranks), "--grace",
                   str(self.drain_grace_s)] \
                + (["--cpu"] if self.device == "cpu" else []) \
                + cmd[1:] + ["--tp", str(self.tp)] \
                + (["--ep", str(self.ep)] if self.ep else [])
            cards = self._take_cards(name)
            if cards is not None:
                env["CUDA_VISIBLE_DEVICES"] = cards
        stderr = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stderr = open(os.path.join(
                self.log_dir, f"{name}.stderr.log"), "w")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=stderr, text=True, env=env,
                                start_new_session=self.tp is not None,
                                cwd=os.path.dirname(os.path.dirname(
                                    os.path.dirname(os.path.dirname(
                                        os.path.abspath(__file__))))))
        # one reader thread per child: it hands lines over until the
        # readiness line, then keeps draining so the pipe never fills.
        # The deadline holds even when the child prints nothing.
        lines: "queue.Queue[Optional[str]]" = queue.Queue()
        threading.Thread(target=self._read_stdout, args=(proc, lines),
                         daemon=True).start()
        deadline = time.monotonic() + self.spawn_timeout_s
        port = None
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                line = lines.get(timeout=left)
            except queue.Empty:
                break
            if line is None:
                break
            if line.startswith(READY_PREFIX):
                for part in line.split():
                    k, _, v = part.partition("=")
                    if k == "port":
                        port = int(v)
                break
        if port is None:
            self._sigkill(proc)
            proc.wait(5)
            self._free_cards(name)
            raise RuntimeError(
                f"replica process never reported ready within "
                f"{self.spawn_timeout_s:g} s (rc={proc.poll()})")
        self.procs[name] = proc
        first = None
        for fe in self.frontends:
            peer = RemoteReplica(
                name, "127.0.0.1", port,
                probe_interval_s=self.probe_interval_s,
                stale_after_s=self.stale_after_s)
            peer.refresh()        # first snapshot before rotation
            fe.add_peer(peer)
            if first is None:
                first = peer
        obs.record_event("fleet_spawn", fleet=self.name, peer=name,
                         port=port)
        return first

    @staticmethod
    def _read_stdout(proc: subprocess.Popen, lines: "queue.Queue"):
        ready = False
        try:
            for line in proc.stdout:
                if not ready:
                    lines.put(line)
                    ready = line.startswith(READY_PREFIX)
        except Exception:
            pass
        lines.put(None)

    # -------------------------------------------------------------- chaos
    def kill(self, peer_name: Optional[str] = None) -> Optional[str]:
        """SIGKILL one replica PROCESS (the chaos harness's mid-run
        kill): no drain, no cleanup — in-flight proxied streams fail
        over through the frontend, probes evict the corpse. Returns
        the killed peer's name."""
        names = [p.name for p in self.frontend.peers
                 if p.name in self.procs]
        if peer_name is None:
            if not names:
                return None
            peer_name = names[0]
        proc = self.procs.pop(peer_name, None)
        if proc is None:
            return None
        # the corpse leaves the MANAGER's books (later kills and
        # scale-downs must target live processes) but its peer adapter
        # stays in rotation: the fleet must DISCOVER the death through
        # failed probes and dropped streams — that's the chaos
        self._sigkill(proc)
        self._free_cards(peer_name)
        threading.Thread(target=proc.wait, daemon=True).start()
        obs.record_event("fleet_chaos_kill", fleet=self.name,
                         peer=peer_name)
        return peer_name

    def stop_all(self, grace_s: float = 10.0):
        for name, proc in list(self.procs.items()):
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        for proc in self.procs.values():
            try:
                proc.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self._sigkill(proc)
        self.procs.clear()
        with self._lock:
            self._taken.clear()
