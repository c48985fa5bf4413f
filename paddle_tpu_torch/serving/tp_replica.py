"""Tensor-parallel serving behind one gateway: rank 0 sequences every
engine call to the other ranks (the JAX package has no counterpart: there
one controller drives a GSPMD-sharded engine).

A tp replica is N processes, one a rank of the model's ``{"tp": N}``
mesh (or of a ``{"tp": N, "ep": M}`` one: N x M processes, the MoE
layers' experts split over ep), each with its own
:class:`~..generation.paged.PagedEngine` over its shards. Every rank must see every call that changes its engine, in the
same order, or the schedules part (the engine compares a digest of each
step's schedule over the ranks and raises). So each rank wraps its
engine in a :class:`SequencedEngine` at the same point of its program:

- **Rank 0** serves it: the :class:`~.gateway.Gateway` takes it as it
  takes an engine. ``submit`` and ``cancel`` are checked on rank 0 (a
  submit past ``max_queue`` or with bad arguments raises there and is
  never recorded) and recorded under one lock. ``step`` sends the batch
  recorded since the last step over the replica's host group (gloo,
  host objects: the group the schedule digest uses), and then every rank,
  rank 0 included, applies the batch through :meth:`_RankState.apply`
  and steps. The group spans every rank of the replica, ep ones too
  (``distributed.env.SERVE_AXES``): each of them runs the same forwards.
  ``hard_reset``, ``rebuild`` (the gateway's
  ``engine_factory``), ``attach_spill``, ``spill_live``,
  ``spill_parked``, a barrier and ``stop`` go out at once, each with the
  calls recorded before it. Reads (results, logprobs, the prefix cache,
  ``export_resumable``, ``debug_snapshot``, the counters) come from rank
  0's engine; the digest proves that the ranks agree.
- **Ranks > 0** call :meth:`SequencedEngine.follow`: receive a batch,
  apply it, repeat until ``stop``.

Deadlines stay each rank's own ``time.monotonic()`` values: a submit's
``timeout_s`` is turned into a deadline where the submit is applied, and
the engine ORs expiries over the ranks. While rank 0 is idle it sends an
empty batch every ``idle_interval_s``, so the followers' wait never
reaches the process group's timeout and a follower that died is found.
Each rank's spill arena holds its own heads' blocks: spills and restores
run on every rank at the same point of the sequence. A span crosses
replicas as one record of the whole model's heads (``serving/kvxfer``):
:meth:`SequencedEngine.xfer_arena` is the arena the gateway exports from
and imports into. An export is a sequenced command: every rank takes its
part from its arena and gathers it to rank 0 over the host group, which
joins the heads in tp order (one rank of each tp coordinate: ep ranks
hold the same heads). An import sends each rank its heads' part of the
decoded record, and every rank puts it at the same point of the
sequence, so the arenas keep the same spans.

A replica that loses a rank does not rebuild in place. On more than
one rank (``tp`` below counts the replica's ranks, tp x ep) an
exception while a batch is sent, applied or stepped (gloo raises when a
peer's connection resets), or a step the gateway's watchdog finds stuck
(:meth:`check_lost`), ends rank 0's process with :data:`EXIT_RANK_LOST`;
the launcher then stops the other ranks and the fleet fails over. At tp
1 there is no other rank: the batch goes through the same encode,
decode and apply without a collective, and an exception propagates as
the plain engine's does.
"""
from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..utils import observability as obs
from ..utils.faults import BackpressureError

__all__ = ["SequencedEngine", "EXIT_RANK_LOST", "IDLE_INTERVAL_S"]

# the exit code of a tp replica's rank 0 that lost a rank
EXIT_RANK_LOST = 70
# an idle leader's heartbeat: well inside the process group's 600 s
IDLE_INTERVAL_S = 60.0


class _RankState:
    """What one rank applies a batch to: its engine, and the factory and
    spill arena a ``rebuild`` and an ``attach_spill`` use (each rank's
    own: the arena holds this rank's heads)."""

    def __init__(self, engine, factory=None, spill_arena=None):
        self.engine = engine
        self.factory = factory
        self.arena = spill_arena
        self.attached = False
        # gathers one object a rank to rank 0 (set by SequencedEngine)
        self.gather = lambda obj: [obj]

    def apply(self, batch, times: Dict[str, float]) -> List[Any]:
        """Apply ``batch``'s commands in order; returns each one's value.
        ``times`` gains the seconds spent in the commands (``apply``)
        and in the engine's step (``step``)."""
        out = []
        for cmd in batch:
            op = cmd[0]
            t0 = time.perf_counter()
            eng = self.engine
            if op == "step":
                out.append(eng.step())
                times["step"] += time.perf_counter() - t0
                continue
            if op == "submit":
                _, rid, ids, kw = cmd
                out.append(eng.submit(rid, ids, **kw))
            elif op == "cancel":
                # nobody reads a cancelled request's records (the
                # gateway drops them right after its cancel)
                rid = cmd[1]
                out.append(eng.cancel(rid))
                for d in (eng.cancelled, eng.results, eng.logprobs):
                    d.pop(rid, None)
            elif op == "hard_reset":
                out.append(eng.hard_reset())
            elif op == "rebuild":
                if self.factory is None:
                    raise RuntimeError("rebuild without an engine factory")
                self.engine = self.factory()
                if self.attached:
                    self.engine.attach_spill(self.arena)
                out.append(None)
            elif op == "attach_spill":
                self.attached = bool(cmd[1])
                out.append(eng.attach_spill(self.arena if self.attached
                                            else None))
            elif op == "spill_live":
                out.append(eng.spill_live())
            elif op == "spill_parked":
                out.append(eng.spill_parked())
            elif op == "export":
                # this rank's part of a span, gathered to rank 0
                got = None if self.arena is None else self.arena.take(
                    cmd[1], eng._spill_geometry())
                out.append(self.gather((_tp_coordinate(), got)))
            elif op == "import":
                _, raw, tokens, parts = cmd
                ok = self.arena is not None and self.arena.put(
                    raw, parts[_tp_coordinate()[0]], tokens,
                    eng._spill_geometry())
                out.append(self.gather(bool(ok)))
            elif op == "barrier":
                out.append(None)
            elif op == "stop":
                out.append(None)
            else:
                raise ValueError(f"unknown sequenced command {op!r}")
            times["apply"] += time.perf_counter() - t0
        return out


def _exit_lost(why: str) -> None:
    os._exit(EXIT_RANK_LOST)


def _tp_coordinate():
    """(tp coordinate, ep coordinate) of this rank on the installed mesh
    ((0, 0) without one)."""
    from ..distributed.env import axis_coordinate, has_mesh
    if not has_mesh():
        return 0, 0
    return axis_coordinate("tp"), axis_coordinate("ep")


class _ReplicaArena:
    """The arena a gateway exports spans from and imports them into, for
    a sequenced replica: spans of the whole model's heads
    (``kvxfer.whole_geometry``), each held as the ranks' parts."""

    def __init__(self, seq: "SequencedEngine"):
        self.seq = seq

    def probe(self, digest: bytes):
        arena = self.seq._rank.arena
        return None if arena is None else arena.probe(digest)

    def take(self, digest: bytes, geometry: tuple):
        """Every rank's part of the span under ``digest``, joined along
        the heads; None when any rank lacks it or ``geometry`` is not the
        whole model's."""
        from . import kvxfer
        if tuple(geometry) != self.seq.xfer_geometry():
            return None
        with self.seq._lock:
            got = self.seq._flush([("export", bytes(digest))])[-1]
        parts = {}
        for (tp, ep), part in got:
            if ep == 0:
                parts[tp] = part
        if any(p is None for p in parts.values()):
            return None
        local = self.seq._rank.engine._spill_geometry()
        return (kvxfer.join_heads([parts[t][0] for t in sorted(parts)],
                                  local), parts[0][1])

    def put(self, digest: bytes, payload: bytes, tokens: int,
            geometry: tuple) -> bool:
        """Each rank's heads of ``payload`` into its arena, at one point
        of the sequence; True when every rank kept it."""
        from . import kvxfer
        if tuple(geometry) != self.seq.xfer_geometry():
            return False
        n = int(self.seq.xfer_geometry()[2]) \
            // int(self.seq._rank.engine._spill_geometry()[2])
        parts = kvxfer.split_heads(payload, geometry, n)
        with self.seq._lock:
            got = self.seq._flush([("import", bytes(digest), int(tokens),
                                    parts)])[-1]
        return all(got)


class SequencedEngine:
    """One rank's engine of a tp replica (see the module docstring).

    Construct it on every rank at the same point of the program, after
    the model is sharded and bound (on several ranks the constructor
    gathers their process ids over the replica's host group). On rank 0
    (``leader``) hand it to the :class:`~.gateway.Gateway` in place of
    the engine; on the others call :meth:`follow`.

    ``factory``: this rank's engine builder for :meth:`rebuild` (pass
    ``engine_factory=seq.rebuild`` to the gateway). ``spill_arena``: the
    arena this rank attaches when rank 0 attaches one (on rank 0 the
    gateway's own). ``idle_interval_s``: the idle leader's heartbeat
    period. ``on_lost``: what rank 0 does when it loses a rank (default:
    exit with :data:`EXIT_RANK_LOST`).

    Attributes it does not define are read from this rank's engine."""

    sequenced = True

    def __init__(self, engine, *, factory=None, spill_arena=None,
                 idle_interval_s: Optional[float] = IDLE_INTERVAL_S,
                 on_lost=None):
        import torch.distributed as dist
        self._rank = _RankState(engine, factory, spill_arena)
        self._rank.gather = self._gather
        # the replica's ranks (tp x ep): every one takes every batch
        self.tp = int(getattr(engine, "_ranks", 1))
        self._group = getattr(engine, "_host_group", None) \
            if self.tp > 1 else None
        if self._group is not None:
            from ..distributed.env import SERVE_AXES, get_mesh
            ranks = get_mesh().ranks(SERVE_AXES)
            self._src = ranks[0]
            self.leader = dist.get_rank() == self._src
            pids = [None] * self.tp
            dist.all_gather_object(pids, os.getpid(), group=self._group)
            self.pids = [int(p) for p in pids]
        else:
            self._src = None
            self.leader = True
            self.pids = [os.getpid()]
        self.idle_interval_s = idle_interval_s
        self._on_lost = on_lost or _exit_lost
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        self._n_submits = 0
        self._stopped = False
        self.lost: Optional[str] = None
        self._in_flush: Optional[float] = None
        self._last_flush = time.monotonic()
        self._heart: Optional[threading.Thread] = None
        self._halt = threading.Event()
        # host seconds: recording calls, sending and decoding batches,
        # applying their commands, and the engine's steps (the step's
        # device work included); counts of batches, steps, heartbeats
        self._times = {"record": 0.0, "broadcast": 0.0, "apply": 0.0,
                       "step": 0.0, "heartbeat": 0.0}
        self._counts = {"batches": 0, "steps": 0, "heartbeats": 0,
                        "batch_bytes": 0}

    # ------------------------------------------------------- delegation
    @property
    def engine(self):
        """This rank's current engine (a ``rebuild`` replaces it)."""
        return self._rank.engine

    def __getattr__(self, name):
        if name.startswith("__") or name == "_rank":
            raise AttributeError(name)
        return getattr(self._rank.engine, name)

    @property
    def trace_sink(self):
        return self._rank.engine.trace_sink

    @trace_sink.setter
    def trace_sink(self, fn):
        self._rank.engine.trace_sink = fn

    @property
    def queue(self) -> list:
        """The engine's queued requests, then the recorded submits not
        applied yet (what a caller counts to decide how many to admit)."""
        return list(self._rank.engine.queue) + [
            c for c in list(self._pending) if c[0] == "submit"]

    # ------------------------------------------------------------ calls
    def submit(self, request_id, input_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               stop_sequences=None, repetition_penalty: float = 1.0,
               timeout_s: Optional[float] = None,
               resume_tokens=None, resume_lps=None):
        """``PagedEngine.submit``, recorded: its ``BackpressureError``
        (the queue counted with the submits not applied yet) and
        ``ValueError``s raise here, before anything is recorded. Applied
        on every rank before the next step."""
        t0 = time.perf_counter()
        with self._lock:
            self._check_open()
            eng = self._rank.engine
            if eng.max_queue is not None and \
                    len(eng.queue) + self._n_submits >= eng.max_queue:
                eng._count("rejected")
                obs.record_event("serve_reject",
                                 engine=eng._obs_labels["engine"],
                                 request_id=request_id,
                                 queued=len(eng.queue) + self._n_submits)
                raise BackpressureError(
                    f"engine admission queue at capacity "
                    f"({eng.max_queue} queued); shed load or retry with "
                    f"backoff")
            ids, stop, resume = eng.check_submit(
                input_ids, int(max_new_tokens), stop_sequences,
                float(repetition_penalty), resume_tokens)
            # plain values only: what every rank applies is what rank 0
            # checked
            kw = dict(
                max_new_tokens=int(max_new_tokens),
                eos_token_id=None if eos_token_id is None
                else int(eos_token_id),
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p),
                seed=None if seed is None else int(seed),
                stop_sequences=[list(s) for s in stop] or None,
                repetition_penalty=float(repetition_penalty),
                timeout_s=None if timeout_s is None else float(timeout_s),
                resume_tokens=resume or None,
                resume_lps=None if resume_lps is None
                else [float(v) for v in resume_lps])
            self._pending.append(("submit", request_id, ids, kw))
            self._n_submits += 1
            self._times["record"] += time.perf_counter() - t0

    def cancel(self, request_id) -> bool:
        """``PagedEngine.cancel``, recorded; applied on every rank before
        the next step, with the request's records dropped. True when
        the request is queued, running or recorded."""
        t0 = time.perf_counter()
        with self._lock:
            self._check_open()
            eng = self._rank.engine
            known = any(c[0] == "submit" and c[1] == request_id
                        for c in self._pending) \
                or any(r.request_id == request_id for r in eng.queue) \
                or any(s is not None and s.request_id == request_id
                       for s in eng.slots)
            self._pending.append(("cancel", request_id))
            self._times["record"] += time.perf_counter() - t0
            return known

    def step(self):
        """Send the recorded calls and a step; every rank applies them
        and steps."""
        with self._lock:
            self._flush([("step",)])

    def run(self) -> Dict[Any, List[int]]:
        """Step until the queue and the slots drain (``PagedEngine.run``)."""
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return dict(self._rank.engine.results)

    def hard_reset(self):
        """Every rank's engine back to empty (``PagedEngine.hard_reset``)."""
        with self._lock:
            self._flush([("hard_reset",)])

    def rebuild(self) -> "SequencedEngine":
        """Every rank replaces its engine with its ``factory()``'s; returns
        this object (the gateway's ``engine_factory``)."""
        with self._lock:
            self._flush([("rebuild",)])
        return self

    def attach_spill(self, arena):
        """Rank 0 attaches ``arena``, every other rank its own (or each
        detaches, with None)."""
        with self._lock:
            if arena is not None:
                self._rank.arena = arena
            self._flush([("attach_spill", arena is not None)])

    def spill_live(self) -> int:
        with self._lock:
            return self._flush([("spill_live",)])[-1]

    def spill_parked(self) -> int:
        with self._lock:
            return self._flush([("spill_parked",)])[-1]

    def barrier(self):
        """Returns once every rank has applied everything recorded so far
        (a replica's readiness: every rank warmed)."""
        with self._lock:
            self._flush([("barrier",)])
            if self._group is not None:
                import torch.distributed as dist
                dist.barrier(group=self._group)

    def stop(self):
        """Send ``stop``: every follower returns from :meth:`follow`.
        Later calls that change the engine raise ``RuntimeError``."""
        with self._lock:
            if self._stopped:
                return
            self._flush([("stop",)])
            self._stopped = True
        self._halt.set()

    # ------------------------------------------------ the KV transfer
    def xfer_geometry(self) -> tuple:
        """The geometry of this replica's spans as records carry them:
        the whole model's kv heads (``kvxfer.whole_geometry``)."""
        from . import kvxfer
        local = self._rank.engine._spill_geometry()
        heads = int(getattr(self._rank.engine.model.config,
                            "num_key_value_heads", None)
                    or self._rank.engine.model.config.num_attention_heads)
        return kvxfer.whole_geometry(local, heads // int(local[2]))

    def xfer_arena(self) -> _ReplicaArena:
        """The arena the gateway exports spans from and imports them
        into (module docstring)."""
        return _ReplicaArena(self)

    def _gather(self, obj):
        """``obj`` of every rank of the replica, in its group's order, on
        rank 0 (None on the others); ``[obj]`` at one rank."""
        if self._group is None:
            return [obj]
        import torch.distributed as dist
        got = [None] * self.tp if self.leader else None
        dist.gather_object(obj, got, dst=self._src, group=self._group)
        return got

    # ------------------------------------------------------- the leader
    def _check_open(self):
        if not self.leader:
            raise RuntimeError("a follower rank's engine is driven by rank "
                               "0: call follow()")
        if self.lost is not None:
            self._lose(self.lost)
        if self._stopped:
            raise RuntimeError("the tp replica's sequencer has stopped")

    def _flush(self, cmds) -> List[Any]:
        """Send the recorded calls followed by ``cmds`` and apply them
        here (the lock held); returns the commands' values."""
        self._check_open()
        batch = self._pending + list(cmds)
        self._pending = []
        self._n_submits = 0
        self._in_flush = time.monotonic()
        try:
            t0 = time.perf_counter()
            batch = self._send(batch)
            self._times["broadcast"] += time.perf_counter() - t0
            out = self._rank.apply(batch, self._times)
        except BaseException as e:
            if self.tp > 1:
                self._lose(f"{type(e).__name__}: {e}")
            raise
        finally:
            self._in_flush = None
            self._last_flush = time.monotonic()
        self._count(batch)
        if self._heart is None and self._group is not None \
                and self.idle_interval_s:
            self._heart = threading.Thread(
                target=self._heartbeat, daemon=True,
                name=f"tp-heartbeat-{os.getpid()}")
            self._heart.start()
        return out

    def _count(self, batch):
        self._counts["batches"] += 1
        self._counts["steps"] += sum(c[0] == "step" for c in batch)

    def _heartbeat(self):
        """Send an empty batch whenever nothing was sent for
        ``idle_interval_s`` (never while calls are recorded: the tick
        that follows them sends them)."""
        period = float(self.idle_interval_s)
        while not self._halt.wait(min(period / 4, 1.0)):
            if time.monotonic() - self._last_flush < period:
                continue
            if not self._lock.acquire(blocking=False):
                continue
            try:
                if self._stopped or self._pending or self.lost:
                    continue
                t0 = time.perf_counter()
                self._flush([])
                self._times["heartbeat"] += time.perf_counter() - t0
                self._counts["heartbeats"] += 1
            except BaseException:
                return
            finally:
                self._lock.release()

    def _lose(self, why: str):
        """Rank 0 lost a rank (or cannot tell that it did not): end the
        replica. Raises ``RuntimeError`` where ``on_lost`` returns."""
        first = self.lost is None
        self.lost = why
        if first:
            obs.record_event("tp_replica_lost", pid=os.getpid(), why=why)
            print(f"tp replica (pids {self.pids}) lost a rank: {why}",
                  file=sys.stderr, flush=True)
        self._halt.set()
        self._on_lost(why)
        raise RuntimeError(f"the tp replica lost a rank: {why}")

    def check_lost(self, stuck_s: float):
        """The gateway watchdog's hook on a stuck tick: at tp > 1 a step
        stuck inside a batch (a collective waiting for a rank) ends the
        replica; a stall outside one is the gateway's to handle."""
        if self.tp > 1 and self._in_flush is not None:
            self._lose(f"a sequenced step stuck for {stuck_s:.1f} s")

    # ------------------------------------------------------ the followers
    def _send(self, batch):
        """The batch as every rank receives it: rank 0's, encoded, sent
        over the replica's host group (two gloo broadcasts: its length, its
        bytes) and decoded; at tp 1 encoded and decoded here."""
        if self.leader:
            data = pickle.dumps(batch)
            self._counts["batch_bytes"] += len(data)
            if self._group is None:
                return pickle.loads(data)
        if self._group is None:
            raise RuntimeError("a tp replica of one rank has no followers")
        import torch.distributed as dist
        n = torch.tensor([len(data) if self.leader else 0],
                         dtype=torch.int64)
        dist.broadcast(n, src=self._src, group=self._group)
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) \
            if self.leader else torch.empty(int(n), dtype=torch.uint8)
        dist.broadcast(buf, src=self._src, group=self._group)
        # bytes from rank 0 of this replica only
        return pickle.loads(buf.numpy().tobytes())

    def follow(self, keep: Optional[Dict[Any, Any]] = None
               ) -> Dict[str, Any]:
        """A follower rank's loop: receive a batch, apply it, repeat until
        ``stop``; returns :meth:`sequencer_stats`. Finished and aborted
        requests' records are dropped after each batch (rank 0's are the
        ones served); ``keep`` collects them instead, request id ->
        tokens, or the abort reason."""
        if self.leader:
            raise RuntimeError("rank 0 serves the engine; follow() is for "
                               "the other ranks")
        while True:
            t0 = time.perf_counter()
            batch = self._send(None)
            self._times["broadcast"] += time.perf_counter() - t0
            self._rank.apply(batch, self._times)
            self._count(batch)
            if any(c[0] == "barrier" for c in batch):
                import torch.distributed as dist
                dist.barrier(group=self._group)
            if not batch:
                self._counts["heartbeats"] += 1
            eng = self._rank.engine
            if keep is not None:
                keep.update(eng.results)
                keep.update(eng.cancelled)
            eng.results.clear()
            eng.logprobs.clear()
            eng.cancelled.clear()
            if batch and batch[-1][0] == "stop":
                self._stopped = True
                return self.sequencer_stats()

    # ----------------------------------------------------------- reads
    def sequencer_stats(self) -> Dict[str, Any]:
        """Batches, steps and heartbeats sent or received, batch bytes; host
        microseconds recording calls, sending batches (encode, broadcast,
        decode), applying their commands and stepping, in total and per
        step; the replica's process ids."""
        steps = max(self._counts["steps"], 1)
        us = {k: round(v * 1e6, 1) for k, v in self._times.items()}
        return {
            "tp": self.tp, "leader": self.leader, "pids": list(self.pids),
            "idle_interval_s": self.idle_interval_s,
            "lost": self.lost, "stopped": self._stopped,
            **self._counts,
            "host_us": us,
            "host_us_per_step": {
                k: round(us[k] / steps, 1)
                for k in ("record", "broadcast", "apply")},
        }

    def debug_snapshot(self, *args, **kw) -> Dict[str, Any]:
        doc = self._rank.engine.debug_snapshot(*args, **kw)
        doc["tp_sequencer"] = self.sequencer_stats()
        return doc
