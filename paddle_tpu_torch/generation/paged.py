"""Paged KV cache and continuous batching (counterpart of
``paddle_tpu/generation/paged.py``): the paged KV helpers and
``PagedEngine``, with its device-resident tick (the default) and the
per-tick host path (``fused_tick=False``, the bit-exactness reference).

- The KV cache is a pool of ``num_blocks`` physical blocks of
  ``block_size`` tokens per layer (``[P, B, kvh, d]``, the JAX package's
  layout). A request owns a row of the ``[R, M]`` block table mapping its
  logical blocks to physical ones, so memory grows in block quanta.
- The pools are written IN PLACE (``index_put_``), where the JAX package
  scatters into donated copies and returns them. Pad positions and idle
  rows write into the reserved garbage block 0, which is never allocated:
  their writes may collide there (which of them lands is undefined) and
  nothing ever reads them as live data.
- Each ``step()`` admits what fits (slot and blocks), prefills (whole
  prompt or one chunk per prefilling slot), then runs one decode tick for
  every active slot. Scheduling, the prefix cache, preemption, stop
  sequences, cancel and timeout are host bookkeeping, as in the JAX
  package.
- A decode tick's attention is the ragged paged kernel, once per layer
  (the grid paged kernel under ``PADDLE_TPU_PAGED_ATTN=grid``, as in the
  JAX package); whole-prompt prefill is dense causal attention over the
  prompt and a chunk attends over its row's gathered blocks.
- The device-resident tick (``fused_tick=True``): block tables, lengths,
  last tokens, sampling parameters, keys, budgets, eos ids and the
  active mask live on the device as one fixed set of tensors, allocated
  once per engine and advanced in place by the tick program (attention,
  repetition penalty, sampling, done flags). On a CUDA card each program
  (greedy or sampled, K ticks, the paged-attention route) is captured
  once into a CUDA graph and replayed: a steady tick is one replay and
  no upload. On the CPU the same function runs eagerly.
- Ring mode (on with the fused tick): the program appends each tick's
  tokens to a device ring; the ring is copied to pinned host memory
  after the replay without waiting, and the next ``step()`` drains it,
  one step behind the device. Slot transitions travel as one-row
  descriptors (delta transitions), staged into a device queue the next
  tick's program applies first (the fused patch queue).
  ``delta_transitions=False`` (full rebuilds), ``patch_fuse=False``
  (one eager patch per descriptor) and ``ring_mode=False`` (a blocking
  read of each tick) are the JAX package's reference modes, kept bitwise
  equal to the default.

- Speculative ticks (``spec_tokens=k``): each tick drafts up to k tokens
  a row from the row's own committed stream (prompt lookup), verifies
  the k+1 positions in one model call (the ragged kernel at T = k+1,
  under either kernel route: one launch a layer while (k+1) x the query
  heads per kv head fit its 32 query rows, else one per window of
  queries that fit), and commits each row's accepted window inside the
  same program (an unrolled accept scan: repetition penalty as of each
  position, eos and budget cutting the window). A row's draft count
  adapts to its accept rate (an EMA on the device) and to its write
  headroom, down to the plain one-token tick inside the same program.
  Sampled rows draw each position's token as the plain tick would with
  the same key, so spec streams equal spec-off streams on the same
  logits, greedy and sampled.

- The tick-phase profiler (``tick_profile=True``): each ``step()`` is
  one window split into host, h2d (uploads), dispatch (the graph
  replay, or the eager program on the CPU), device (the wait for the
  device at the drain) and drain (the host read of the outputs), the
  host being the residual, so the five sum to the wall exactly. Phases
  land in registry histograms and a bounded ring of per-tick records
  (the ``tickphase/1`` document). It reads clocks and waits only where
  the next statement would wait anyway: streams, dispatches and uploads
  are those of the profiler off.
- The host-RAM spill tier (``attach_spill``): prefix-cache spans are
  copied to a :class:`~..serving.kvspill.KVSpillArena` before eviction
  (and on drain), and a later admission whose prefix the arena holds
  scatters it back into the pools in place (one dispatch, one upload)
  instead of prefilling it. Spilled bytes are laid out as the JAX
  package's: ``(2L, n, B, kvh, d)`` in the pool's dtype.

On a card, engines on distinct models can tick on their own threads
(the serving gateway's replicas): their steps run together, and a tick
graph's capture runs alone (``device.card_lock``).

On a ``tp`` mesh (a model sharded by ``parallel.sharding.shard_layer``
and bound by ``bind_static``) every rank runs an engine over the same
submissions: its pools hold its own ``num_key_value_heads / tp`` heads,
its forwards call the tp layers' collectives, and its host scheduler
must decide as every other rank does. Its decisions read the engine's
own state alone, except a request's deadline, which reads a clock: the
ranks agree on which deadlines passed (one host all-reduce a step while
a request has one). At tp > 1 each step compares a digest of its
schedule (queue length, slots and their prefill and token counts, block
tables, lengths, dispatches) across the ranks over a gloo group of host
tensors, and raises where they part.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
import json
import os
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import card_lock
from ..distributed.env import axis_degree, get_mesh
from ..ops.attention import dense_attention, use_paged_kernel
from ..ops.kernels.paged_attention import paged_attention
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..parallel.layers import local_heads
from ..utils import observability as obs
from ..utils.faults import BackpressureError
from .graphs import CapturedStep, ExecCache
from .prompt_lookup import mask_drafts, propose_ngram_rows, token_buffer_row
from .sampling import (fold_in_rows, override_key_rows,
                       repetition_penalty_rows, sample_token_rows,
                       seed_key_row)

__all__ = ["PagedKV", "PagedEngine"]

# unique per-process engine label: every engine's counters live in the
# process registry, while `stats` / `health()` stay per instance
_engine_ids = itertools.count()

# adaptive draft count of the speculative tick (the JAX package's policy):
# a per-request EMA of the accepted share of drafts, kept on the device
# with a host mirror on the request. Below the floor a row stops drafting
# and probes with one draft every PROBE-th tick it is active.
_SPEC_EMA_ALPHA = 0.3
_SPEC_EMA_FLOOR = 0.25
_SPEC_PROBE_EVERY = 16



# the JAX package's dtype names: a spilled span's geometry says them, so
# spans are laid out and checked as the JAX package's are
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32"}


def _card_work(fn):
    """An engine method that launches work on its card runs under a share
    of ``card_lock`` there (a capture or a profiler's start and stop hold
    it alone)."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self.device.type != "cuda":
            return fn(self, *args, **kwargs)
        with card_lock.shared():
            return fn(self, *args, **kwargs)
    return run


class PagedKV(NamedTuple):
    """Per-layer paged cache view handed to the attention modules.

    kp/vp: [P, B, kvh, d] physical block pools (this layer's), written in
    place. block_tables: [R, M] int32 physical block per (slot, logical
    block). seq_lens: [R] int32 tokens already cached per slot == this
    step's write position."""
    kp: Any
    vp: Any
    block_tables: Any
    seq_lens: Any

    @property
    def block_size(self) -> int:
        return self.kp.shape[1]


def _last_writer(slot):
    """slot [N]: each write's flat target. Returns, for each write, the
    index of the last write to the same target: writing
    ``src[_last_writer(slot)]`` gives colliding writes one value, the
    sequential (last wins) result, whatever order the device applies
    duplicate indices in (CUDA does not order them)."""
    ar = torch.arange(slot.shape[0], device=slot.device)
    return torch.where(slot[:, None] == slot[None, :], ar, -1).amax(1)


def paged_decode_write(pk: PagedKV, k, v) -> PagedKV:
    """Write each row's new K/V (k [R, T, kvh, d]) into its blocks at
    positions seq_len .. seq_len+T-1, in place; returns ``pk``. Positions
    past a row's allocated blocks land in the garbage block (unallocated
    table entries are 0, and logical blocks past M go there
    explicitly). Idle rows collide there and read their position 0 back,
    and in an MoE layer their hidden states compete with live rows for
    capacity, so colliding writes all carry the last row's K/V
    (``_last_writer``): the tick is deterministic on a card."""
    B = pk.block_size
    R, T = k.shape[0], k.shape[1]
    lens = pk.seq_lens.long()
    tables = pk.block_tables.long()
    if T == 1:
        r = torch.arange(R, device=k.device)
        bidx = tables[r, lens // B]
        boff = lens % B
    else:
        M = tables.shape[1]
        r = torch.arange(R, device=k.device)[:, None]
        pos = lens[:, None] + torch.arange(T, device=k.device)[None, :]
        lb = pos // B
        bidx = torch.where(lb < M, tables[r, lb.clamp(0, M - 1)],
                           torch.zeros_like(lb)).reshape(-1)
        boff = (pos % B).reshape(-1)
    w = _last_writer(bidx * B + boff)
    k, v = k.reshape(R * T, *k.shape[2:]), v.reshape(R * T, *v.shape[2:])
    pk.kp.index_put_((bidx, boff), k[w].to(pk.kp.dtype))
    pk.vp.index_put_((bidx, boff), v[w].to(pk.vp.dtype))
    return pk


def paged_prefill_write(pk: PagedKV, k, v, positions=None,
                        garbage_block: int = 0) -> PagedKV:
    """Write a [1, s, kvh, d] prompt's (or chunk's) K/V into row 0's
    blocks in place; pad positions (>= seq_lens[0]) go to the garbage
    block. ``positions`` [s] are the tokens' global positions (default
    0..s-1, the whole-prompt case)."""
    B = pk.block_size
    s = k.shape[1]
    pos = positions.long() if positions is not None else torch.arange(
        s, device=k.device)
    tables = pk.block_tables.long()
    M = tables.shape[1]
    live = pos < pk.seq_lens[0].long()
    bidx = torch.where(live, tables[0, (pos // B).clamp(max=M - 1)],
                       torch.full_like(pos, garbage_block))
    boff = pos % B
    pk.kp.index_put_((bidx, boff), k[0].to(pk.kp.dtype))
    pk.vp.index_put_((bidx, boff), v[0].to(pk.vp.dtype))
    return pk


def paged_chunk_attention(q, pk: PagedKV, positions,
                          window: Optional[int] = None):
    """Chunked-prefill attention: q [1, s, h, d] chunk queries at global
    ``positions`` [1, s] attend over row 0's gathered blocks, the earlier
    chunks and (causally) this chunk, which ``paged_prefill_write`` wrote
    just before."""
    kvh, d = pk.kp.shape[2], pk.kp.shape[3]
    tbl = pk.block_tables[0].long()
    ks = pk.kp[tbl].reshape(1, -1, kvh, d)
    vs = pk.vp[tbl].reshape(1, -1, kvh, d)
    kpos = torch.arange(ks.shape[1], device=q.device)[None, :]
    qpos = positions[0].long()[:, None]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (qpos - kpos < window)
    return dense_attention(q, ks, vs, attn_mask=keep[None, None])


def paged_decode_attention(q, pk: PagedKV, scale: Optional[float] = None,
                           window: Optional[int] = None):
    """q [R, T, h, d] against each row's blocks: query t of row r sits at
    position seq_lens[r] + t and attends tokens 0..seq_lens[r]+t.

    ``PADDLE_TPU_PAGED_ATTN``, read at each call, picks the route as in the
    JAX package, when ``use_paged_kernel`` admits the shapes:

    - ``ragged`` (the default, and any unknown value): the ragged paged
      kernel, for single- and multi-query rows;
    - ``grid``: the grid paged kernel for single-query rows (T == 1);
      multi-query rows (the speculative verify) take the ragged kernel,
      where the JAX package takes its dense gather: the grid kernel holds
      one query a row, and the plain gather must not run on a card;
    - ``dense``: the dense gather.

    Each kernel runs its plain version on CPU tensors. The dense route is
    the whole-table gather with a per-(row, position) mask; it also takes
    the shapes the gate refuses."""
    R, T = q.shape[0], q.shape[1]
    kvh, d = pk.kp.shape[2], pk.kp.shape[3]
    mode = os.environ.get("PADDLE_TPU_PAGED_ATTN", "ragged")
    if mode != "dense" and use_paged_kernel(q, pk.kp):
        if T == 1:
            fn = paged_attention if mode == "grid" else ragged_paged_attention
            return fn(q[:, 0], pk.kp, pk.vp, pk.block_tables, pk.seq_lens,
                      scale, window=window)[:, None]
        return ragged_paged_attention(q, pk.kp, pk.vp, pk.block_tables,
                                      pk.seq_lens, scale, window=window)
    tbl = pk.block_tables.long()
    ks = pk.kp[tbl]                                   # [R, M, B, kvh, d]
    vs = pk.vp[tbl]
    Tk = ks.shape[1] * ks.shape[2]
    ks = ks.reshape(R, Tk, kvh, d)
    vs = vs.reshape(R, Tk, kvh, d)
    kpos = torch.arange(Tk, device=q.device)[None, None, :]
    qpos = pk.seq_lens.long()[:, None, None] + torch.arange(
        T, device=q.device)[None, :, None]
    keep = kpos <= qpos                               # [R, T, Tk]
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return dense_attention(q, ks, vs, attn_mask=keep[:, None], scale=scale)


def _choose_tokens(raw, sampling=None):
    """A tick's token choice from penalised fp32 logits [R, V]: the argmax
    (``sampling`` None: every row greedy, keys untouched) or per-row
    sampling with ``sampling = (keys, temps, top_ks, top_ps)``. Returns
    (tokens, logprobs, new keys or None)."""
    if sampling is None:
        nxt = torch.argmax(raw, dim=-1)
        lps = torch.log_softmax(raw, dim=-1).gather(1, nxt[:, None])[:, 0]
        return nxt, lps, None
    return sample_token_rows(raw, *sampling)


def _check_verify_shapes(cfg, T: int):
    """On a card, the speculative verify's attention must take the ragged
    kernel: raise ValueError when the kernel gate refuses the model's
    shapes at T queries a row, which would send every layer's verify
    through the plain gather."""
    h, kvh = local_heads(cfg)
    d = cfg.head_dim
    if not use_paged_kernel(torch.empty(1, T, h, d, device="meta"),
                            torch.empty(1, 1, kvh, d, device="meta")):
        raise ValueError(
            f"spec_tokens on a card needs the ragged paged kernel, which "
            f"does not take {h} query heads over {kvh} kv heads at "
            f"head_dim {d}")


def _check_pageable(model):
    """The pools hold each layer's K/V per kv head, as the models' static
    (k, v) caches do. A model whose own cache has another layout (MLA's
    latents and k_pe a layer) cannot be paged: ValueError, as the JAX
    engine's unpacking of its PagedKV raises."""
    init = getattr(model, "init_kv_caches", None)
    if init is None:                     # a stub model: no static cache
        return
    cfg = model.config
    want = (1, 1, local_heads(cfg)[1], cfg.head_dim)
    layer = init(1, 1)[0]
    got = [tuple(t.shape) for t in layer]
    if got != [want, want]:
        raise ValueError(
            f"PagedEngine: the model's KV cache is {got} a layer (batch "
            f"1, length 1), not per-head (k, v) {[want, want]}; the "
            f"PagedKV pools hold per-head K/V, so an MLA model is not "
            f"paged (the JAX engine fails on the same unpacking)")


class _Request:
    """Queued or running request. ``key`` is the row's sampling key
    [seed, counter] (uint32): each emitted token, at prefill or at a
    decode tick, advances the counter by one, so a preempted request that
    re-prefills continues the same stream."""
    __slots__ = ("request_id", "prompt", "max_new", "eos", "tokens",
                 "blocks", "prefix", "prefix_lps", "admit_seq",
                 "temperature", "top_k", "top_p", "key", "lps",
                 "prefill_pos", "stop", "trim", "rep", "deadline",
                 "t_submit", "spec_ema")

    def __init__(self, request_id, prompt, max_new, eos, temperature,
                 top_k, top_p, key, prefix=None, prefix_lps=None,
                 stop=(), rep=1.0, deadline=None):
        self.request_id = request_id
        self.prompt = prompt            # ids the prefill runs over
        self.max_new = max_new          # tokens still to emit
        self.eos = eos
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.key = key                  # [2] uint32 (seed, counter)
        self.stop = stop                # token-id stop sequences
        self.trim = 0                   # matched stop length to cut
        self.rep = rep                  # repetition penalty (1.0 = off)
        self.deadline = deadline        # monotonic() cutoff (None = no cap)
        self.prefix = prefix or []      # tokens emitted before preemption
        self.prefix_lps = prefix_lps or []
        self.admit_seq = 0              # preemption picks the youngest
        self.tokens: List[int] = []
        self.lps: List[float] = []      # chosen-token logprobs
        self.blocks: List[int] = []
        self.prefill_pos = 0            # prompt tokens already cached
        self.t_submit = time.monotonic()
        self.spec_ema = 1.0             # accepted share of drafts (EMA)


class _TickPhaseProfile:
    """Tick-phase accounting: where one scheduler tick's wall time goes.

    - ``h2d``      — uploads of host mirrors and staged patches
    - ``dispatch`` — the tick program's dispatch: one CUDA-graph replay
                     call on a card (the launch, not the compute), the
                     eager program on the CPU
    - ``device``   — the wait for the device at the drain boundary (the
                     ring copy's event, or the stream in sync mode): the
                     program-bound wait the host actually ate
    - ``drain``    — the host read of the outputs after that wait
    - ``host``     — the residual: tick wall minus the four bracketed
                     phases (scheduler bookkeeping, descriptor packing,
                     stop matching, trace emission)

    The residual construction makes the five phases sum to the tick wall
    exactly (pinned under an injected clock in the tests).

    Host-side bookkeeping only: phases land in registry histograms
    (``paged_tick_phase_ms{phase=...}`` on the SERVING_MS_BUCKETS grid)
    plus a bounded per-tick ring of records (phase times, dispatches,
    uploads, bytes, fused patches, active slots). Nothing here touches
    the device beyond a wait the very next statement would make anyway:
    profile-on streams are bitwise profile-off streams, and the steady
    tick stays one dispatch and no upload.

    ``clock`` is injectable (tests pin the phase math deterministically
    the way ``MetricsTimeSeries(clock=...)`` does)."""

    def __init__(self, labels: Dict[str, str], clock=None,
                 capacity: int = 1024):
        self.clock = clock if clock is not None else time.perf_counter
        self.capacity = max(int(capacity), 1)
        self.ring: deque = deque(maxlen=self.capacity)
        self.totals = {p: 0.0 for p in obs.TICK_PHASES}
        self.wall_total_ms = 0.0
        self.ticks = 0
        reg = obs.registry()
        self._hists = {
            p: reg.histogram("paged_tick_phase_ms",
                             buckets=obs.SERVING_MS_BUCKETS,
                             phase=p, **labels)
            for p in obs.TICK_PHASES}
        self._h_wall = reg.histogram("paged_tick_wall_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **labels)
        self._acc: Optional[Dict[str, float]] = None
        self._t0 = 0.0
        self._last: Optional[Dict[str, float]] = None

    def begin(self):
        """Open a tick window (top of ``PagedEngine.step``)."""
        self._acc = {p: 0.0 for p in obs.TICK_PHASES if p != "host"}
        self._t0 = self.clock()

    def add(self, phase: str, dt_ms: float):
        """Accumulate one bracketed window. Out-of-tick windows (the
        scoped drains a cancel or expiry runs between steps) feed the
        totals and histograms but no tick record: there is no tick."""
        dt_ms = max(float(dt_ms), 0.0)
        if self._acc is None:
            self.totals[phase] += dt_ms
            self._hists[phase].observe(dt_ms)
            return
        self._acc[phase] += dt_ms

    def acc(self, phase: str) -> float:
        """The current tick's accumulated time for ``phase`` (0 outside a
        tick): lets a caller bracket a compound expression and deduct
        the child uploads it already counted."""
        return self._acc.get(phase, 0.0) if self._acc is not None \
            else 0.0

    def end(self, *, dispatches: int, uploads: int, nbytes: int,
            patches: int, active: int):
        """Close the tick: host = wall - bracketed phases (clamped at 0),
        observe the histograms, append the ring record."""
        t1 = self.clock()
        wall = max((t1 - self._t0) * 1e3, 0.0)
        acc = self._acc or {}
        self._acc = None
        host = max(wall - sum(acc.values()), 0.0)
        phases = dict(acc)
        phases["host"] = host
        rec: Dict[str, Any] = {
            "tick": self.ticks, "t": round(float(t1), 6),
            "wall_ms": round(wall, 4),
        }
        for p in obs.TICK_PHASES:
            v = phases.get(p, 0.0)
            rec[f"{p}_ms"] = round(v, 4)
            self.totals[p] += v
            self._hists[p].observe(v)
        rec.update(dispatches=int(dispatches), uploads=int(uploads),
                   bytes=int(nbytes), patches=int(patches),
                   active=int(active))
        self._h_wall.observe(wall)
        self.wall_total_ms += wall
        self.ticks += 1
        self.ring.append(rec)
        self._last = {k: rec[k] for k in
                      ("wall_ms",) + tuple(f"{p}_ms"
                                           for p in obs.TICK_PHASES)}

    def last_phases(self) -> Optional[Dict[str, float]]:
        """The most recent completed tick's phase split: what a drained
        tick trace event attaches (the drain commits tokens one dispatch
        behind)."""
        return dict(self._last) if self._last is not None else None

    def to_doc(self, engine: str) -> Dict[str, Any]:
        """The ``tickphase/1`` document (``obs.validate_tickphase_doc``
        checks it)."""
        return {"schema": obs.TICKPHASE_SCHEMA, "engine": engine,
                "dumped_wall": time.time(),
                "clock_now": float(self.clock()),
                "capacity": self.capacity, "ticks": self.ticks,
                "wall_total_ms": round(self.wall_total_ms, 4),
                "phase_totals_ms": {p: round(v, 4) for p, v
                                    in self.totals.items()},
                "entries": list(self.ring)}


class PagedEngine:
    """Continuous-batching serving engine for Llama-family CausalLMs.

    submit() enqueues requests at any time; each step() admits what fits
    (slot + blocks), prefills, and advances every active slot one token.
    Finished requests free their blocks at once, so capacity recycles
    mid-stream. The pools live on the model's device: on a CUDA model a
    decode tick launches the ragged paged kernel once per layer.

    The constructor keeps the JAX package's signature, defaults and
    ``ValueError``s: the device-resident tick (``fused_tick=True``) with
    ring mode, delta transitions and the fused patch queue (queue length
    R) on, a ring of 16, one tick a dispatch. ``ticks_per_dispatch=K``
    runs K ticks in one program where that cannot change a stream.
    ``spec_tokens=k`` makes every tick speculative (up to k drafts a row
    from ``spec_ngram``-token matches; it takes precedence over K).
    ``tick_profile=True`` times each tick's phases (``profile_clock``
    injectable, ``profile_ring_len`` records kept). At tp > 1 each
    step compares its :meth:`schedule_digest` across the tp ranks.

    On a CUDA card a tick program that fails to capture or replay raises:
    the engine never falls back to an eager tick.
    """

    def __init__(self, model, max_slots: int = 8, num_blocks: int = 128,
                 block_size: int = 16, max_blocks_per_seq: int = 16,
                 prefill_buckets=(32, 64, 128),
                 chunk_prefill_tokens: Optional[int] = None,
                 enable_prefix_cache: bool = False,
                 max_queue: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 fused_tick: bool = True,
                 ticks_per_dispatch: int = 1,
                 spec_tokens: int = 0,
                 spec_ngram: int = 2,
                 ring_mode: Optional[bool] = None,
                 ring_len: Optional[int] = None,
                 delta_transitions: Optional[bool] = None,
                 patch_fuse: Optional[bool] = None,
                 patch_queue_len: Optional[int] = None,
                 tick_profile: bool = False,
                 profile_clock=None,
                 profile_ring_len: int = 1024):
        from . import _check_serving
        _check_serving(model, "PagedEngine")
        self.model = model
        self.device = model.device
        self.R, self.P, self.B, self.M = (max_slots, num_blocks,
                                          block_size, max_blocks_per_seq)
        self.prefill_buckets = sorted(prefill_buckets)
        # chunked prefill: prompts enter the cache chunk_prefill_tokens at
        # a time, interleaved with decode ticks, quantized to block_size
        # so chunk boundaries align with block boundaries
        if chunk_prefill_tokens is not None:
            chunk_prefill_tokens = max(
                block_size,
                -(-chunk_prefill_tokens // block_size) * block_size)
        self.chunk = chunk_prefill_tokens
        # automatic prefix caching: prompts sharing a prefix point their
        # tables at the same physical blocks and skip its prefill. Reuse is
        # quantized to the chunk grid, so every reused span was computed by
        # the same chunk shape at the same offsets a borrower would use:
        # reuse is bit-exact. Blocks whose last owner finished park in an
        # LRU pool and are evicted only under block pressure.
        if enable_prefix_cache and self.chunk is None:
            raise ValueError(
                "enable_prefix_cache requires chunk_prefill_tokens: "
                "chunk-grid-aligned recompute is what makes reused and "
                "freshly computed K/V bit-identical")
        self.prefix_caching = bool(enable_prefix_cache)
        self.prefix_cache: Dict[bytes, tuple] = {}   # key -> block ids
        self._prefix_rev: Dict[int, set] = {}        # block -> keys
        # bumped on every prefix-cache mutation (register, evict,
        # restore) so a poller can skip an unchanged digest set; never
        # reset for the engine's lifetime, not even by hard_reset()
        self.prefix_generation = 0
        self.block_refs: Dict[int, int] = {}         # live owner count
        self.cached_free: Dict[int, None] = {}       # LRU, insertion order
        # the host-RAM spill tier: a KVSpillArena attached by its owner
        # (the gateway) through attach_spill(); it outlives the engine
        self._spill = None
        # --- the device-resident tick ---------------------------------
        # fused_tick=True keeps the tick's state on the device, advanced
        # in place by one program per tick; the host re-sends a row only
        # on a slot transition. fused_tick=False is the per-tick host
        # path, the reference the fused streams must match bit for bit.
        self._fused = bool(fused_tick)
        self._dev_live = False          # device state built at least once
        self._dev_dirty = True          # host mirrors changed since build
        self._dev_keys_dirty = False    # device keys advanced since sync
        self._key_overrides: set = set()  # rows host re-keyed (authoritative)
        # K ticks in one program where no stream can tell (_scan_ticks)
        self._ticks_per_dispatch = max(1, int(ticks_per_dispatch))
        # speculative ticks: k drafts a row, verified in one forward
        self._spec_k = int(spec_tokens)
        self._spec_ngram = int(spec_ngram)
        if self._spec_k:
            if self._spec_k < 1:
                raise ValueError("spec_tokens must be >= 0")
            if self._spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            if not self._fused:
                raise ValueError(
                    "spec_tokens requires fused_tick=True: the "
                    "proposer/verify/commit live inside the fused "
                    "device program")
            if self.device.type == "cuda":
                _check_verify_shapes(model.config, self._spec_k + 1)
        # ring mode: the tick appends its tokens to a device ring, drained
        # one step behind; off, each tick's tokens are read back at once
        self._ring = self._fused if ring_mode is None else bool(ring_mode)
        if self._ring and not self._fused:
            raise ValueError(
                "ring_mode requires fused_tick=True: the ring is "
                "carried in the fused tick's device state")
        maxadv = max(self._ticks_per_dispatch, self._spec_k + 1)
        self._ring_len = max(16, 2 * maxadv) if ring_len is None \
            else max(int(ring_len), 2 * maxadv)
        self._pending: Optional[Dict[str, Any]] = None  # outstanding tick
        self._drained = np.zeros((self.R,), np.int64)   # consumed cursors
        # delta transitions: a transition sends one row's descriptor, not
        # a rebuild of the whole state (the reference mode when off)
        self._delta = self._fused if delta_transitions is None \
            else bool(delta_transitions)
        if self._delta and not self._fused:
            raise ValueError(
                "delta_transitions requires fused_tick=True: patches "
                "edit the fused tick's device-resident state")
        self._delta_rows: set = set()   # slots awaiting a patch flush
        # descriptor (int32; floats and key words as raw bits): [0]=row
        # [1]=lens [2]=last [3]=eos [4]=rem [5]=active [6]=key_override
        # [7]=temp [8]=top_k [9]=top_p [10]=rep [11:13]=key (seed,
        # counter) [13]=spec EMA [14]=spec tick counter (always 0)
        # [15:15+M]=block-table row [15+M:]=committed-token row (spec)
        self._desc_len = 15 + self.M + (
            self.M * self.B + self._spec_k + 1 if self._spec_k else 0)
        # the fused patch queue: descriptors staged into a device queue
        # by one upload and applied by the next tick's program; off, each
        # descriptor is one eager patch, one dispatch
        self._fuse_patches = self._delta if patch_fuse is None \
            else bool(patch_fuse)
        if self._fuse_patches and not self._delta:
            raise ValueError(
                "patch_fuse requires delta_transitions=True: the fused "
                "queue stages the delta path's descriptors")
        self._pq_len = self.R if patch_queue_len is None \
            else max(1, int(patch_queue_len))
        # the tick programs, keyed by (greedy, K or "spec", route): a
        # CapturedStep each, captured on first use into the cache's one
        # shared pool, all dropped when the weights move
        self._graphs = ExecCache(self.model)
        # the cross-rank schedule check, made at tp > 1 only
        self._tp = axis_degree("tp")
        self.rank_check = self._tp > 1
        self._host_tp = get_mesh().host_group("tp") if self.rank_check \
            else None
        _check_pageable(model)
        self._new_pools()
        self.slots: List[Optional[_Request]] = [None] * self.R
        self.queue: List[_Request] = []
        self.results: Dict[Any, List[int]] = {}
        self.logprobs: Dict[Any, List[float]] = {}
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self.cancelled: Dict[Any, str] = {}
        self._admit_counter = 0
        self._submit_counter = 0
        self._obs_labels = {"engine": f"paged{next(_engine_ids)}"}
        reg = obs.registry()
        self._counters = {
            k: reg.counter(f"paged_{k}_total", **self._obs_labels)
            for k in ("decode_steps", "prefills", "preemptions",
                      "prefill_chunks", "slot_steps",
                      "active_slot_steps", "prefix_hit_tokens",
                      "prefix_adopted_blocks", "timeouts",
                      "cancellations", "rejected", "spec_proposed",
                      "spec_accepted", "full_rebuilds",
                      "delta_patches", "h2d_upload_bytes", "dispatches",
                      "patches_fused", "patch_queue_overflows",
                      "ring_cursor_rollovers", "spill_spans",
                      "spill_restores", "spill_restored_tokens",
                      "spill_restore_failures")}
        self._h_decode = reg.histogram("paged_decode_step_ms",
                                       buckets=obs.SERVING_MS_BUCKETS,
                                       **self._obs_labels)
        self._h_wait = reg.histogram("paged_queue_wait_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **self._obs_labels)
        self._h_tpf = reg.histogram("paged_tokens_per_forward",
                                    **self._obs_labels)
        self._h_bytes = reg.histogram("paged_h2d_bytes",
                                      buckets=obs.BYTES_BUCKETS,
                                      **self._obs_labels)
        # request-scoped tracing hook: a callable ``(request_id, kind,
        # **fields)`` the engine reports each request's lifecycle to
        # (queue enter, slot take, prefill chunks, ticks, preemption,
        # finish/abort). None keeps the engine trace-free.
        self.trace_sink = None
        # the one-dispatch-per-tick contract: engine programs (prefills,
        # chunks, ticks, standalone patches; on a card a tick is one
        # graph replay) and host-to-device uploads with their bytes
        self.dispatch_count = 0
        self.h2d_uploads = 0
        self.h2d_upload_bytes = 0
        self.full_rebuilds = 0
        self.delta_patches = 0
        self.patches_fused = 0
        self.patch_queue_overflows = 0
        self.ring_cursor_rollovers = 0
        # readbacks: d2h_syncs counts the blocking ones (one per sync-mode
        # tick; in ring mode the drains that had to wait), ring_drains
        # every ring consumption, ring_scoped_drains the one-row drains
        # of cancel and expiry
        self.d2h_syncs = 0
        self.ring_drains = 0
        self.ring_blocking_drains = 0
        self.ring_scoped_drains = 0
        # the tick-phase profiler: off costs one None check a bracket
        self.tick_profile = bool(tick_profile)
        self._prof: Optional[_TickPhaseProfile] = None
        if self.tick_profile:
            self._prof = _TickPhaseProfile(
                self._obs_labels, clock=profile_clock,
                capacity=profile_ring_len)
            # obs.reset() (the gateway's SIGTERM path) leaves
            # tickphase_<engine>.json in the run dir
            obs.register_flusher(self._flush_tick_profile)

    # ------------------------------------------------------ tick profiler
    @property
    def tick_phase_totals(self) -> Optional[Dict[str, float]]:
        """Cumulative per-phase milliseconds (None with the profiler
        off)."""
        return dict(self._prof.totals) if self._prof is not None \
            else None

    @property
    def tick_wall_ms_total(self) -> float:
        """Cumulative measured tick wall (ms; 0 with the profiler off):
        ``sum(tick_phase_totals.values())`` up to per-tick clamping."""
        return self._prof.wall_total_ms if self._prof is not None \
            else 0.0

    def tick_profile_doc(self) -> Optional[Dict[str, Any]]:
        """The ``tickphase/1`` ring document (None, profiler off)."""
        if self._prof is None:
            return None
        return self._prof.to_doc(self._obs_labels["engine"])

    def dump_tick_profile(self, path: str) -> Optional[str]:
        """Atomic JSON dump of the tick-phase ring (the gateway writes
        one per replica on drain and on a ``/profilez`` capture). No-op
        with the profiler off."""
        doc = self.tick_profile_doc()
        if doc is None:
            return None
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def _flush_tick_profile(self) -> Optional[str]:
        """The reset()-time flush into the configured run dir."""
        d = obs.run_dir()
        if d is None or self._prof is None:
            return None
        try:
            return self.dump_tick_profile(os.path.join(
                d, f"tickphase_{self._obs_labels['engine']}.json"))
        except Exception:
            return None

    def _tick_phase_fields(self) -> Optional[Dict[str, float]]:
        """The phase split attached to tick trace events (the last
        completed tick's: ring drains commit one dispatch behind)."""
        return self._prof.last_phases() if self._prof is not None \
            else None

    def _clock(self):
        """The profiler's clock, or None with the profiler off."""
        return self._prof.clock() if self._prof is not None else None

    def _phase(self, phase: str, t0) -> None:
        """Add the time since ``t0`` (a ``_clock()`` reading) to
        ``phase``; no-op with the profiler off."""
        if self._prof is not None:
            self._prof.add(phase, (self._prof.clock() - t0) * 1e3)

    def _wait_device(self):
        """Profile-on only, before a blocking read: wait for the engine's
        stream, so the wait counts as device time and the read as drain
        (the read would wait for the same work)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _new_pools(self):
        """Fresh pools, host mirrors, seen masks and device tick state
        (construction and ``hard_reset``)."""
        cfg = self.model.config
        shape = (self.P, self.B, local_heads(cfg)[1], cfg.head_dim)
        self.pools = [(torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device),
                       torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device))
                      for _ in range(cfg.num_hidden_layers)]
        # block 0 is the garbage block: pad and idle-row writes land there
        self.free_blocks = list(range(1, self.P))
        self.block_tables = np.zeros((self.R, self.M), np.int32)
        self.seq_lens = np.zeros((self.R,), np.int32)
        # per-row sampling params (inactive rows: greedy, key unused)
        self.temps = np.zeros((self.R,), np.float32)
        self.top_ks = np.zeros((self.R,), np.int32)
        self.top_ps = np.ones((self.R,), np.float32)
        self.reps = np.ones((self.R,), np.float32)
        self.keys = np.zeros((self.R, 2), np.uint32)
        # per-row seen-token masks for the repetition penalty
        self.seen = torch.zeros((self.R, cfg.vocab_size), dtype=torch.bool,
                                device=self.device)
        self._rows = torch.arange(self.R, device=self.device)
        if self._fused:
            self._new_state()

    def _new_state(self):
        """The device tick state: one fixed set of tensors the tick
        programs read and write in place (a captured graph reads fixed
        addresses), the JAX package's dtypes except the keys (int64 rows
        of uint32 words), plus the static outputs of a dispatch and the
        pinned host buffers of its transfers."""
        R, M, dev = self.R, self.M, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        Q, D = self._pq_len, self._desc_len
        # pq and pqn share one buffer: a flush is one upload
        self._pqbuf = torch.zeros(Q * D + 1, **i32)
        self._st = dict(
            tables=torch.zeros((R, M), **i32), lens=torch.zeros(R, **i32),
            last=torch.zeros(R, **i32),
            keys=torch.zeros((R, 2), dtype=torch.int64, device=dev),
            temps=torch.zeros(R, **f32), tks=torch.zeros(R, **i32),
            tps=torch.ones(R, **f32), reps=torch.ones(R, **f32),
            eos=torch.full((R,), -1, **i32), rem=torch.zeros(R, **i32),
            active=torch.zeros(R, dtype=torch.bool, device=dev),
            ring=torch.zeros((R, self._ring_len), **i32),
            rlps=torch.zeros((R, self._ring_len), **f32),
            wcur=torch.zeros(R, **i32),
            pq=self._pqbuf[:Q * D].view(Q, D), pqn=self._pqbuf[Q * D:])
        K = self._ticks_per_dispatch
        self._out_nxt = torch.zeros((K, R), dtype=torch.int64, device=dev)
        self._out_lps = torch.zeros((K, R), **f32)
        self._out_done = torch.zeros((K, R), dtype=torch.bool, device=dev)
        ring_keys = ("ring", "rlps", "wcur", "active")
        if self._spec_k:
            # the committed-stream buffer the proposer matches over (the
            # +k+1 tail takes the tick's candidate writes), the accept
            # EMA, the probe counter, and the last dispatch's drafted and
            # accepted counts (read by the ring's drain)
            T = self._spec_k + 1
            self._st.update(
                toks=torch.zeros((R, M * self.B + T), **i32),
                ema=torch.ones(R, **f32), tickc=torch.zeros(R, **i32))
            if self._ring:
                self._st.update(kprop_last=torch.zeros(R, **i32),
                                macc_last=torch.zeros(R, **i32))
                ring_keys += ("kprop_last", "macc_last")
            # sync mode's readback: candidates, logprobs, emitted count,
            # drafted, accepted, done
            self._out_spec = dict(
                G=torch.zeros((R, T), dtype=torch.int64, device=dev),
                LP=torch.zeros((R, T), **f32), n=torch.zeros(R, **i32),
                kprop=torch.zeros(R, **i32), macc=torch.zeros(R, **i32),
                done=torch.zeros(R, dtype=torch.bool, device=dev))
        # pinned host buffers: the staged patch queue (reused only after
        # the event of the copy that read it) and the ring's copy
        pin = dev.type == "cuda"
        self._pq_host = torch.zeros(Q * D + 1, dtype=torch.int32,
                                    pin_memory=pin)
        self._pq_event = None
        self._ring_host = {
            k: torch.zeros(self._st[k].shape, dtype=self._st[k].dtype,
                           pin_memory=pin)
            for k in ring_keys}
        self._ring_event = None
        self._graphs.clear()

    @property
    def stats(self) -> Dict[str, int]:
        """Scheduler-counter snapshot (values from the registry)."""
        return {k: int(c.value) for k, c in self._counters.items()}

    def _count(self, key: str, n: int = 1):
        self._counters[key].inc(n)

    # ------------------------------------------------------------ device
    def _caches(self, tables, lens):
        return [PagedKV(kp, vp, tables, lens) for kp, vp in self.pools]

    def _dev(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _up(self, x):
        """Host-mirror upload on the per-tick path, counted (events and
        bytes) as the JAX package counts its host path's uploads."""
        self.h2d_uploads += 1
        self.h2d_upload_bytes += x.nbytes
        self._count("h2d_upload_bytes", x.nbytes)
        self._h_bytes.observe(x.nbytes)
        tp = self._clock()
        out = torch.as_tensor(x, device=self.device)
        self._phase("h2d", tp)
        return out

    def _decode_core(self, tables, lens, last_tokens, reps, active,
                     sampling=None):
        """One decode tick's model and sampling, shared by the host tick
        and the fused tick programs: the model over every row, the
        repetition penalty, then the argmax (``sampling`` None: the
        all-greedy tick, keys untouched) or per-row sampling with
        ``sampling = (keys, temps, top_ks, top_ps)``. The chosen token
        enters the seen masks of active rows only: inactive rows (idle or
        mid-chunk-prefill) sample garbage. Returns (tokens, logprobs, new
        keys or None)."""
        logits, _ = self.model(last_tokens[:, None],
                               kv_caches=self._caches(tables, lens),
                               positions=lens[:, None])
        raw = repetition_penalty_rows(logits[:, -1].float(), self.seen,
                                      reps)
        nxt, lps, new_keys = _choose_tokens(raw, sampling)
        self.seen[self._rows, nxt] |= active
        return nxt, lps, new_keys

    # ---------------------------------------------- the device tick state
    def _mark_dirty(self, slot_id: int):
        """A slot transition touched ``slot_id``'s mirrors. Delta mode
        queues a one-row patch (flushed just before the next dispatch;
        several transitions of one slot coalesce into its final state);
        rebuild mode (or no device state yet) marks the whole state for
        ``_refresh_dev``."""
        if self._delta and self._dev_live and not self._dev_dirty:
            self._delta_rows.add(slot_id)
        else:
            self._dev_dirty = True

    @staticmethod
    def _slot_row_fields(s):
        """The (last, eos, rem, active) scalars one slot contributes to the
        device state, shared by the full rebuild and the descriptor so the
        two upload paths cannot drift apart."""
        eos = -1
        rem = last = act = 0
        if s is not None:
            if s.eos is not None:
                eos = s.eos
            rem = max(s.max_new - len(s.tokens), 0)
            if s.tokens and s.prefill_pos >= len(s.prompt):
                act = 1
                last = s.tokens[-1]
        return last, eos, rem, act

    def _pack_descriptor(self, i: int) -> np.ndarray:
        """Slot ``i``'s current host-mirror state as one int32 descriptor
        (floats and the key words as raw bits), field by field what a
        full rebuild would upload for the row. The key is flagged
        authoritative only for rows the host re-keyed (fresh admits,
        chunk-final); for every other row the device key, perhaps
        advanced by sampled ticks since the last upload, survives."""
        s = self.slots[i]
        d = np.zeros((self._desc_len,), np.int32)
        d[0] = i
        d[1] = self.seq_lens[i]
        d[2], d[3], d[4], d[5] = self._slot_row_fields(s)
        d[6] = 1 if i in self._key_overrides else 0
        d[7] = np.float32(self.temps[i]).view(np.int32)
        d[8] = self.top_ks[i]
        d[9] = np.float32(self.top_ps[i]).view(np.int32)
        d[10] = np.float32(self.reps[i]).view(np.int32)
        d[11:13] = self.keys[i].view(np.int32)
        d[15:15 + self.M] = self.block_tables[i]
        if self._spec_k:
            # d[14], the probe counter, stays 0: a patched row's probe
            # cadence restarts, as a rebuild restarts it
            d[13] = np.float32(s.spec_ema if s is not None
                               else 1.0).view(np.int32)
            d[15 + self.M:] = token_buffer_row(
                s.prompt + s.tokens if s is not None else (),
                self._desc_len - 15 - self.M)
        return d

    def _apply_descriptors(self, pq, valid):
        """Write the descriptors ``pq`` [Q, D] whose ``valid`` flag is set
        into the device state, in place: a masked scatter, every field as
        the descriptor layout says and the key by ``override_key_rows``.
        Invalid entries touch nothing, so an all-invalid queue leaves the
        state bit for bit. Valid rows are distinct (the host coalesces
        per slot), so order does not matter."""
        st, R, M = self._st, self.R, self.M
        rows = torch.where(valid, pq[:, 0].long(), R)
        hit = rows[:, None] == self._rows[None, :]               # [Q, R]
        take = hit.any(dim=0)
        src = (hit.long() * torch.arange(
            pq.shape[0], device=pq.device)[:, None]).sum(dim=0)
        d = pq[src]                             # each row's descriptor

        def put(name, vals):
            t = st[name]
            mask = take.view(-1, *([1] * (t.dim() - 1)))
            t.copy_(torch.where(mask, vals.to(t.dtype), t))

        def f32(col):
            return d[:, col].contiguous().view(torch.float32)

        put("tables", d[:, 15:15 + M])
        put("lens", d[:, 1])
        put("last", d[:, 2])
        put("eos", d[:, 3])
        put("rem", d[:, 4])
        put("active", d[:, 5] != 0)
        put("temps", f32(7))
        put("tks", d[:, 8])
        put("tps", f32(9))
        put("reps", f32(10))
        if self._spec_k:
            put("toks", d[:, 15 + M:])
            put("ema", f32(13))
            put("tickc", d[:, 14])
        st["keys"].copy_(override_key_rows(
            st["keys"], pq[:, 0], pq[:, 11:13].long(),
            valid & (pq[:, 6] != 0)))

    @torch.inference_mode()
    def _apply_patch(self, desc: np.ndarray):
        """The standalone patch of one descriptor, run eagerly (one
        dispatch): the queue-overflow fallback and the ``patch_fuse=False``
        path. The ring arrays and cursors stay as they are: a row a
        transition patches was drained first, so a readmitted slot
        continues the ring where its previous tenant stopped."""
        pq = torch.as_tensor(desc[None], device=self.device)
        self._apply_descriptors(
            pq, torch.ones(1, dtype=torch.bool, device=self.device))

    def _apply_patch_queue(self):
        """The fused patch stage that opens every tick program: applies
        the staged descriptors (queue entries below ``pqn``) and zeroes
        ``pqn``, so a transition wave of up to Q rows costs no dispatch
        of its own."""
        st = self._st
        Q = st["pq"].shape[0]
        valid = torch.arange(Q, device=self.device) < st["pqn"]
        self._apply_descriptors(st["pq"], valid)
        st["pqn"].zero_()

    def _flush_patches(self):
        """Hand every pending transition to the device, just before a
        dispatch and after the step's drain.

        With the fused queue the coalesced descriptors are staged into a
        pinned buffer and copied into ``pq``/``pqn`` with one
        non-blocking upload (no dispatch); the tick program that follows
        applies them. More rows than the queue holds (only with a
        ``patch_queue_len`` below R) take the standalone patch, one
        dispatch each, as does every descriptor with ``patch_fuse=False``.
        The ring cursors are int32 on the device: long before they could
        wrap, one full rebuild zeroes them."""
        if self._ring and int(self._drained.max(initial=0)) > 2 ** 30:
            self.ring_cursor_rollovers += 1
            self._count("ring_cursor_rollovers")
            self._refresh_dev()
            return
        rows = sorted(self._delta_rows)
        if self._fuse_patches and len(rows) <= self._pq_len:
            if self._pq_event is not None:
                self._pq_event.synchronize()    # the last copy read it
            host = self._pq_host.numpy()
            host[:] = 0
            pq = host[:-1].reshape(self._pq_len, self._desc_len)
            for j, i in enumerate(rows):
                pq[j] = self._pack_descriptor(i)
                self._key_overrides.discard(i)
            host[-1] = len(rows)
            tp = self._clock()
            self._pqbuf.copy_(self._pq_host, non_blocking=True)
            self._pq_event = self._record_event()
            self._phase("h2d", tp)
            nbytes = pq.nbytes + 4
            self.h2d_uploads += 1
            self.h2d_upload_bytes += nbytes
            self.patches_fused += len(rows)
            self._count("patches_fused", len(rows))
            self._count("h2d_upload_bytes", nbytes)
            self._h_bytes.observe(nbytes)
            self._delta_rows.clear()
            return
        if self._fuse_patches:
            self.patch_queue_overflows += 1
            self._count("patch_queue_overflows")
        for i in rows:
            desc = self._pack_descriptor(i)
            self.h2d_uploads += 1
            self.h2d_upload_bytes += desc.nbytes
            self.delta_patches += 1
            self.dispatch_count += 1
            self._count("dispatches")
            self._count("delta_patches")
            self._count("h2d_upload_bytes", desc.nbytes)
            self._h_bytes.observe(desc.nbytes)
            self._apply_patch(desc)
            # the device now holds the row's authoritative key
            self._key_overrides.discard(i)
        self._delta_rows.clear()

    def _record_event(self):
        """A CUDA event on the current stream (None on the CPU, where
        every copy has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _sync_dev(self):
        """Bring the device state up to date before a dispatch: a full
        rebuild when forced (first dispatch, ``hard_reset``,
        ``delta_transitions=False``), else flush the pending patches."""
        if not self._dev_live or self._dev_dirty:
            self._refresh_dev()
        elif self._delta_rows:
            self._flush_patches()

    def _sync_keys_from_dev(self):
        """Fold the device keys back into the host mirror, except for rows
        the host re-keyed since the last upload (their host key is the
        authority until it is uploaded)."""
        if not self._dev_live or not self._dev_keys_dirty:
            return
        dk = self._st["keys"].cpu().numpy().astype(np.uint32)
        for r in range(self.R):
            if r not in self._key_overrides:
                self.keys[r] = dk[r]
        self._dev_keys_dirty = False

    @torch.inference_mode()
    def _refresh_dev(self):
        """Full rebuild of the device state from the host mirrors, written
        into the fixed tensors with ``copy_``: on every transition with
        ``delta_transitions=False``; otherwise only when forced (first
        dispatch, ``hard_reset``, the ring-cursor guard). Its bytes are
        counted as the JAX package counts them."""
        self._sync_keys_from_dev()
        self._key_overrides.clear()
        eos = np.full((self.R,), -1, np.int32)
        rem = np.zeros((self.R,), np.int32)
        last = np.zeros((self.R,), np.int32)
        act = np.zeros((self.R,), bool)
        for i, s in enumerate(self.slots):
            last[i], eos[i], rem[i], a = self._slot_row_fields(s)
            act[i] = bool(a)
        self.h2d_uploads += 1
        self.full_rebuilds += 1
        self._count("full_rebuilds")
        nbytes = (self.block_tables.nbytes + self.seq_lens.nbytes
                  + last.nbytes + self.keys.nbytes + self.temps.nbytes
                  + self.top_ks.nbytes + self.top_ps.nbytes
                  + self.reps.nbytes + eos.nbytes + rem.nbytes
                  + act.nbytes)
        st = self._st
        tp = self._clock()
        for name, arr in (("tables", self.block_tables),
                          ("lens", self.seq_lens), ("last", last),
                          ("keys", self.keys.astype(np.int64)),
                          ("temps", self.temps), ("tks", self.top_ks),
                          ("tps", self.top_ps), ("reps", self.reps),
                          ("eos", eos), ("rem", rem), ("active", act)):
            st[name].copy_(torch.from_numpy(arr))
        if self._spec_k:
            # each row's prompt and emitted tokens, its accept EMA, and
            # the probe counters restarted
            tk = np.zeros(tuple(st["toks"].shape), np.int32)
            ema = np.ones((self.R,), np.float32)
            for i, s in enumerate(self.slots):
                if s is not None:
                    tk[i] = token_buffer_row(s.prompt + s.tokens,
                                             tk.shape[1])
                    ema[i] = s.spec_ema
            nbytes += tk.nbytes + ema.nbytes
            st["toks"].copy_(torch.from_numpy(tk))
            st["ema"].copy_(torch.from_numpy(ema))
            st["tickc"].zero_()
            if self._ring:
                st["kprop_last"].zero_()
                st["macc_last"].zero_()
        # a rebuild runs with the ring drained (every transition drains
        # first), so zeroing the cursors loses no entry; an empty queue
        st["ring"].zero_()
        st["rlps"].zero_()
        st["wcur"].zero_()
        self._drained[:] = 0
        self._pqbuf.zero_()
        self._phase("h2d", tp)
        self.h2d_upload_bytes += nbytes
        self._count("h2d_upload_bytes", nbytes)
        self._h_bytes.observe(nbytes)
        self._delta_rows.clear()
        self._dev_dirty = False
        self._dev_live = True

    # ------------------------------------------------ the tick programs
    def _tick(self, greedy: bool, k: int):
        """One fused tick on the device state, in place: the staged
        patches (first tick of a dispatch), the model over every row, the
        penalty and the token (the host tick's ``_decode_core``), then
        the bookkeeping: active rows advance their length, last token and
        budget, done = eos hit or budget spent, done rows deactivate, and
        the token goes to the row's ring slot. Writes (token, logprob,
        done) to row ``k`` of the dispatch's outputs."""
        st = self._st
        if k == 0:
            self._apply_patch_queue()
        act = st["active"].clone()
        sampling = None if greedy else (st["keys"], st["temps"], st["tks"],
                                        st["tps"])
        nxt, lps, new_keys = self._decode_core(
            st["tables"], st["lens"], st["last"], st["reps"], act, sampling)
        acti = act.to(torch.int32)
        rem = st["rem"] - acti
        done = act & (((st["eos"] >= 0) & (nxt == st["eos"])) | (rem <= 0))
        st["lens"].add_(acti)
        st["last"].copy_(torch.where(act, nxt.to(torch.int32), st["last"]))
        if new_keys is not None:
            st["keys"].copy_(new_keys)
        st["rem"].copy_(rem)
        st["active"].copy_(act & ~done)
        if self._ring:
            r, idx = self._rows, (st["wcur"] % self._ring_len).long()
            ring, rlps = st["ring"], st["rlps"]
            ring[r, idx] = torch.where(act, nxt.to(torch.int32), ring[r, idx])
            rlps[r, idx] = torch.where(act, lps, rlps[r, idx])
            st["wcur"].add_(acti)
        self._out_nxt[k].copy_(nxt)
        self._out_lps[k].copy_(lps)
        self._out_done[k].copy_(done)

    def _tick_spec(self, greedy: bool):
        """One speculative tick on the device state, in place (the JAX
        package's ``_fused_tick_spec``): the staged patches; each row's
        draft cap ``kprop`` (the adaptive want, capped by the write
        headroom read off its table, where unallocated entries are the
        garbage block 0, and by its budget); the prompt-lookup drafts;
        one model call over [last, drafts] (the ragged kernel at T = k+1,
        once a layer); the accept scan over the k+1 positions, unrolled;
        then the commit of lengths, last tokens, budgets, the active
        mask, the committed-stream buffer, the EMA, the probe counters,
        the keys and the ring window.

        Position j of the scan penalises its logits over ``seen`` as of
        j (the window's earlier emitted tokens included), draws its
        token as the plain tick would with the row's key advanced by j,
        and accepts the draft iff the token equals it. A row emits at j
        while it is alive: alive past j only if it accepted a real draft
        there and neither eos nor its budget ended it, so the first
        rejection's token is the correction and position k's the bonus.
        The K/V of rejected drafts sits past the committed length (past
        the row's allocated blocks it lands in the garbage block) and is
        overwritten before it becomes readable."""
        st, R = self._st, self.R
        self._apply_patch_queue()
        k = self._spec_k
        T = k + 1
        lens, rem, tables, keys = st["lens"], st["rem"], st["tables"], \
            st["keys"]
        active = st["active"].clone()
        C = lens + 1                    # committed tokens of active rows
        capw = (tables > 0).sum(dim=1).to(torch.int32) * self.B - lens
        probe = (st["tickc"] % _SPEC_PROBE_EVERY) == 0
        zero = torch.zeros_like(lens)
        want = torch.where(st["ema"] >= _SPEC_EMA_FLOOR, zero + k,
                           torch.where(probe, zero + 1, zero))
        kprop = torch.where(active, torch.minimum(
            torch.minimum(want, capw - 1), rem - 1).clamp(0, k), zero)
        drafts = mask_drafts(propose_ngram_rows(
            st["toks"], C, k, self._spec_ngram, fill=-1), kprop)
        ids = torch.cat([st["last"][:, None], drafts.clamp_min(0)], dim=1)
        positions = lens[:, None] + torch.arange(T, device=self.device)
        logits, _ = self.model(ids.long(),
                               kv_caches=self._caches(tables, lens),
                               positions=positions, paged_decode=True)
        logits = logits.float()
        drafts_ext = torch.cat([drafts, torch.full_like(drafts[:, :1], -1)],
                               dim=1)
        alive = active.clone()
        nem = torch.zeros_like(lens)
        macc = torch.zeros_like(lens)
        eos_hit = torch.zeros_like(active)
        is_eos_ok = st["eos"] >= 0
        toks, lps = [], []
        for j in range(T):
            raw = repetition_penalty_rows(logits[:, j], self.seen,
                                          st["reps"])
            # the token the plain tick would draw here (key advanced by
            # j); the draft is accepted iff it equals it (the one-hot
            # residual rule, sampling.residual_resample_rows)
            tok, lp, _ = _choose_tokens(raw, None if greedy else (
                fold_in_rows(keys, j), st["temps"], st["tks"], st["tps"]))
            d_j = drafts_ext[:, j]
            acc = (d_j >= 0) & (tok == d_j)
            emit = alive
            self.seen[self._rows, tok] |= emit
            nem = nem + emit.to(torch.int32)
            macc = macc + (emit & acc).to(torch.int32)
            is_eos = is_eos_ok & (tok == st["eos"])
            eos_hit = eos_hit | (emit & is_eos)
            alive = emit & acc & ~is_eos & (nem < rem)
            toks.append(tok)
            lps.append(lp)
        G = torch.stack(toks, dim=1)                            # [R, T]
        LP = torch.stack(lps, dim=1)
        n_eff = torch.where(active, nem, zero)
        done = active & (eos_hit | (rem - n_eff <= 0))
        # the buffer takes all T candidates: those past n_eff sit beyond
        # the committed count, never match, and are overwritten next tick
        # (C + k <= M * B + k, the buffer's last index, for every row)
        buf = st["toks"]
        cols = (C[:, None] + torch.arange(T, device=self.device)).long()
        buf.scatter_(1, cols.clamp(max=buf.shape[1] - 1), G.to(torch.int32))
        last = G.gather(1, (n_eff - 1).clamp_min(0).long()[:, None])[:, 0]
        ema = torch.where(
            kprop > 0,
            (1.0 - _SPEC_EMA_ALPHA) * st["ema"] + _SPEC_EMA_ALPHA
            * (macc.float() / kprop.float().clamp_min(1.0)), st["ema"])
        st["lens"].add_(n_eff)
        st["last"].copy_(torch.where(active, last.to(torch.int32),
                                     st["last"]))
        st["rem"].sub_(n_eff)
        st["active"].copy_(active & ~done)
        st["ema"].copy_(ema)
        st["tickc"].add_(active.to(torch.int32))
        if not greedy:
            keys.copy_(fold_in_rows(keys, n_eff))   # one per emitted token
        if self._ring:
            # the emitted window goes to ring entries wcur .. wcur+n_eff-1;
            # T <= ring_len / 2, so a row's window never wraps onto itself
            r = self._rows[:, None]
            idx = ((st["wcur"][:, None] + torch.arange(
                T, device=self.device)) % self._ring_len).long()
            win = torch.arange(T, device=self.device)[None, :] < \
                n_eff[:, None]
            ring, rlps = st["ring"], st["rlps"]
            ring[r, idx] = torch.where(win, G.to(torch.int32), ring[r, idx])
            rlps[r, idx] = torch.where(win, LP, rlps[r, idx])
            st["wcur"].add_(n_eff)
            st["kprop_last"].copy_(kprop)
            st["macc_last"].copy_(macc)
        out = self._out_spec
        for name, val in (("G", G), ("LP", LP), ("n", n_eff),
                          ("kprop", kprop), ("macc", macc), ("done", done)):
            out[name].copy_(val)

    @torch.inference_mode()
    def _program(self, greedy: bool, K: int, spec: bool = False):
        """One dispatch's program: the speculative tick, or K ticks in a
        row (the scan ticks when K > 1; each is the K=1 program's tick, so
        the stream is that of K single dispatches)."""
        if spec:
            self._tick_spec(greedy)
            return
        for k in range(K):
            self._tick(greedy, k)

    def _dispatch(self, greedy: bool, K: int, spec: bool = False):
        """Run one dispatch: eagerly on the CPU; on a card, through the
        program's :class:`graphs.CapturedStep` (its first call runs the
        program and captures it, holding ``card_lock`` alone with the
        warm-up on a side stream; later calls replay the graph and add
        the launches its capture counted). A graph freezes the weights'
        addresses and the route it read: the key holds the route, and
        the cache drops every graph when the weights move."""
        if self.device.type != "cuda":
            self._program(greedy, K, spec)
            return
        key = (greedy, "spec" if spec else K,
               os.environ.get("PADDLE_TPU_PAGED_ATTN", "ragged"))
        self._graphs.get(key, lambda: CapturedStep(
            self._program, self.device, pool=self._graphs.shared_pool(),
            args=(greedy, K, spec)))()

    @property
    def graph_pool_bytes(self) -> int:
        """Device memory the tick programs' captures reserved, summed."""
        return self._graphs.graph_pool_bytes()

    def _sample_one(self, logits_row, seen_row, req):
        """The chosen token at a prefill's last live position."""
        row = repetition_penalty_rows(
            logits_row[None].float(), seen_row[None],
            self._dev([req.rep], torch.float32))
        return sample_token_rows(
            row, self._dev(req.key[None].astype(np.int64)),
            self._dev([req.temperature], torch.float32),
            self._dev([req.top_k], torch.int32),
            self._dev([req.top_p], torch.float32))

    @torch.inference_mode()
    def _prefill(self, table_row, ids, length, req, bucket: int):
        tables = self._dev(table_row[None], torch.int32)
        lens = self._dev([length], torch.int32)
        positions = torch.arange(bucket, device=self.device)[None, :]
        logits, _ = self.model(ids, kv_caches=self._caches(tables, lens),
                               positions=positions)
        # seen mask seeded from the live prompt region (pads excluded)
        seen_row = torch.zeros(logits.shape[-1], dtype=torch.bool,
                               device=self.device)
        seen_row[ids[0, :length]] = True
        nxt, lps, new_key = self._sample_one(logits[0, length - 1], seen_row,
                                             req)
        seen_row[nxt[0]] = True
        return nxt[0], lps[0], new_key[0], seen_row

    @torch.inference_mode()
    def _chunk_prefill(self, table_row, ids, start, total_len, req,
                       seen_row, bucket: int):
        """One prompt chunk at global positions [start, start+bucket):
        writes its K/V (live = positions < total_len) and attends to the
        cached chunks. The sample at the last live position is computed
        every chunk; the host keeps it, and the advanced key, only for the
        final chunk, so a request still advances its counter once per
        emitted token. Returns (token, logprob, key, seen without the
        sample, seen with it)."""
        tables = self._dev(table_row[None], torch.int32)
        lens = self._dev([total_len], torch.int32)
        positions = start + torch.arange(bucket, device=self.device)[None, :]
        logits, _ = self.model(ids, kv_caches=self._caches(tables, lens),
                               positions=positions, paged_chunk=True)
        seen_row = seen_row.clone()
        seen_row[ids[0, :total_len - start]] = True
        nxt, lps, new_key = self._sample_one(
            logits[0, total_len - start - 1], seen_row, req)
        seen_out = seen_row.clone()
        seen_out[nxt[0]] = True
        return nxt[0], lps[0], new_key[0], seen_row, seen_out

    # ------------------------------------------------------------- host
    @_card_work
    def submit(self, request_id, input_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               stop_sequences=None, repetition_penalty: float = 1.0,
               timeout_s: Optional[float] = None,
               resume_tokens=None, resume_lps=None):
        """temperature <= 0 keeps the exact greedy path; a sampled request
        gets its own key stream seeded by ``seed`` (default: a per-engine
        submission counter), so its tokens do not depend on what else
        shares the batch.

        ``stop_sequences``: token-id sequences that end the request the
        moment the generated stream ends with one; the match is trimmed
        from the returned tokens. With ``max_queue`` set, a submit past
        capacity raises BackpressureError. ``timeout_s`` (default: the
        engine's ``default_timeout_s``) caps the request's lifetime; an
        expired request is aborted at the next tick and recorded in
        ``self.cancelled`` as "timeout".

        ``resume_tokens``: tokens this request already emitted elsewhere,
        which must form the tail of ``input_ids`` (the preemption fold);
        ``results`` returns them followed by the continuation.
        ``resume_lps`` carries their logprobs. ``max_new_tokens`` counts
        only the tokens still to emit."""
        if self.max_queue is not None:
            # reap expired queued requests first: capacity held by dead
            # work must not reject a live submit
            self._expire()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._count("rejected")
            obs.record_event("serve_reject",
                             engine=self._obs_labels["engine"],
                             request_id=request_id,
                             queued=len(self.queue))
            raise BackpressureError(
                f"engine admission queue at capacity ({self.max_queue} "
                f"queued); shed load or retry with backoff")
        ids, stop, resume = self.check_submit(
            input_ids, max_new_tokens, stop_sequences, repetition_penalty,
            resume_tokens)
        self._submit_counter += 1
        if seed is None:
            # monotone per-engine counter: repeated unseeded sampled
            # requests get distinct streams
            seed = self._submit_counter
        timeout_s = timeout_s if timeout_s is not None \
            else self.default_timeout_s
        deadline = (time.monotonic() + timeout_s) \
            if timeout_s is not None else None
        rlps = [float(v) for v in (resume_lps or ())]
        if resume and len(rlps) != len(resume):
            rlps = [float("nan")] * len(resume)
        self.queue.append(_Request(request_id, ids, max_new_tokens,
                                   eos_token_id, float(temperature),
                                   int(top_k), float(top_p),
                                   seed_key_row(seed),
                                   prefix=resume, prefix_lps=rlps,
                                   stop=stop,
                                   rep=float(repetition_penalty),
                                   deadline=deadline))
        if self.trace_sink is not None:
            self.trace_sink(request_id, "engine_queue",
                            queued=len(self.queue))
        if self._fuse_patches and self.chunk is not None:
            # a warm engine admits at submit: chunked admission claims a
            # slot and blocks and marks the row dirty, and its descriptor
            # rides the staged queue into the next tick, no dispatch of
            # its own (whole-prompt admission prefills, so it waits for
            # the tick loop)
            while self._try_admit():
                pass

    def check_submit(self, input_ids, max_new_tokens: int = 32,
                     stop_sequences=None, repetition_penalty: float = 1.0,
                     resume_tokens=None):
        """The ``ValueError``s of :meth:`submit` for these arguments,
        raised without touching the engine; returns the prompt, the stop
        sequences and the resume tokens as :meth:`submit` reads them."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        stop = tuple(tuple(int(t) for t in s)
                     for s in (stop_sequences or ()))
        if any(len(s) == 0 for s in stop):
            raise ValueError("empty stop sequence")
        if repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        ids = [int(t) for t in np.asarray(input_ids).reshape(-1)]
        total = len(ids) + max_new_tokens
        if total > self.M * self.B:
            raise ValueError(f"request needs {total} tokens > "
                             f"max_blocks_per_seq*block_size "
                             f"{self.M * self.B}")
        if self._blocks_needed(total) > self.P - 1:
            raise ValueError("request alone exceeds the block pool")
        resume = [int(t) for t in (resume_tokens or ())]
        if resume and ids[-len(resume):] != resume:
            raise ValueError(
                "resume_tokens must be the tail of input_ids (the "
                "preemption fold: prompt' = prompt + emitted)")
        return ids, stop, resume

    def _blocks_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.B - 1) // self.B

    # -------------------------------------------------- prefix caching
    def _alloc_block(self) -> Optional[int]:
        """A fresh block: the free list first, then evict the
        least-recently-parked cached-free block (its registrations die
        with it)."""
        if self.free_blocks:
            b = self.free_blocks.pop()
        elif self.cached_free:
            b = next(iter(self.cached_free))
            # spill before evict: the dying spans' KV goes to the arena
            # first, so their digests stay restorable
            self._spill_evicted(b)
            self._evict_registered(b)
            # the cascade moves co-members (possibly b) to the free list
            # as their registrations die; track b either way
            if b in self.cached_free:
                del self.cached_free[b]
            else:
                self.free_blocks.remove(b)
        else:
            return None
        self.block_refs[b] = 1
        return b

    def _unhook(self, key, entry):
        """Remove one (key -> entry) registration; member blocks that lose
        their last registration while parked fall to the free list."""
        for ob in entry:
            keys = self._prefix_rev.get(ob)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._prefix_rev[ob]
                    if ob in self.cached_free:
                        del self.cached_free[ob]
                        self.free_blocks.append(ob)

    def _evict_registered(self, b: int):
        """Drop every prefix entry that contains block ``b``."""
        for key in list(self._prefix_rev.get(b, ())):
            entry = self.prefix_cache.pop(key, None)
            if entry is not None:
                self._unhook(key, entry)
                self.prefix_generation += 1
        self._prefix_rev.pop(b, None)

    def _release_block(self, b: int):
        rc = self.block_refs.get(b, 1) - 1
        if rc > 0:
            self.block_refs[b] = rc
            return
        self.block_refs.pop(b, None)
        if b in self._prefix_rev:        # registered: park for reuse
            self.cached_free[b] = None
        else:
            self.free_blocks.append(b)

    # ------------------------------------------------ host-RAM spill tier
    def attach_spill(self, arena):
        """Attach (or detach with None) a
        :class:`~..serving.kvspill.KVSpillArena`. Its owner (the gateway
        worker) calls it at engine construction and after every
        supervisor rebuild: the arena's spans outlive this engine."""
        self._spill = arena

    def _spill_geometry(self) -> tuple:
        """The layout a spilled payload is valid under: (layers, block
        size, kv heads, head dim, dtype name, chunk). Any skew makes the
        bytes meaningless: the arena refuses the restore and the request
        prefills. The dtype is the JAX package's name for it, so both
        packages lay out and check spans alike."""
        kp = self.pools[0][0]
        _, B, kvh, d = kp.shape
        return (len(self.pools), int(B), int(kvh), int(d),
                _DTYPE_NAMES[kp.dtype], self.chunk)

    def _spill_fetch(self, entry) -> bytes:
        """Copy a span's KV to the host: every layer's K and V rows of
        ``entry``'s blocks, packed as one ``(2L, n, B, kvh, d)`` buffer
        (layer-major, K before V) of the pool dtype's bytes, the layout
        ``_restore_span`` reverses. The gather runs on the engine's
        stream, behind any dispatch still in flight, and a block being
        spilled is parked: no row of an outstanding dispatch holds it (a
        block parks when its last owner is released, after that row's
        entries were drained)."""
        idx = torch.as_tensor(np.asarray(entry, np.int64),
                              device=self.device)
        with torch.inference_mode():
            stacked = torch.stack([p[idx] for pair in self.pools
                                   for p in pair])
            raw = stacked.contiguous().view(torch.uint8).cpu()
        return raw.numpy().tobytes()

    def _spill_evicted(self, b: int):
        """Bank every registered span that dies with block ``b`` before
        ``_evict_registered`` drops it. Failures are the arena's (counted
        drops): eviction proceeds regardless."""
        if self._spill is None:
            return
        spans = [(key, entry) for key in self._prefix_rev.get(b, ())
                 for entry in (self.prefix_cache.get(key),)
                 if entry is not None]
        if not spans:
            return
        # live sub-spans of a dying span ride along: their KV is a
        # block-prefix of the dying payload, so the arena indexes them
        # as aliases with no extra copy, which keeps a hot shared prefix
        # restorable even though only its cold descendants are evicted
        dying_keys = {k for k, _ in spans}
        dying_entries = [e for _, e in spans]
        for key, entry in list(self.prefix_cache.items()):
            if key in dying_keys:
                continue
            if any(len(e) > len(entry) and e[:len(entry)] == entry
                   for e in dying_entries):
                spans.append((key, tuple(entry)))
        n = self._spill.spill(spans, self._spill_fetch,
                              self._spill_geometry(),
                              self.prefix_generation)
        self._count("spill_spans", n)

    def spill_parked(self) -> int:
        """Bank every live prefix-cache span into the arena (gateway
        drain or SIGTERM: the pools are about to die, the arena
        survives). Returns the payload records stored."""
        if self._spill is None or not self.prefix_cache:
            return 0
        spans = list(self.prefix_cache.items())
        n = self._spill.spill(spans, self._spill_fetch,
                              self._spill_geometry(),
                              self.prefix_generation)
        self._count("spill_spans", n)
        return n

    def spill_live(self) -> int:
        """Bank every active slot's computed KV span into the arena
        (drain migration, crash salvage). For each live request the span
        is the chunk-grid prefix of ``prompt + generated`` whose KV the
        pools hold (``seq_lens`` is host-authoritative): what a survivor
        restores through ``_arena_restore`` instead of prefilling prompt
        and committed tokens. Whole sub-span chains go in one call, so
        shorter digests alias the one payload. Returns the payload
        records stored; a slot that fails is skipped (its stream just
        prefills again)."""
        if self._spill is None or not self.prefix_caching:
            return 0
        spans = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            try:
                ids = list(req.prompt) + [int(t) for t in req.tokens]
                n_kv = min(int(self.seq_lens[i]), len(ids))
                n_full = (n_kv // self.chunk) * self.chunk
                if n_full <= 0:
                    continue
                blocks = tuple(int(b)
                               for b in req.blocks[:n_full // self.B])
                if len(blocks) * self.B < n_full:
                    continue
                for k, dkey in enumerate(
                        self._chunk_digests(ids, n_full)):
                    nb = (k + 1) * self.chunk // self.B
                    spans.append((dkey, blocks[:nb]))
            except Exception:
                continue
        if not spans:
            return 0
        n = self._spill.spill(spans, self._spill_fetch,
                              self._spill_geometry(),
                              self.prefix_generation)
        self._count("spill_spans", n)
        return n

    @torch.inference_mode()
    def _spill_upload(self, idx, data):
        """Scatter a restored span's packed KV ``(2L, npad, B, kvh, d)``
        into block rows ``idx`` of every layer's pools, in place
        (``index_copy_`` on the engine's stream, so it lands before the
        next dispatch): the captured tick graphs read the pools at fixed
        addresses, and a restore must not cost a capture. Pad rows
        target the garbage block 0."""
        for l, (kp, vp) in enumerate(self.pools):
            kp.index_copy_(0, idx, data[2 * l])
            vp.index_copy_(0, idx, data[2 * l + 1])

    def _arena_restore(self, ids: List[int]):
        """Admission-side arena probe: if the arena holds a strictly
        longer span of ``ids`` than the prefix cache does, upload it into
        fresh blocks and register it; ``_prefix_lookup`` then adopts it
        like any warm span (``prefix_hit_tokens`` counts it; the skipped
        prefill is the win). Every failure (checksum, truncation,
        geometry skew, no block headroom) is counted and falls through
        to a plain prefill."""
        if self._spill is None or not self.prefix_caching:
            return
        chain = self._chunk_digests(ids, len(ids) - 1)
        if not chain:
            return
        live = 0
        for i, d in enumerate(chain):
            if d in self.prefix_cache:
                live = i + 1
        for i in range(len(chain) - 1, live - 1, -1):
            if self._spill.probe(chain[i]) is None:
                continue
            if self._restore_span(chain, i):
                return
            # a failed take evicted that record; shorter spans may live
            # in other records: keep probing down the chain

    def _restore_span(self, chain: List[bytes], i: int) -> bool:
        """Restore span ``chain[i]`` from the arena: one upload and one
        scatter (counted as one upload and one dispatch, as the JAX
        package counts its restore), then the span and its sub-spans
        registered over the new blocks and parked for adoption."""
        C = self.chunk
        n_blocks = (i + 1) * C // self.B
        if len(self.free_blocks) + len(self.cached_free) < n_blocks:
            self._count("spill_restore_failures")
            return False
        got = self._spill.take(chain[i], self._spill_geometry())
        if got is None:
            self._count("spill_restore_failures")
            return False
        payload, rec_tokens = got
        kp = self.pools[0][0]
        _, B, kvh, d = kp.shape
        L = len(self.pools)
        rec_blocks = rec_tokens // B
        expect = 2 * L * rec_blocks * B * kvh * d * kp.element_size()
        if len(payload) != expect or rec_blocks < n_blocks:
            self._count("spill_restore_failures")  # tokens/geometry skew
            return False
        blocks: List[int] = []
        for _ in range(n_blocks):
            b = self._alloc_block()      # may cascade-spill more spans
            if b is None:
                for ob in blocks:
                    self._release_block(ob)
                self._count("spill_restore_failures")
                return False
            blocks.append(b)
        # pad to a power of two with the garbage block, as the JAX
        # package pads its restore program's shapes (the same bytes)
        npad = 1
        while npad < n_blocks:
            npad *= 2
        idx = np.zeros((npad,), np.int64)          # pad -> garbage block
        idx[:n_blocks] = blocks
        data = torch.frombuffer(bytearray(payload), dtype=kp.dtype).view(
            2 * L, rec_blocks, B, kvh, d)[:, :n_blocks]
        padded = torch.zeros((2 * L, npad, B, kvh, d), dtype=kp.dtype)
        padded[:, :n_blocks] = data
        nbytes = padded.numel() * padded.element_size()
        self.dispatch_count += 1
        self._count("dispatches")
        self.h2d_uploads += 1
        self.h2d_upload_bytes += nbytes
        self._count("h2d_upload_bytes", nbytes)
        self._h_bytes.observe(nbytes)
        # a copy from pageable host memory returns once the source was
        # read, so ``padded`` may die after it
        self._spill_upload(torch.as_tensor(idx, device=self.device),
                           padded.to(self.device))
        # register every sub-span over the restored blocks (as
        # _register_prefix does), then park them: the caller's
        # _prefix_lookup adopts them
        for j in range(i + 1):
            key = chain[j]
            entry = tuple(blocks[:(j + 1) * C // self.B])
            old = self.prefix_cache.get(key)
            if old == entry:
                continue
            if old is not None:
                self._unhook(key, old)
            self.prefix_cache[key] = entry
            self.prefix_generation += 1
            for b in entry:
                self._prefix_rev.setdefault(b, set()).add(key)
        for b in blocks:
            self._release_block(b)       # registered: parks in cached_free
        tokens = (i + 1) * C
        self._count("spill_restores")
        self._count("spill_restored_tokens", tokens)
        obs.record_event("kv_spill_restore",
                         engine=self._obs_labels["engine"],
                         tokens=tokens, blocks=n_blocks)
        return True

    def _chunk_digests(self, ids: List[int], max_tokens: int):
        """SHA-256 chain digest per chunk-grid prefix span (digest_k =
        H(digest_{k-1} || chunk_k tokens)) for every k*C <= max_tokens."""
        C = self.chunk
        digests = []
        d = b""
        k = 1
        while k * C <= max_tokens:
            h = hashlib.sha256(d)
            h.update(np.asarray(ids[(k - 1) * C:k * C], np.int64).tobytes())
            d = h.digest()
            digests.append(d)
            k += 1
        return digests

    def prefix_digests(self, input_ids,
                       max_tokens: Optional[int] = None) -> List[str]:
        """Hex SHA-256 chain digests of every chunk-grid prefix span of
        ``input_ids`` (shortest first), each the key ``prefix_cache``
        files that span under. ``max_tokens`` overrides the default cap
        of ``len(ids) - 1`` (one live token must remain to prefill)."""
        if self.chunk is None:
            raise ValueError(
                "prefix_digest requires chunk_prefill_tokens: digests "
                "are keyed to the chunk grid the prefix cache reuses "
                "on")
        ids = [int(t) for t in np.asarray(input_ids).reshape(-1)]
        cap = len(ids) - 1 if max_tokens is None \
            else min(int(max_tokens), len(ids))
        return [d.hex() for d in self._chunk_digests(ids, cap)]

    def prefix_digest(self, input_ids,
                      max_tokens: Optional[int] = None) -> str:
        """The longest span's digest; "" when no grid-aligned span
        exists (short prompt)."""
        digests = self.prefix_digests(input_ids, max_tokens)
        return digests[-1] if digests else ""

    def has_prefix(self, digest: str) -> bool:
        """True when ``digest`` (hex) has live blocks in the prefix
        cache: the router's "is this replica warm" probe. An attached
        spill arena extends the warm tier: a span restorable from host
        RAM costs one upload, not a prefill, so a rebuilt replica
        advertises (and receives) its spilled prefixes at once, and the
        routing pulls the restore through ``_arena_restore``."""
        if not self.prefix_caching or not digest:
            return False
        try:
            raw = bytes.fromhex(digest)
        except ValueError:
            return False
        if raw in self.prefix_cache:
            return True
        return (self._spill is not None
                and self._spill.probe(raw) is not None)

    def _prefix_lookup(self, ids: List[int]):
        """Longest chunk-grid prefix of ``ids`` with a live entry, capped
        so one live token remains to prefill. Returns (cached_tokens,
        adopted_block_ids) without mutating state."""
        if not self.prefix_caching:
            return 0, ()
        C = self.chunk
        cached, best = 0, ()
        for i, d in enumerate(self._chunk_digests(ids, len(ids) - 1)):
            entry = self.prefix_cache.get(d)
            if entry is not None:    # keep scanning: a longer span may
                cached = (i + 1) * C   # survive its evicted sub-spans
                best = entry
        return cached, best

    def _register_prefix(self, req: "_Request"):
        """A prompt is fully cached: publish every chunk-grid-aligned
        prefix span -> its physical blocks."""
        if not self.prefix_caching:
            return
        C, ids = self.chunk, req.prompt
        for i, key in enumerate(self._chunk_digests(ids, len(ids))):
            entry = tuple(req.blocks[:(i + 1) * C // self.B])
            old = self.prefix_cache.get(key)
            if old == entry:
                continue
            if old is not None:  # last writer wins
                self._unhook(key, old)
            self.prefix_cache[key] = entry
            self.prefix_generation += 1
            for b in entry:
                self._prefix_rev.setdefault(b, set()).add(key)

    # ------------------------------------------------------- admission
    def _bucket(self, n: int) -> int:
        """The smallest prefill bucket holding n tokens; past the largest
        the buckets keep doubling."""
        bucket = next((b for b in self.prefill_buckets if b >= n), None)
        if bucket is None:
            bucket = self.prefill_buckets[-1]
            while bucket < n:
                bucket *= 2
        return bucket

    def _try_admit(self) -> bool:
        """Admit ONE queued request into a free slot if blocks allow
        (whole-prompt mode prefills it here)."""
        if not self.queue:
            return False
        req = self.queue[0]
        try:
            slot_id = self.slots.index(None)
        except ValueError:
            return False
        ids = req.prompt
        if self._spill is not None:
            # warm-miss probe of the host spill tier: a restored span
            # registers itself and the lookup below adopts it
            self._arena_restore(ids)
        cached, adopted = self._prefix_lookup(ids)
        need = self._blocks_needed(len(ids) + 1)
        fresh = need - len(adopted)
        evictable = sum(1 for b in self.cached_free if b not in adopted)
        if len(self.free_blocks) + evictable < fresh:
            return False
        self.queue.pop(0)
        self._admit_counter += 1
        req.admit_seq = self._admit_counter
        req.blocks = []
        for b in adopted:            # shared prefix blocks: bump owners
            self.cached_free.pop(b, None)
            self.block_refs[b] = self.block_refs.get(b, 0) + 1
            req.blocks.append(b)
        for _ in range(fresh):
            req.blocks.append(self._alloc_block())
        if cached:
            self._count("prefix_hit_tokens", cached)
            self._count("prefix_adopted_blocks", len(adopted))
        self._h_wait.observe((time.monotonic() - req.t_submit) * 1e3)
        obs.record_event("serve_admit",
                         engine=self._obs_labels["engine"],
                         request_id=req.request_id, slot=slot_id)
        if self.trace_sink is not None:
            self.trace_sink(req.request_id, "slot_take", slot=slot_id,
                            prefix_hit_tokens=cached, blocks=need)
        self.slots[slot_id] = req
        row = np.zeros((self.M,), np.int32)
        row[:need] = req.blocks
        self.block_tables[slot_id] = row
        self.temps[slot_id] = req.temperature
        self.top_ks[slot_id] = req.top_k
        self.top_ps[slot_id] = req.top_p
        self.reps[slot_id] = req.rep
        self.keys[slot_id] = req.key
        self._key_overrides.add(slot_id)
        self._mark_dirty(slot_id)

        if self.chunk is not None:
            # chunked mode: admission claims the slot and blocks; the
            # prompt enters the cache chunk by chunk on later ticks,
            # starting after any shared-prefix tokens already in the pool
            req.prefill_pos = cached
            self.seq_lens[slot_id] = cached
            # seed the seen mask with prefix-cache-skipped tokens (their
            # chunks never run); later chunks add their own ids
            self.seen[slot_id] = False
            if cached:
                self.seen[slot_id, self._dev(ids[:cached],
                                             torch.long)] = True
            return True

        bucket = self._bucket(len(ids))
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(ids)] = ids
        self.dispatch_count += 1
        self._count("dispatches")
        nxt, lp, new_key, seen_row = self._prefill(
            row, self._dev(padded), len(ids), req, bucket=bucket)
        self.seen[slot_id] = seen_row
        self._count("prefills")
        first = int(nxt)
        self.keys[slot_id] = new_key.cpu().numpy().astype(np.uint32)
        self._key_overrides.add(slot_id)
        req.key = self.keys[slot_id].copy()
        req.tokens.append(first)
        req.lps.append(float(lp))
        req.prefill_pos = len(ids)
        self.seq_lens[slot_id] = len(ids)
        if self.trace_sink is not None:
            self.trace_sink(req.request_id, "prefill_done",
                            tokens=len(ids), bucket=bucket)
        # stop check first: a stop completing on the final budgeted (or
        # eos) token must still be trimmed
        if self._stop_hit(req) or req.max_new <= 1 \
                or (req.eos is not None and first == req.eos):
            self._finish(slot_id)
        return True

    def _advance_chunk(self, slot_id: int):
        """Run ONE chunk of the slot's prompt prefill; on the final chunk
        the first generated token appears and the slot joins decode."""
        req = self.slots[slot_id]
        ids = req.prompt
        start = req.prefill_pos
        live = min(self.chunk, len(ids) - start)
        last = start + live >= len(ids)
        padded = np.zeros((1, self.chunk), np.int64)
        padded[0, :live] = ids[start:start + live]
        self._mark_dirty(slot_id)    # lens/activation change this tick
        self.dispatch_count += 1
        self._count("dispatches")
        nxt, lp, new_key, seen_mid, seen_fin = self._chunk_prefill(
            self.block_tables[slot_id], self._dev(padded), start,
            start + live, req, self.seen[slot_id], bucket=self.chunk)
        self._count("prefill_chunks")
        if self.trace_sink is not None:
            self.trace_sink(req.request_id, "prefill_chunk",
                            start=start, tokens=live)
        req.prefill_pos = start + live
        self.seq_lens[slot_id] = req.prefill_pos
        # mid chunks keep the ids-only mask; the final chunk's sample
        # enters with seen_fin (as the key does)
        self.seen[slot_id] = seen_fin if last else seen_mid
        if last:
            self._count("prefills")
            self._register_prefix(req)
            self.keys[slot_id] = new_key.cpu().numpy().astype(np.uint32)
            self._key_overrides.add(slot_id)
            req.key = self.keys[slot_id].copy()
            first = int(nxt)
            req.tokens.append(first)
            req.lps.append(float(lp))
            if self.trace_sink is not None:
                self.trace_sink(req.request_id, "prefill_done",
                                tokens=len(ids))
            if self._stop_hit(req) or req.max_new <= 1 \
                    or (req.eos is not None and first == req.eos):
                self._finish(slot_id)

    def _grow_blocks(self, slot_id: int, need: int,
                     reserve: int = 0) -> bool:
        """Grow a slot's table to ``need`` blocks; False when the pool
        cannot serve. ``reserve`` refuses to take the allocatable blocks
        (free and parked) down to that count: the speculative headroom
        uses it so its grabs never starve ``_ensure_block``."""
        slot = self.slots[slot_id]
        while len(slot.blocks) < need:
            if reserve and len(self.free_blocks) + \
                    len(self.cached_free) <= reserve:
                return False
            b = self._alloc_block()
            if b is None:
                return False
            slot.blocks.append(b)
            self.block_tables[slot_id, len(slot.blocks) - 1] = b
            self._mark_dirty(slot_id)   # table row grew: patch/re-upload
        return True

    def _ensure_block(self, slot_id: int) -> bool:
        """The next decode writes at seq_lens[slot_id]; allocate the
        covering block if the row hasn't got it yet."""
        need = self._blocks_needed(int(self.seq_lens[slot_id]) + 1)
        return self._grow_blocks(slot_id, need)

    @staticmethod
    def _stop_hit(req) -> bool:
        """True when the generated stream ends with one of the request's
        stop sequences; records the matched length for trimming."""
        if not req.stop:
            return False
        need = max(len(s) for s in req.stop)
        tail = req.tokens[-need:]
        if len(tail) < need and req.prefix:  # stop spans a preemption
            take = need - len(tail)
            tail = req.prefix[-take:] + tail
        for s in req.stop:
            if len(tail) >= len(s) and tuple(tail[-len(s):]) == s:
                req.trim = len(s)
                return True
        return False

    def _finish(self, slot_id: int):
        slot = self.slots[slot_id]
        toks = slot.prefix + slot.tokens
        lps = slot.prefix_lps + slot.lps
        if slot.trim:               # cut the matched stop sequence
            toks = toks[:-slot.trim]
            lps = lps[:-slot.trim]
        self.results[slot.request_id] = toks
        self.logprobs[slot.request_id] = lps
        if self.trace_sink is not None:
            self.trace_sink(slot.request_id, "engine_finish",
                            tokens=len(toks))
        self._release(slot_id)

    def _release(self, slot_id: int):
        for b in self.slots[slot_id].blocks:
            self._release_block(b)
        self.block_tables[slot_id] = 0
        self.seq_lens[slot_id] = 0
        self.temps[slot_id] = 0.0
        self.top_ks[slot_id] = 0
        self.top_ps[slot_id] = 1.0
        self.reps[slot_id] = 1.0
        self.seen[slot_id] = False
        self.slots[slot_id] = None
        self._key_overrides.discard(slot_id)
        self._mark_dirty(slot_id)

    def _preempt_youngest(self, exclude: int) -> bool:
        """Memory pressure: requeue the most recently admitted other
        request (recompute-mode preemption: its emitted tokens fold into
        the prompt, and its carried key resumes a sampled stream)."""
        cands = [i for i, s in enumerate(self.slots)
                 if s is not None and i != exclude]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.slots[i].admit_seq)
        s = self.slots[victim]
        if self._fused and s.tokens and victim not in self._key_overrides:
            # the fused tick never syncs s.key per tick: for a decoding
            # victim the device key (or the mirror synced from it) is the
            # truth; a mid-prefill victim keeps its untouched s.key
            if self._dev_live and self._dev_keys_dirty:
                s.key = self._st["keys"][victim].cpu().numpy().astype(
                    np.uint32)
            else:
                s.key = self.keys[victim].copy()
        requeued = _Request(s.request_id, s.prompt + s.tokens,
                            s.max_new - len(s.tokens), s.eos,
                            s.temperature, s.top_k, s.top_p,
                            s.key.copy(),
                            prefix=s.prefix + s.tokens,
                            prefix_lps=s.prefix_lps + s.lps,
                            stop=s.stop, rep=s.rep, deadline=s.deadline)
        requeued.spec_ema = s.spec_ema   # the adaptive draft count survives
        self.queue.insert(0, requeued)
        self._release(victim)
        self._count("preemptions")
        if self.trace_sink is not None:
            self.trace_sink(s.request_id, "preempt",
                            emitted=len(s.tokens))
        obs.record_event("serve_preempt",
                         engine=self._obs_labels["engine"],
                         request_id=s.request_id,
                         emitted=len(s.tokens))
        return True

    # -------------------------------------------------- overload control
    def _abort(self, req: "_Request", reason: str,
               slot_id: Optional[int] = None):
        self.cancelled[req.request_id] = reason
        self._count("timeouts" if reason == "timeout"
                    else "cancellations")
        if self.trace_sink is not None:
            self.trace_sink(req.request_id, "engine_abort",
                            reason=reason, in_slot=slot_id is not None)
        if slot_id is not None:
            self._release(slot_id)

    def _expire(self):
        """Abort queued and running requests whose deadline passed
        (checked once per tick; a forward is never interrupted). A
        running expiry drains the row first (never abort against a stale
        mirror or an in-flight dispatch): only that row's pending ring
        entries in delta mode, the whole ring otherwise. At tp > 1 the
        ranks agree on what expired (:meth:`_agree`)."""
        now = time.monotonic()
        reqs = list(self.queue) + list(self.slots)
        if not any(r is not None and r.deadline is not None for r in reqs):
            return
        late = self._agree([r is not None and r.deadline is not None
                            and now > r.deadline for r in reqs])
        n = len(self.queue)
        for req, gone in zip(reqs[:n], late[:n]):
            if gone:
                self.queue.remove(req)
                self._abort(req, "timeout")
        for i in range(self.R):
            if late[n + i]:
                self._drain_slot(i)
                s = self.slots[i]   # the drain may have finished it
                if s is not None and s is reqs[n + i]:
                    self._abort(s, "timeout", slot_id=i)

    def _agree(self, flags) -> List[bool]:
        """``flags`` OR-ed over the tp ranks (each rank's own at tp 1):
        a decision that reads a clock comes out the same on every rank."""
        if self._host_tp is None:
            return list(flags)
        t = torch.tensor(flags, dtype=torch.int32)
        torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX,
                                     group=self._host_tp)
        return [bool(v) for v in t.tolist()]

    def schedule_digest(self) -> int:
        """A 63-bit digest of this step's schedule: the queue length,
        each slot's occupancy with its prefill position and token count,
        the block tables, the lengths and the dispatch count. Equal on
        every rank of a tp mesh that decides alike."""
        h = hashlib.blake2b(digest_size=8)
        occ = [(-1, -1) if s is None else (s.prefill_pos, len(s.tokens))
               for s in self.slots]
        h.update(np.asarray([len(self.queue), self.dispatch_count]
                            + [v for pair in occ for v in pair],
                            np.int64).tobytes())
        h.update(self.block_tables.tobytes())
        h.update(self.seq_lens.tobytes())
        return int.from_bytes(h.digest(), "little") >> 1

    def _check_ranks(self):
        """Compare this step's :meth:`schedule_digest` across the tp ranks
        (a gloo all-gather of one host int64); ``RuntimeError`` where they
        part."""
        mine = self.schedule_digest()
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(self._tp)]
        torch.distributed.all_gather(
            got, torch.tensor([mine], dtype=torch.int64), group=self._host_tp)
        if any(int(g) != mine for g in got):
            raise RuntimeError(
                f"tp ranks' engine schedules parted at dispatch "
                f"{self.dispatch_count}: digests {[int(g) for g in got]}")

    @_card_work
    def cancel(self, request_id) -> bool:
        """Abort a queued or running request (client disconnect). Its
        blocks and slot free at once; no result is recorded. False if
        the request is unknown or already finished.

        A running cancel racing an in-flight dispatch drains that slot's
        pending ring entries first, so the release cannot orphan tokens
        or free blocks the dispatch still writes; in delta mode the drain
        is the row's alone and the siblings' tokens stay pending."""
        for req in self.queue:
            if req.request_id == request_id:
                self.queue.remove(req)
                self._abort(req, "cancelled")
                return True
        for i in range(self.R):
            s = self.slots[i]
            if s is not None and s.request_id == request_id:
                self._drain_slot(i)
                s = self.slots[i]
                if s is None or s.request_id != request_id:
                    return False   # finished in the drained entries
                self._abort(s, "cancelled", slot_id=i)
                return True
        return False

    def health(self) -> Dict[str, Any]:
        """Stats snapshot for load balancers and probes: scheduler
        counters plus live occupancy (slots, blocks, queue depth)."""
        snap = dict(self.stats)
        prop = snap.get("spec_proposed", 0)
        snap["spec_accept_rate"] = round(
            snap.get("spec_accepted", 0) / prop, 4) if prop else 0.0
        ticks = snap.get("decode_steps", 0)
        snap["dispatches_per_tick"] = round(
            snap.get("dispatches", 0) / ticks, 4) if ticks else 0.0
        snap.update(
            queued=len(self.queue),
            queue_capacity=self.max_queue,
            active_slots=sum(s is not None for s in self.slots),
            max_slots=self.R,
            free_blocks=len(self.free_blocks),
            cached_free_blocks=len(self.cached_free),
            total_blocks=self.P - 1,
            spill_attached=self._spill is not None,
            results_pending=len(self.results),
            aborted=len(self.cancelled))
        return snap

    def debug_snapshot(self, max_digests: int = 32) -> Dict[str, Any]:
        """Live engine introspection for the gateway's ``/debugz``: the
        slot map, block-pool occupancy (``live`` = blocks owned by
        running requests; ``fragmentation_frac`` = the share of the pool
        parked in prefix-cache entries, reusable only through eviction),
        the prefix-cache digests the router probes, the queued request
        ids, and the spill, speculation, ring, transition and tick-phase
        accounting. Read from another thread without stopping the tick
        thread: every field is O(1)/O(R) host bookkeeping, and a torn
        snapshot costs debug fidelity, never correctness."""
        now = time.monotonic()
        slots: List[Optional[Dict[str, Any]]] = []
        for i, s in enumerate(list(self.slots)):
            if s is None:
                slots.append(None)
                continue
            slots.append({
                "request_id": str(s.request_id),
                "seq_len": int(self.seq_lens[i]),
                "prompt_tokens": len(s.prompt),
                "prefill_pos": s.prefill_pos,
                "emitted": len(s.prefix) + len(s.tokens),
                "remaining_budget": max(s.max_new - len(s.tokens), 0),
                "blocks": len(s.blocks),
                "spec_ema": round(float(s.spec_ema), 4),
                "deadline_in_s": round(s.deadline - now, 3)
                if s.deadline is not None else None,
            })
        total = self.P - 1               # block 0 is the garbage block
        free = len(self.free_blocks)
        parked = len(self.cached_free)
        live = max(total - free - parked, 0)
        try:
            digests = [k.hex() for k in
                       list(self.prefix_cache)[:max_digests]]
            n_entries = len(self.prefix_cache)
        except RuntimeError:             # resized mid-iteration
            digests, n_entries = [], -1
        try:
            # the tick thread mutates _delta_rows; a resize mid-iteration
            # costs this field, never the whole snapshot
            pending = sorted(self._delta_rows)
        except RuntimeError:
            pending = []
        return {
            "slots": slots,
            "block_pool": {
                "total": total, "free": free, "cached_free": parked,
                "live": live,
                "occupancy_frac": round(live / max(total, 1), 4),
                "free_frac": round((free + parked) / max(total, 1), 4),
                "fragmentation_frac": round(parked / max(total, 1), 4),
            },
            "prefix_cache": {"entries": n_entries, "digests": digests,
                             "generation": self.prefix_generation},
            "spill": {
                "attached": self._spill is not None,
                "restores": int(
                    self._counters["spill_restores"].value),
                "restored_tokens": int(
                    self._counters["spill_restored_tokens"].value),
                "restore_failures": int(
                    self._counters["spill_restore_failures"].value),
                "spilled_spans": int(
                    self._counters["spill_spans"].value),
            },
            "queued": [str(r.request_id)
                       for r in list(self.queue)[:max_digests]],
            "spec": {"enabled": bool(self._spec_k), "k": self._spec_k,
                     "ngram": self._spec_ngram if self._spec_k else 0},
            "ring": {"enabled": self._ring, "ring_len": self._ring_len,
                     "outstanding": self._pending is not None,
                     "drains": self.ring_drains,
                     "blocking_drains": self.ring_blocking_drains,
                     "scoped_drains": self.ring_scoped_drains,
                     "d2h_syncs": self.d2h_syncs},
            # how slot churn is paid for: one-row patches against full
            # rebuilds, and the upload bytes either way
            "transitions": {
                "delta_enabled": self._delta,
                "patch_fuse_enabled": self._fuse_patches,
                "patch_queue_len": self._pq_len,
                "full_rebuilds": self.full_rebuilds,
                "delta_patches": self.delta_patches,
                "patches_fused": self.patches_fused,
                "patch_queue_overflows": self.patch_queue_overflows,
                "ring_cursor_rollovers": self.ring_cursor_rollovers,
                "pending_patch_rows": pending,
                "h2d_uploads": self.h2d_uploads,
                "h2d_upload_bytes": self.h2d_upload_bytes,
                "dispatches": self.dispatch_count,
                "dispatches_per_tick": round(
                    self.dispatch_count
                    / max(int(self._counters["decode_steps"].value), 1),
                    4),
            },
            # where the last tick's wall time went, and the totals, with
            # tick_profile on
            "tick_profile": {
                "enabled": self._prof is not None,
                "ticks": self._prof.ticks,
                "wall_total_ms": round(self._prof.wall_total_ms, 3),
                "phase_totals_ms": {
                    p: round(v, 3)
                    for p, v in self._prof.totals.items()},
                "last_tick": self._prof.last_phases(),
            } if self._prof is not None else {"enabled": False},
        }

    # ------------------------------------------------- fault tolerance
    def export_resumable(self) -> Dict[Any, Dict[str, Any]]:
        """Resume descriptors for every queued or running request, from
        host state only (no device access): each is the preemption
        transform, ready for ``submit(prompt, max_new_tokens=remaining,
        resume_tokens=committed, ...)`` on another engine."""
        out: Dict[Any, Dict[str, Any]] = {}

        def _desc(s: "_Request") -> Dict[str, Any]:
            # lps first, then tokens cut to the paired length: one
            # consistent (tokens, lps) snapshot
            lps = list(s.lps)
            toks = list(s.tokens)[:len(lps)]
            n = len(toks)
            return {
                "prompt": list(s.prompt) + toks,
                "committed": list(s.prefix) + toks,
                "committed_lps": list(s.prefix_lps) + lps[:n],
                "remaining": max(s.max_new - n, 0),
                "eos": s.eos,
                "temperature": s.temperature,
                "top_k": s.top_k,
                "top_p": s.top_p,
                "stop": [list(x) for x in s.stop],
                "rep": s.rep,
                "deadline": s.deadline,
            }

        for s in list(self.queue):
            out[s.request_id] = _desc(s)
        for s in list(self.slots):
            if s is not None:
                out[s.request_id] = _desc(s)
        return out

    def hard_reset(self):
        """Return the engine to its empty post-construction state without
        touching whatever the device is doing: every queued or running
        request is dropped (the caller already failed them over), and
        the pools, seen masks and device state are allocated fresh. The
        captured tick programs read the old tensors, so they are dropped
        and captured again on next use. Counters keep counting."""
        self._new_pools()
        self.slots = [None] * self.R
        self.queue = []
        self.results = {}
        self.logprobs = {}
        self.cancelled = {}
        if self.prefix_cache:
            # the cache set changed (to empty): a poller must notice
            self.prefix_generation += 1
        self.prefix_cache = {}
        self._prefix_rev = {}
        self.block_refs = {}
        self.cached_free = {}
        self._key_overrides = set()
        self._dev_live = False
        self._dev_dirty = True
        self._dev_keys_dirty = False
        self._delta_rows = set()
        self._pending = None
        self._drained[:] = 0
        obs.record_event("paged_hard_reset",
                         engine=self._obs_labels["engine"])

    def close(self, drain: bool = True):
        """``drain=True`` runs until every queued and in-flight request
        completes; ``drain=False`` aborts everything still pending,
        recording each as "cancelled"."""
        if drain:
            self.run()
            return
        self._drain_pending()
        for req in list(self.queue):
            self.queue.remove(req)
            self._abort(req, "cancelled")
        for i in range(self.R):
            if self.slots[i] is not None:
                self._abort(self.slots[i], "cancelled", slot_id=i)

    # ------------------------------------------------------------ ticks
    @_card_work
    def step(self):
        """One scheduler tick: drain the previous ring dispatch (its tokens
        land here, one step behind the device), expire overdue requests,
        admit every queued request that fits, advance one prefill chunk
        per prefilling slot, then one decode for all prefill-complete
        slots (in ring mode a dispatch with no readback).

        With ``tick_profile`` on, the whole tick is one profiler window:
        the bracketed h2d, dispatch, device and drain time plus the host
        residual land in the per-tick ring and the phase histograms."""
        prof = self._prof
        if prof is None:
            return self._step_inner()
        prof.begin()
        d0, u0 = self.dispatch_count, self.h2d_uploads
        b0, p0 = self.h2d_upload_bytes, self.patches_fused
        try:
            return self._step_inner()
        finally:
            prof.end(
                dispatches=self.dispatch_count - d0,
                uploads=self.h2d_uploads - u0,
                nbytes=self.h2d_upload_bytes - b0,
                patches=self.patches_fused - p0,
                active=sum(1 for s in self.slots if s is not None))

    def _step_inner(self):
        self._drain_pending()
        self._expire()
        while self._try_admit():
            pass
        if self.chunk is not None:
            for i in range(self.R):
                s = self.slots[i]
                if s is not None and s.prefill_pos < len(s.prompt):
                    self._advance_chunk(i)
        for i in range(self.R):
            if self.slots[i] is None or \
                    self.slots[i].prefill_pos < len(self.slots[i].prompt):
                continue
            while not self._ensure_block(i):
                if not self._preempt_youngest(exclude=i):
                    raise RuntimeError(
                        "paged KV pool cannot hold even one request; "
                        "raise num_blocks")
        if self.rank_check:
            self._check_ranks()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.tokens]
        if not active:
            return
        if self._fused:
            if self._spec_k:
                # a speculative tick is already a multi-token dispatch: it
                # takes the place of the scan ticks
                self._spec_headroom(active)
                return self._decode_fused(active, spec=True)
            scan = self._ticks_per_dispatch > 1 and self._scan_ticks(active)
            return self._decode_fused(active, scan=scan)
        return self._decode_host(active)

    # -------------------------------------------------- the token ring
    def _ring_wait(self):
        """Wait for the ring copy of the outstanding dispatch and return
        its host arrays by name (ring, logprobs, write cursors, active
        mask; with spec, each row's drafted and accepted counts). A copy
        not yet finished counts one blocking drain and one blocking
        readback."""
        ev = self._ring_event
        if ev is not None and not ev.query():
            self.ring_blocking_drains += 1
            self.d2h_syncs += 1
        tp = self._clock()
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        # in ring mode the drain's wait is the program-bound time the
        # host sees: the decode-step histogram's window
        self._h_decode.observe((time.perf_counter() - t0) * 1e3)
        self._phase("device", tp)
        tr = self._clock()
        out = {k: v.numpy() for k, v in self._ring_host.items()}
        self._phase("drain", tr)
        return out

    def _drain_pending(self):
        """Consume the outstanding ring dispatch: the ring entries
        committed since the last drain go through the host bookkeeping
        the sync path does inline (appends, stop matching, the device
        finish flags, trace events). Called at the top of every step()
        and by every out-of-band transition, so no transition reads a
        stale mirror. No-op when nothing is outstanding."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        self.ring_drains += 1
        h = self._ring_wait()
        spec = self._spec_k > 0
        if spec:
            rows = p["rows"]
            self._count_drafts(int(h["kprop_last"][rows].sum()),
                               int(h["macc_last"][rows].sum()))
        lag = self.dispatch_count - p["seq"] + 1   # dispatches until drain
        for i in p["rows"]:
            self._commit_row_drain(
                i, h["ring"][i], h["rlps"][i], h["wcur"][i], h["active"][i],
                int(h["kprop_last"][i]) if spec else 0,
                int(h["macc_last"][i]) if spec else 0, lag)

    def _count_drafts(self, proposed: int, accepted: int):
        self._count("spec_proposed", proposed)
        self._count("spec_accepted", accepted)

    def _spec_mirror(self, slot, kp: int, ma: int):
        """The host mirror of a row's device EMA, advanced as the tick
        advanced it (the device copy stays the authority until the next
        upload)."""
        if kp:
            slot.spec_ema = ((1.0 - _SPEC_EMA_ALPHA) * slot.spec_ema
                             + _SPEC_EMA_ALPHA * (float(ma) / float(kp)))

    def _commit_row_drain(self, i, ring_i, rlps_i, wc, act_i, kp, ma,
                          lag) -> bool:
        """One row's share of a drain, shared by the global and the scoped
        drain: advance the drained cursor, mirror the spec EMA and count
        the tokens per forward, append the row's entries (stop check on
        each), emit its trace event, honour the device finish flag.
        ``kp``/``ma``: the row's drafted and accepted counts (0 without
        spec). False for a row released since the dispatch (its cursor
        still advances)."""
        slot = self.slots[i]
        base = int(self._drained[i])
        n_new = int(wc) - base
        self._drained[i] = int(wc)
        if slot is None:
            return False
        if self._spec_k:
            self._h_tpf.observe(n_new)
            self._spec_mirror(slot, kp, ma)
        Lr = self._ring_len
        appended, finished = self._consume_row(
            i, ((ring_i[(base + j) % Lr], rlps_i[(base + j) % Lr], False)
                for j in range(n_new)))
        if self.trace_sink is not None:
            ev = dict(n=appended, ring_lag=lag)
            if self._spec_k:
                ev.update(proposed=kp, accepted=ma)
            ph = self._tick_phase_fields()
            if ph is not None:
                # the last completed tick's split: the one whose tokens
                # this drain commits
                ev["phase"] = ph
            self.trace_sink(slot.request_id, "tick", **ev)
        if finished or not bool(act_i):
            self._finish(i)     # host stop, or the device's eos/budget
        return True

    def _drain_row(self, i: int):
        """The scoped drain of an out-of-band transition (cancel, expiry):
        consume only slot ``i``'s pending entries. Waiting for the copy
        waits for the whole dispatch, so releasing the row's blocks
        afterwards cannot race an in-flight write; the siblings' entries
        stay pending for the next step()'s drain. No-op when nothing is
        outstanding or the row was not in the dispatch."""
        p = self._pending
        if p is None or i not in p["rows"]:
            return
        self.ring_drains += 1
        self.ring_scoped_drains += 1
        h = self._ring_wait()
        p["rows"].remove(i)
        if not p["rows"]:
            self._pending = None
        kp = ma = 0
        if self._spec_k:
            kp, ma = int(h["kprop_last"][i]), int(h["macc_last"][i])
        if self._commit_row_drain(
                i, h["ring"][i], h["rlps"][i], h["wcur"][i], h["active"][i],
                kp, ma, self.dispatch_count - p["seq"] + 1):
            self._count_drafts(kp, ma)

    def _drain_slot(self, i: int):
        """Drain before mutating slot ``i`` out-of-band: scoped to the row
        in delta mode, the whole ring in rebuild mode."""
        if self._delta:
            self._drain_row(i)
        else:
            self._drain_pending()

    def _consume_row(self, i, entries):
        """Append each ``(token, logprob, device_done)`` entry to slot
        ``i``, stop check first (a stop on the final budgeted or eos token
        still records its trim), and stop at a host stop or a device done
        flag: tokens the device committed past the cut die with the
        slot's release. Returns ``(appended, finished)``; the caller
        emits its trace event, then finishes."""
        slot = self.slots[i]
        appended = 0
        finished = False
        for tok, lp, dflag in entries:
            self._count("active_slot_steps")
            self.seq_lens[i] += 1   # the device advanced its copy too
            slot.tokens.append(int(tok))
            slot.lps.append(float(lp))
            appended += 1
            if self._stop_hit(slot) or dflag:
                finished = True
                break
        return appended, finished

    # --------------------------------------------------- decode ticks
    def _decode_host(self, active):
        """The per-tick host path: upload every mirror, run the model once
        for all slots, read back the tokens, and run stop/eos/budget
        bookkeeping in Python."""
        t_decode = time.perf_counter()
        last = np.zeros((self.R,), np.int32)   # the JAX package's dtype
        for i in active:
            last[i] = self.slots[i].tokens[-1]
        act_mask = np.zeros((self.R,), bool)
        act_mask[active] = True
        self.dispatch_count += 1
        self._count("dispatches")
        self.d2h_syncs += 1
        greedy = bool(np.all(self.temps[active] <= 0.0))
        # the model call interleaves _up uploads with the dispatch: the
        # h2d time _up counted is deducted from the dispatch's
        prof = self._prof
        if prof is not None:
            tp = prof.clock()
            h0 = prof.acc("h2d")
        with torch.inference_mode():
            if greedy:
                # all-greedy tick: no filtering, no noise, no key read-back
                nxt, lps, _ = self._decode_core(
                    self._up(self.block_tables), self._up(self.seq_lens),
                    self._up(last), self._up(self.reps), self._up(act_mask))
            else:
                nxt, lps, new_keys = self._decode_core(
                    self._up(self.block_tables), self._up(self.seq_lens),
                    self._up(last), self._up(self.reps), self._up(act_mask),
                    sampling=(self._up(self.keys.astype(np.int64)),
                              self._up(self.temps), self._up(self.top_ks),
                              self._up(self.top_ps)))
                self.keys = new_keys.cpu().numpy().astype(np.uint32)
        if prof is not None:
            prof.add("dispatch", (prof.clock() - tp) * 1e3
                     - (prof.acc("h2d") - h0))
            tp = prof.clock()
            self._wait_device()
            self._phase("device", tp)
        tr = self._clock()
        nxt = nxt.cpu().numpy()
        lps = lps.cpu().numpy()
        self._phase("drain", tr)
        # the read-back synced the device: this is the tick's real latency
        self._h_decode.observe((time.perf_counter() - t_decode) * 1e3)
        self._count("decode_steps")
        self._count("slot_steps", self.R)
        self._count("active_slot_steps", len(active))
        sink = self.trace_sink
        for i in active:
            slot = self.slots[i]
            self.seq_lens[i] += 1   # the decode wrote last token's K/V
            tok = int(nxt[i])
            slot.tokens.append(tok)
            slot.lps.append(float(lps[i]))
            slot.key = self.keys[i].copy()
            if sink is not None:
                sink(slot.request_id, "tick", n=1)
            done = self._stop_hit(slot) or \
                len(slot.tokens) >= slot.max_new or \
                (slot.eos is not None and tok == slot.eos)
            if done:
                # the final token's K/V is never written: never attended
                self._finish(i)
        return True

    def _decode_fused(self, active, scan: bool = False, spec: bool = False):
        """The fused tick's host half: bring the device state up to date
        (a rebuild, or the staged patches), run ONE dispatch advancing
        every active slot (``scan``: K ticks, proven safe by
        ``_scan_ticks``; ``spec``: the speculative tick), then either
        leave its tokens in the ring for the next step()'s drain (ring
        mode: the ring is copied to pinned host memory without waiting)
        or read the outputs back at once and run the bookkeeping."""
        K = self._ticks_per_dispatch if scan else 1
        self._sync_dev()
        t_decode = time.perf_counter()
        self.dispatch_count += 1
        self._count("dispatches")
        greedy = bool(np.all(self.temps[active] <= 0.0))
        tp = self._clock()
        self._dispatch(greedy, K, spec)
        self._phase("dispatch", tp)
        if not greedy:
            self._dev_keys_dirty = True
        self._count("decode_steps", K)
        self._count("slot_steps", self.R * K)
        if self._ring:
            self._leave_in_ring(active)
            return True
        self.d2h_syncs += 1
        if spec:
            return self._read_spec(active, t_decode)
        tp = self._clock()
        if tp is not None:
            self._wait_device()
        self._phase("device", tp)
        tr = self._clock()
        nxt = self._out_nxt[:K].cpu().numpy()
        lps = self._out_lps[:K].cpu().numpy()
        done = self._out_done[:K].cpu().numpy()
        self._phase("drain", tr)
        self._h_decode.observe((time.perf_counter() - t_decode) * 1e3)
        sink = self.trace_sink
        for i in active:
            slot = self.slots[i]
            # scan ticks past a row's done flag are garbage the consume
            # cut never reads (the device's active mask froze the row)
            appended, finished = self._consume_row(
                i, ((nxt[k, i], lps[k, i], bool(done[k, i]))
                    for k in range(K)))
            if sink is not None:
                sink(slot.request_id, "tick", n=appended)
            if finished:
                self._finish(i)
        return True

    def _spec_headroom(self, active):
        """Best-effort blocks so each active row can write its k+1
        positions this tick (one draft's worth for a row whose EMA
        collapsed). It never preempts and keeps one block a row in
        reserve; a row that gets no headroom drafts less or nothing (the
        tick caps its drafts by the write room its table shows)."""
        for i in active:
            s = self.slots[i]
            if s.max_new - len(s.tokens) < 2:
                continue
            k_want = self._spec_k if s.spec_ema >= _SPEC_EMA_FLOOR else 1
            # a table holds at most M blocks: at that edge the tick's
            # write-room cap shrinks the drafts instead
            need = min(
                self._blocks_needed(int(self.seq_lens[i]) + k_want + 1),
                self.M)
            if not self._grow_blocks(i, need, reserve=len(active)):
                return

    def _read_spec(self, active, t_decode):
        """The speculative tick's sync-mode readback (ring mode leaves the
        window to the drain, which appends it and counts the drafts):
        read (candidates, logprobs, emitted count, drafted, accepted,
        done) and run each row's bookkeeping over its emitted window:
        appends, the stop check inside the window (a stop mid-window
        finishes the request; tokens past it die with the slot), the
        device's finish flag."""
        tp = self._clock()
        if tp is not None:
            self._wait_device()
        self._phase("device", tp)
        tr = self._clock()
        out = {k: v.cpu().numpy() for k, v in self._out_spec.items()}
        self._phase("drain", tr)
        self._h_decode.observe((time.perf_counter() - t_decode) * 1e3)
        self._count_drafts(int(out["kprop"][active].sum()),
                           int(out["macc"][active].sum()))
        sink = self.trace_sink
        for i in active:
            slot = self.slots[i]
            n = int(out["n"][i])
            kp, ma = int(out["kprop"][i]), int(out["macc"][i])
            self._h_tpf.observe(n)
            self._spec_mirror(slot, kp, ma)
            appended, finished = self._consume_row(
                i, ((out["G"][i, j], out["LP"][i, j], False)
                    for j in range(n)))
            if sink is not None:
                sink(slot.request_id, "tick", n=appended, proposed=kp,
                     accepted=ma)
            if finished or bool(out["done"][i]):
                self._finish(i)
        return True

    def _leave_in_ring(self, active):
        """Ring mode after a dispatch: copy the ring (and the state the
        drain reads) to pinned host memory without waiting, and leave the
        dispatch outstanding for the next step()'s drain."""
        h, st = self._ring_host, self._st
        for k in h:
            h[k].copy_(st[k], non_blocking=True)
        self._ring_event = self._record_event()
        self._pending = dict(rows=list(active), seq=self.dispatch_count)

    def _scan_ticks(self, active) -> bool:
        """True when the next ``ticks_per_dispatch`` ticks may run in one
        program with no difference a stream could show from K single
        ticks: the queue is empty (a scan must not delay an admission),
        every occupied slot is decoding (no chunk interleaves), and every
        row gets block headroom for its next min(K, budget) writes, all
        checked before any block is taken (pressure falls back to the
        single tick and its preemption). A stop completing mid-scan
        finishes at the host; the tokens past it die with the slot."""
        K = self._ticks_per_dispatch
        for i, s in enumerate(self.slots):
            if s is not None and i not in active:
                return False          # occupied but not decode-active
        if self.queue:
            return False
        needs = []
        for i in active:
            s = self.slots[i]
            a = min(K, max(s.max_new - len(s.tokens), 1))
            needs.append((i, self._blocks_needed(int(self.seq_lens[i]) + a)))
        fresh = sum(max(n - len(self.slots[i].blocks), 0)
                    for i, n in needs)
        if fresh > len(self.free_blocks) + len(self.cached_free):
            return False
        for i, need in needs:
            self._grow_blocks(i, need)   # pre-checked: cannot fail
        return True

    def run(self) -> Dict[Any, List[int]]:
        """Drive until queue and slots drain; returns request_id ->
        generated token list (prompt excluded)."""
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return dict(self.results)

    def stream(self):
        """Generator over (request_id, token) pairs in emission order.
        Requests with stop_sequences hold back their last
        max-stop-length tokens until they finish, so the consumer sees
        exactly the tokens that end up in ``results``. Drives the engine
        to drain; submits made during iteration join the stream."""
        emitted: Dict[Any, int] = {}
        # results from before this call must not replay into this stream
        flushed = set(self.results)
        while self.queue or any(s is not None for s in self.slots):
            self.step()
            for s in self.slots:
                if s is None:
                    continue
                rid = s.request_id
                hold = max((len(x) for x in s.stop), default=0)
                n_pre = len(s.prefix)
                start = emitted.get(rid, 0)
                upto = max(n_pre + len(s.tokens) - hold, start)
                for i in range(start, upto):
                    yield (rid, s.prefix[i] if i < n_pre
                           else s.tokens[i - n_pre])
                emitted[rid] = upto
            if len(self.results) > len(flushed):
                # something finished this tick: flush the rest of its
                # (stop-trimmed) final tokens
                for rid in set(self.results) - flushed:
                    for t in self.results[rid][emitted.pop(rid, 0):]:
                        yield (rid, t)
                    flushed.add(rid)
