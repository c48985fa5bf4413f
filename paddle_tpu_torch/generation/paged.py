"""Paged KV cache and continuous batching (counterpart of
``paddle_tpu/generation/paged.py``): the paged KV helpers and
``PagedEngine`` on its per-tick host path (``fused_tick=False``).

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
  every active slot: the host uploads its mirrors (tables, lengths, last
  tokens, sampling parameters), runs the model once, and reads back the
  chosen tokens. Scheduling, the prefix cache, preemption, stop
  sequences, cancel and timeout are host bookkeeping, as in the JAX
  package.
- A decode tick's attention is the ragged paged kernel, once per layer
  (the grid paged kernel under ``PADDLE_TPU_PAGED_ATTN=grid``, as in the
  JAX package); whole-prompt prefill is dense causal attention over the
  prompt and a chunk attends over its row's gathered blocks.

The device-resident tick (``fused_tick=True``, ring mode, delta
transitions, the fused patch queue, scan ticks), speculative ticks, the
host-RAM spill tier and the tick-phase profiler come with later slices;
their constructor arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.attention import dense_attention, use_paged_kernel
from ..ops.kernels.paged_attention import paged_attention
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..utils import observability as obs
from ..utils.faults import BackpressureError
from .sampling import (repetition_penalty_rows, sample_token_rows,
                       seed_key_row)

__all__ = ["PagedKV", "PagedEngine"]

# unique per-process engine label: every engine's counters live in the
# process registry, while `stats` / `health()` stay per instance
_engine_ids = itertools.count()


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


def paged_decode_write(pk: PagedKV, k, v) -> PagedKV:
    """Write each row's new K/V (k [R, T, kvh, d]) into its blocks at
    positions seq_len .. seq_len+T-1, in place; returns ``pk``. Positions
    past a row's allocated blocks land in the garbage block (unallocated
    table entries are 0, and logical blocks past M go there
    explicitly)."""
    B = pk.block_size
    R, T = k.shape[0], k.shape[1]
    lens = pk.seq_lens.long()
    tables = pk.block_tables.long()
    if T == 1:
        r = torch.arange(R, device=k.device)
        bidx = tables[r, lens // B]
        boff = lens % B
        pk.kp.index_put_((bidx, boff), k[:, 0].to(pk.kp.dtype))
        pk.vp.index_put_((bidx, boff), v[:, 0].to(pk.vp.dtype))
        return pk
    M = tables.shape[1]
    r = torch.arange(R, device=k.device)[:, None]
    pos = lens[:, None] + torch.arange(T, device=k.device)[None, :]
    lb = pos // B
    bidx = torch.where(lb < M, tables[r, lb.clamp(0, M - 1)],
                       torch.zeros_like(lb))
    boff = pos % B
    pk.kp.index_put_((bidx, boff), k.to(pk.kp.dtype))
    pk.vp.index_put_((bidx, boff), v.to(pk.vp.dtype))
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
      multi-query rows take the dense gather;
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
        if mode != "grid":
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


class _Request:
    """Queued or running request. ``key`` is the row's sampling key
    [seed, counter] (uint32): each emitted token, at prefill or at a
    decode tick, advances the counter by one, so a preempted request that
    re-prefills continues the same stream."""
    __slots__ = ("request_id", "prompt", "max_new", "eos", "tokens",
                 "blocks", "prefix", "prefix_lps", "admit_seq",
                 "temperature", "top_k", "top_p", "key", "lps",
                 "prefill_pos", "stop", "trim", "rep", "deadline",
                 "t_submit")

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


class PagedEngine:
    """Continuous-batching serving engine for Llama-family CausalLMs.

    submit() enqueues requests at any time; each step() admits what fits
    (slot + blocks), prefills, and advances every active slot one token.
    Finished requests free their blocks at once, so capacity recycles
    mid-stream. The pools live on the model's device: on a CUDA model a
    decode tick launches the ragged paged kernel once per layer.

    The constructor keeps the JAX package's signature and defaults.
    ``fused_tick=False`` is the only tick this slice has: the default
    ``True``, and ``ring_mode`` / ``delta_transitions`` / ``patch_fuse`` /
    ``ticks_per_dispatch > 1`` with it, raise ``NotImplementedError``, as
    do ``spec_tokens > 0`` and ``tick_profile=True``.
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
        later = []
        if fused_tick or ring_mode or delta_transitions or patch_fuse \
                or int(ticks_per_dispatch) > 1:
            later.append("the device-resident tick (fused_tick=True, "
                         "ring_mode, delta_transitions, patch_fuse, "
                         "ticks_per_dispatch > 1) comes with slice A4(b)-(c)")
        if int(spec_tokens) > 0:
            later.append("speculative ticks (spec_tokens > 0) come with "
                         "slice A4(d)")
        if tick_profile:
            later.append("the tick-phase profiler (tick_profile=True) comes "
                         "with slice A4(e)")
        if later:
            raise NotImplementedError(
                "; ".join(later) + " of the port; pass fused_tick=False for "
                "the host tick")
        cfg = model.config
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
        self.block_refs: Dict[int, int] = {}         # live owner count
        self.cached_free: Dict[int, None] = {}       # LRU, insertion order
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
                      "cancellations", "rejected", "h2d_upload_bytes",
                      "dispatches")}
        self._h_decode = reg.histogram("paged_decode_step_ms",
                                       buckets=obs.SERVING_MS_BUCKETS,
                                       **self._obs_labels)
        self._h_wait = reg.histogram("paged_queue_wait_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **self._obs_labels)
        self._h_bytes = reg.histogram("paged_h2d_bytes",
                                      buckets=obs.BYTES_BUCKETS,
                                      **self._obs_labels)
        # request-scoped tracing hook: a callable ``(request_id, kind,
        # **fields)`` the engine reports each request's lifecycle to
        # (queue enter, slot take, prefill chunks, ticks, preemption,
        # finish/abort). None keeps the engine trace-free.
        self.trace_sink = None
        # model forwards (prefills, chunks, ticks) and host-to-device
        # mirror uploads with their bytes
        self.dispatch_count = 0
        self.h2d_uploads = 0
        self.h2d_upload_bytes = 0

    def _new_pools(self):
        """Fresh pools, host mirrors and seen masks (construction and
        ``hard_reset``)."""
        cfg = self.model.config
        kvh, d = cfg.num_key_value_heads, cfg.head_dim
        shape = (self.P, self.B, kvh, d)
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
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def _decode_step(self, tables, lens, last_tokens, keys, temps, tks, tps,
                     reps, active):
        logits, _ = self.model(last_tokens[:, None],
                               kv_caches=self._caches(tables, lens),
                               positions=lens[:, None])
        row = repetition_penalty_rows(logits[:, -1].float(), self.seen,
                                      reps)
        nxt, lps, new_keys = sample_token_rows(row, keys, temps, tks, tps)
        # active-guarded: inactive rows (idle or mid-chunk-prefill) sample
        # garbage that must not enter their masks
        rows = torch.arange(self.R, device=self.device)
        self.seen[rows, nxt] |= active
        return nxt, lps, new_keys

    @torch.inference_mode()
    def _decode_step_greedy(self, tables, lens, last_tokens, reps, active):
        """Argmax-only tick for the all-greedy batch (no filtering, no
        noise); the repetition penalty still applies."""
        logits, _ = self.model(last_tokens[:, None],
                               kv_caches=self._caches(tables, lens),
                               positions=lens[:, None])
        raw = repetition_penalty_rows(logits[:, -1].float(), self.seen,
                                      reps)
        nxt = torch.argmax(raw, dim=-1)
        lps = torch.log_softmax(raw, dim=-1).gather(1, nxt[:, None])[:, 0]
        rows = torch.arange(self.R, device=self.device)
        self.seen[rows, nxt] |= active
        return nxt, lps

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
        self._submit_counter += 1
        if seed is None:
            # monotone per-engine counter: repeated unseeded sampled
            # requests get distinct streams
            seed = self._submit_counter
        timeout_s = timeout_s if timeout_s is not None \
            else self.default_timeout_s
        deadline = (time.monotonic() + timeout_s) \
            if timeout_s is not None else None
        resume = [int(t) for t in (resume_tokens or ())]
        if resume and ids[-len(resume):] != resume:
            raise ValueError(
                "resume_tokens must be the tail of input_ids (the "
                "preemption fold: prompt' = prompt + emitted)")
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
        cache: the router's "is this replica warm" probe."""
        if not self.prefix_caching or not digest:
            return False
        try:
            raw = bytes.fromhex(digest)
        except ValueError:
            return False
        return raw in self.prefix_cache

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

    def _grow_blocks(self, slot_id: int, need: int) -> bool:
        """Grow a slot's table to ``need`` blocks; False when the pool
        cannot serve."""
        slot = self.slots[slot_id]
        while len(slot.blocks) < need:
            b = self._alloc_block()
            if b is None:
                return False
            slot.blocks.append(b)
            self.block_tables[slot_id, len(slot.blocks) - 1] = b
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
        requeued = _Request(s.request_id, s.prompt + s.tokens,
                            s.max_new - len(s.tokens), s.eos,
                            s.temperature, s.top_k, s.top_p,
                            s.key.copy(),
                            prefix=s.prefix + s.tokens,
                            prefix_lps=s.prefix_lps + s.lps,
                            stop=s.stop, rep=s.rep, deadline=s.deadline)
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
        (checked once per tick; a forward is never interrupted)."""
        now = time.monotonic()
        for req in [r for r in self.queue
                    if r.deadline is not None and now > r.deadline]:
            self.queue.remove(req)
            self._abort(req, "timeout")
        for i in range(self.R):
            s = self.slots[i]
            if s is not None and s.deadline is not None \
                    and now > s.deadline:
                self._abort(s, "timeout", slot_id=i)

    def cancel(self, request_id) -> bool:
        """Abort a queued or running request (client disconnect). Its
        blocks and slot free at once; no result is recorded. False if
        the request is unknown or already finished."""
        for req in self.queue:
            if req.request_id == request_id:
                self.queue.remove(req)
                self._abort(req, "cancelled")
                return True
        for i in range(self.R):
            s = self.slots[i]
            if s is not None and s.request_id == request_id:
                self._abort(s, "cancelled", slot_id=i)
                return True
        return False

    def health(self) -> Dict[str, Any]:
        """Stats snapshot for load balancers and probes: scheduler
        counters plus live occupancy (slots, blocks, queue depth)."""
        snap = dict(self.stats)
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
            results_pending=len(self.results),
            aborted=len(self.cancelled))
        return snap

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
        """Return the engine to its empty post-construction state: every
        queued or running request is dropped (the caller already failed
        them over), and the pools and seen masks are allocated fresh.
        Counters keep counting."""
        self._new_pools()
        self.slots = [None] * self.R
        self.queue = []
        self.results = {}
        self.logprobs = {}
        self.cancelled = {}
        self.prefix_cache = {}
        self._prefix_rev = {}
        self.block_refs = {}
        self.cached_free = {}
        obs.record_event("paged_hard_reset",
                         engine=self._obs_labels["engine"])

    def close(self, drain: bool = True):
        """``drain=True`` runs until every queued and in-flight request
        completes; ``drain=False`` aborts everything still pending,
        recording each as "cancelled"."""
        if drain:
            self.run()
            return
        for req in list(self.queue):
            self.queue.remove(req)
            self._abort(req, "cancelled")
        for i in range(self.R):
            if self.slots[i] is not None:
                self._abort(self.slots[i], "cancelled", slot_id=i)

    # ------------------------------------------------------------ ticks
    def step(self):
        """One scheduler tick: expire overdue requests, admit every queued
        request that fits, advance one prefill chunk per prefilling slot,
        then one decode for all prefill-complete slots."""
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
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.tokens]
        if not active:
            return
        return self._decode_host(active)

    def _decode_host(self, active):
        """The per-tick host path: upload every mirror, run the model once
        for all slots, read back the tokens, and run stop/eos/budget
        bookkeeping in Python."""
        t_decode = time.perf_counter()
        last = np.zeros((self.R,), np.int64)
        for i in active:
            last[i] = self.slots[i].tokens[-1]
        act_mask = np.zeros((self.R,), bool)
        act_mask[active] = True
        self.dispatch_count += 1
        self._count("dispatches")
        if np.all(self.temps[active] <= 0.0):
            # all-greedy tick: no filtering, no noise, no key read-back
            nxt, lps = self._decode_step_greedy(
                self._up(self.block_tables), self._up(self.seq_lens),
                self._up(last), self._up(self.reps), self._up(act_mask))
        else:
            nxt, lps, new_keys = self._decode_step(
                self._up(self.block_tables), self._up(self.seq_lens),
                self._up(last), self._up(self.keys.astype(np.int64)),
                self._up(self.temps), self._up(self.top_ks),
                self._up(self.top_ps), self._up(self.reps),
                self._up(act_mask))
            self.keys = new_keys.cpu().numpy().astype(np.uint32)
        nxt = nxt.cpu().numpy()
        lps = lps.cpu().numpy()
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
