"""Checksummed host-RAM KV spill tier (counterpart of
``paddle_tpu/serving/kvspill.py``; reference: tiered KV caching in
production LLM serving — vLLM's CPU swap space, SGLang's hierarchical
radix cache — restated over PagedEngine's chunk-grid digest chain).

A :class:`KVSpillArena` is a bounded host-RAM store of prefix-cache
spans, keyed by the SAME SHA-256 chain digests the device-side
``prefix_cache`` files blocks under. Two producers feed it:

- **eviction spill** — when block pressure evicts a registered span
  out of ``cached_free`` (``PagedEngine._alloc_block``), the span's KV
  blocks are copied D2H into the arena first;
- **drain spill** — ``PagedEngine.spill_parked()`` at gateway drain
  (SIGTERM rolling restart) banks every still-parked span.

One consumer: a warm MISS in the device cache at admission
(``PagedEngine._arena_restore``) probes the arena and re-uploads the
span — one batched H2D scatter into freshly allocated blocks —
instead of re-prefilling it.

The arena deliberately lives OUTSIDE the engine: the gateway owns it
and re-attaches it to whatever engine ``_make_worker`` wires up, so a
supervisor rebuild (``engine_factory`` swap or ``hard_reset``) comes
back WARM — the crashed replica's spilled spans survive in host RAM.

**Integrity is the contract.** Every payload record carries a crc32
plus metadata (digest chain, token count, block geometry, the
producing engine's ``prefix_generation``). On the way back, any
checksum mismatch, truncated record, or geometry skew drops the
record, counts it (``kv_spill_checksum_failures_total`` /
``kv_spill_drops_total``), and the caller falls back to normal
re-prefill — a corrupted span may cost a prefill, never a token.
Because digests are content-addressed over the token chain and
chunk-grid recompute is bit-exact, a restored span's KV is
byte-identical to what re-prefill would have computed: greedy streams
are pinned bitwise identical spill-on vs spill-off across every path
(tests/test_kvspill.py).

Payloads are deduplicated along the digest chain: one record per
dying chain, keyed by the LONGEST digest; every shorter sub-span
digest becomes an index alias into the same payload (sub-span KV is a
block-prefix of the long span's). Capacity is bounded in bytes; LRU
payload records are evicted to make room, and a span that cannot fit
is refused and counted (``kv_spill_drops_total``) — the fallback
ladder again.

Chaos sites (``utils/faults.py``): ``spill_corrupt`` flips a stored
payload byte AFTER its crc is banked (silent bit rot — the take-side
checksum must catch it), ``spill_slow`` sleeps
``PADDLE_TPU_FAULT_SPILL_SLOW_S`` in the arena copy paths (host
memory-bandwidth contention), ``spill_drop`` refuses a store
(capacity pressure / allocation failure).
"""
from __future__ import annotations

import itertools
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import faults
from ..utils import observability as obs

__all__ = ["KVSpillArena", "DEFAULT_CAPACITY_BYTES"]

DEFAULT_CAPACITY_BYTES = 256 << 20

_arena_ids = itertools.count()


class _Record:
    """One payload record: the packed KV bytes of a chain's LONGEST
    span plus the integrity/provenance metadata the take-side
    validation ladder checks."""

    __slots__ = ("payload", "crc", "nbytes", "tokens", "geometry",
                 "prefix_generation", "aliases", "t_spilled")

    def __init__(self, payload: bytes, crc: int, tokens: int,
                 geometry: tuple, prefix_generation: int):
        self.payload = payload
        self.crc = crc
        self.nbytes = len(payload)
        self.tokens = int(tokens)
        self.geometry = tuple(geometry)
        self.prefix_generation = int(prefix_generation)
        self.aliases: List[bytes] = []   # sub-span digests indexed here
        self.t_spilled = time.monotonic()


class KVSpillArena:
    """Bounded, thread-safe, LRU host-RAM store of spilled prefix
    spans. All byte accounting is payload bytes (metadata overhead is
    negligible next to KV). ``geometry`` is the engine's
    ``(layers, block_size, kv_heads, head_dim, dtype, chunk)`` tuple —
    a record is only ever restored into an engine with the EXACT
    geometry that produced it (anything else is a counted drop)."""

    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY_BYTES,
                 *, name: Optional[str] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.name = name or f"spill{next(_arena_ids)}"
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.RLock()
        # digest -> record (LRU order; key is the chain's longest digest)
        self._records: "Dict[bytes, _Record]" = {}
        # EVERY known digest (records + aliases) -> (record key, tokens)
        self._index: Dict[bytes, Tuple[bytes, int]] = {}
        self._occupancy = 0
        # monotonic mutation counter for gossip (folded into the
        # gateway's /debugz/prefix generation so an if_gen poller sees
        # spill-tier changes too). Never reset.
        self._gen = 0
        self.lru_evictions = 0
        labels = dict(labels or {}, arena=self.name)
        reg = obs.registry()
        self._c_spans = reg.counter("kv_spill_spans_total", **labels)
        self._c_bytes = reg.counter("kv_spill_bytes_total", **labels)
        self._c_hits = reg.counter("kv_spill_hits_total", **labels)
        self._c_drops = reg.counter("kv_spill_drops_total", **labels)
        self._c_crc = reg.counter("kv_spill_checksum_failures_total",
                                  **labels)
        self._g_occ = reg.gauge("kv_spill_occupancy_bytes", **labels)
        self._g_spans = reg.gauge("kv_spill_resident_spans", **labels)

    # ------------------------------------------------------------ helpers
    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def _set_gauges(self):
        self._g_occ.set(float(self._occupancy))
        self._g_spans.set(float(len(self._records)))

    def _forget(self, key: bytes, rec: _Record):
        """Drop a record and every alias pointing at it (lock held)."""
        self._occupancy -= rec.nbytes
        self._index.pop(key, None)
        for a in rec.aliases:
            ent = self._index.get(a)
            if ent is not None and ent[0] == key:
                del self._index[a]
        self._gen += 1
        self._set_gauges()

    def _evict_record(self, key: bytes):
        rec = self._records.pop(key, None)
        if rec is not None:
            self._forget(key, rec)

    # -------------------------------------------------------------- spill
    def spill(self, spans, fetch: Callable[[tuple], bytes],
              geometry: tuple, prefix_generation: int = 0) -> int:
        """Store a batch of dying spans. ``spans`` is a list of
        ``(digest bytes, block-id tuple)`` pairs — the prefix-cache
        entries about to be evicted (or parked spans at drain);
        ``fetch(blocks)`` is the engine's D2H gather returning the
        packed payload bytes for those blocks. Spans whose entry is a
        block-prefix of a longer span stored in the SAME call become
        aliases of that record (one D2H copy per chain, not per span).
        Returns the number of payload records stored."""
        geometry = tuple(geometry)
        block_size = int(geometry[1])
        stored = 0
        with self._lock:
            ordered = sorted(
                ((bytes(k), tuple(e)) for k, e in spans),
                key=lambda kv: len(kv[1]), reverse=True)
            roots: List[Tuple[bytes, tuple]] = []
            for key, entry in ordered:
                tokens = len(entry) * block_size
                if key in self._index:
                    # already resident (content-addressed: same digest
                    # chain => byte-identical KV) — refresh LRU only
                    rk = self._index[key][0]
                    rec = self._records.pop(rk, None)
                    if rec is not None:
                        self._records[rk] = rec
                    continue
                root = next((rk for rk, re in roots
                             if re[:len(entry)] == entry), None)
                if root is not None:
                    self._index[key] = (root, tokens)
                    self._records[root].aliases.append(key)
                    self._gen += 1
                    continue
                if faults.inject("spill_drop", arena=self.name,
                                 digest=key.hex()[:12]):
                    self._c_drops.inc()
                    continue
                if faults.inject("spill_slow", arena=self.name,
                                 op="spill"):
                    time.sleep(faults.spill_slow_seconds())
                payload = bytes(fetch(entry))
                if len(payload) > self.capacity_bytes:
                    self._c_drops.inc()      # can never fit: refuse
                    continue
                while self._occupancy + len(payload) \
                        > self.capacity_bytes:
                    old = next(iter(self._records))
                    self._evict_record(old)
                    self.lru_evictions += 1
                crc = zlib.crc32(payload)
                if faults.inject("spill_corrupt", arena=self.name,
                                 digest=key.hex()[:12]):
                    # silent bit rot AFTER the checksum banked: the
                    # take-side crc must catch this, never a token
                    pos = len(payload) // 2
                    payload = (payload[:pos]
                               + bytes([payload[pos] ^ 0xFF])
                               + payload[pos + 1:])
                rec = _Record(payload, crc, tokens, geometry,
                              prefix_generation)
                self._records[key] = rec
                self._index[key] = (key, tokens)
                self._occupancy += rec.nbytes
                self._c_spans.inc()
                self._c_bytes.inc(rec.nbytes)
                self._gen += 1
                roots.append((key, entry))
                stored += 1
            self._set_gauges()
        return stored

    def put(self, digest: bytes, payload: bytes, tokens: int,
            geometry: tuple, prefix_generation: int = 0) -> bool:
        """Insert one payload already in hand — the wire-receive side
        of cross-replica transfer (``kvxfer.inject_span``). Mirrors
        ``spill()``'s capacity ladder: a payload that can never fit is
        refused (False — the caller counts the fallback and
        re-prefills), LRU records are evicted to make room, and the
        crc is banked over the bytes as received. A digest already
        resident just refreshes LRU (content-addressed: same digest
        => byte-identical KV)."""
        digest = bytes(digest)
        payload = bytes(payload)
        with self._lock:
            ent = self._index.get(digest)
            if ent is not None:
                rec = self._records.pop(ent[0], None)
                if rec is not None:
                    self._records[ent[0]] = rec
                return True
            if len(payload) > self.capacity_bytes:
                self._c_drops.inc()          # can never fit: refuse
                return False
            while self._occupancy + len(payload) \
                    > self.capacity_bytes:
                old = next(iter(self._records))
                self._evict_record(old)
                self.lru_evictions += 1
            rec = _Record(payload, zlib.crc32(payload), tokens,
                          tuple(geometry), prefix_generation)
            self._records[digest] = rec
            self._index[digest] = (digest, rec.tokens)
            self._occupancy += rec.nbytes
            self._c_spans.inc()
            self._c_bytes.inc(rec.nbytes)
            self._gen += 1
            self._set_gauges()
            return True

    # -------------------------------------------------------------- probe
    def probe(self, digest: bytes) -> Optional[int]:
        """Token count of the span stored under ``digest`` (record or
        alias), or None. Pure peek — no counters, no LRU touch."""
        with self._lock:
            ent = self._index.get(bytes(digest))
            return None if ent is None else ent[1]

    def take(self, digest: bytes,
             geometry: tuple) -> Optional[Tuple[bytes, int]]:
        """Validated fetch for restore: returns ``(payload bytes,
        record tokens)`` — ALWAYS the full record's bytes and token
        count, even for an alias take (the caller slices the leading
        blocks its shorter span needs) — or None after dropping the
        record on any integrity failure (checksum mismatch, truncated
        record, geometry skew). The caller's fallback is normal
        re-prefill."""
        if faults.inject("spill_slow", arena=self.name, op="take"):
            time.sleep(faults.spill_slow_seconds())
        digest = bytes(digest)
        with self._lock:
            ent = self._index.get(digest)
            if ent is None:
                return None
            rk, _ = ent
            rec = self._records.get(rk)
            if rec is None:                  # torn index: self-heal
                self._index.pop(digest, None)
                return None
            if rec.geometry != tuple(geometry):
                self._c_drops.inc()          # geometry skew
                self._evict_record(rk)
                return None
            if len(rec.payload) != rec.nbytes:
                self._c_drops.inc()          # truncated record
                self._evict_record(rk)
                return None
            if zlib.crc32(rec.payload) != rec.crc:
                self._c_crc.inc()            # bit rot caught
                self._evict_record(rk)
                return None
            rec2 = self._records.pop(rk)     # refresh LRU
            self._records[rk] = rec2
            self._c_hits.inc()
            return rec.payload, rec.tokens

    # ------------------------------------------------------------- gossip
    def digest_hexes(self) -> List[str]:
        """Every digest restorable from the arena (records + aliases),
        hex-encoded — the spilled tier ``/debugz/prefix`` advertises."""
        with self._lock:
            return sorted(k.hex() for k in self._index)

    # ------------------------------------------------------------ exports
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "arena": self.name,
                "capacity_bytes": self.capacity_bytes,
                "occupancy_bytes": self._occupancy,
                "occupancy_frac": round(
                    self._occupancy / max(self.capacity_bytes, 1), 4),
                "records": len(self._records),
                "digests": len(self._index),
                "generation": self._gen,
                "lru_evictions": self.lru_evictions,
                "spans": int(self._c_spans.value),
                "bytes": int(self._c_bytes.value),
                "hits": int(self._c_hits.value),
                "drops": int(self._c_drops.value),
                "checksum_failures": int(self._c_crc.value),
            }
