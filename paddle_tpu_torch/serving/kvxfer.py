"""Cross-replica KV transfer wire format (counterpart of
``paddle_tpu/serving/kvxfer.py``; reference: Mooncake-style KV movement
between serving processes, where shipping checksummed cache bytes, not
recompute, is the cheap currency — restated over the spill arena's
integrity contract).

One span on the wire is one self-describing record::

    b"KVX1" | u32 header_len | header json | payload bytes

The header carries the span's chunk-chain digest (the SAME key the
device ``prefix_cache`` and the host :class:`~.kvspill.KVSpillArena`
file it under), its token count, the producing engine's geometry tuple
``(layers, block_size, kv_heads, head_dim, dtype, chunk)``, the
payload byte count and a crc32 banked BEFORE the bytes touch the wire.
The payload is the spill serializer's packed ``(2L, n, B, kvh, d)``
buffer verbatim — :func:`export_span` lifts it straight out of an
arena record and :func:`inject_span` lands it into the receiver's
arena, so a transferred span restores through ``_arena_restore``'s one
batched H2D scatter exactly like a locally spilled one.

**The integrity ladder is the contract** (the spill arena's, extended over the
wire). Decode re-walks every rung — magic/truncation, header parse,
geometry skew, byte-count mismatch, crc32 — and ANY failure raises
:class:`XferError`; every caller's handler is the same: count the
fallback and re-prefill. A corrupted transfer may cost a prefill,
never a token: greedy streams are pinned bitwise identical
migration-on vs migration-off on every path.

Chaos sites (``utils/faults.py``): ``xfer_corrupt`` flips one payload
byte AFTER the header crc is banked (wire bit rot — the decode-side
crc must catch it), ``xfer_trunc`` cuts the encoded record short
(severed transfer mid-body). ``xfer_slow`` lives in the gateway's
``/kvz`` handler (the serving side of this module), bounded by the
fetcher's ``xfer_timeout_s``.

A replica of several ranks (``serving/tp_replica.py``) holds each span
as its ranks' parts, each rank's arena its own kv heads. Its records are
the whole model's all the same: :func:`join_heads` lays the ranks' parts
side by side along the heads (tp order) into the payload of the whole
geometry, and :func:`split_heads` cuts a received payload back into
them, so a record is the same whatever tp degree served it.

Counters (one set per ``gateway`` label, exported like every other
registry metric through ``/metrics`` and ``/metricsz``):
``kv_xfer_{spans,bytes,hits,fallbacks,checksum_failures}_total``.
"""
from __future__ import annotations

import json
import struct
import threading
from typing import Any, Dict, Optional, Tuple

from ..utils import faults
from ..utils import observability as obs

__all__ = ["XferError", "encode_span", "decode_span", "export_span",
           "inject_span", "counters_snapshot", "join_heads", "split_heads",
           "whole_geometry"]

MAGIC = b"KVX1"
_HEAD = struct.Struct("<I")

_COUNTER_NAMES = ("spans", "bytes", "hits", "fallbacks",
                  "checksum_failures")
_counters_lock = threading.Lock()
_counters: Dict[tuple, Dict[str, Any]] = {}


def _ctr(gateway: str) -> Dict[str, Any]:
    """The per-gateway ``kv_xfer_*_total`` counter set (memoized —
    the registry dedupes by (name, labels) anyway, this just skips
    the lookup on the hot path)."""
    key = (gateway,)
    with _counters_lock:
        got = _counters.get(key)
        if got is None:
            reg = obs.registry()
            got = {n: reg.counter(f"kv_xfer_{n}_total",
                                  gateway=gateway)
                   for n in _COUNTER_NAMES}
            _counters[key] = got
        return got


def counters_snapshot(gateway: str) -> Dict[str, int]:
    """Current ``kv_xfer_*`` values for one gateway label (what the
    loadgen banks into the serving rung)."""
    return {f"kv_xfer_{n}_total": int(c.value)
            for n, c in _ctr(gateway).items()}


# bytes an element of a spill payload's dtype (the engine's names)
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def _heads_view(payload: bytes, geometry: tuple):
    """A payload as a uint8 array [2L, n, B, kvh, d x itemsize]."""
    import numpy as np
    layers, block, kvh, d, dtype = geometry[:5]
    row = block * kvh * d * _ITEMSIZE[dtype]
    arr = np.frombuffer(bytes(payload), np.uint8)
    n = arr.size // (2 * layers * row)
    return arr.reshape(2 * layers, n, block, kvh, d * _ITEMSIZE[dtype])


def whole_geometry(geometry: tuple, parts: int) -> tuple:
    """The geometry of ``parts`` ranks' spans of ``geometry`` joined
    along the kv heads."""
    g = list(geometry)
    g[2] = int(g[2]) * int(parts)
    return tuple(g)


def join_heads(payloads, geometry: tuple) -> bytes:
    """The ranks' payloads of one span (each of ``geometry``, its own kv
    heads; in tp order) as one payload of the whole model's heads."""
    import numpy as np
    return np.concatenate([_heads_view(p, geometry) for p in payloads],
                          axis=3).tobytes()


def split_heads(payload: bytes, geometry: tuple, parts: int):
    """A whole-model payload of ``geometry`` cut into ``parts`` payloads
    of consecutive kv heads (tp order): each rank's part."""
    import numpy as np
    return [np.ascontiguousarray(a).tobytes() for a in np.split(
        _heads_view(payload, geometry), parts, axis=3)]


class XferError(ValueError):
    """One failed rung of the wire-decode integrity ladder. ``rung``
    names which: ``truncated`` / ``header`` / ``geometry`` /
    ``checksum``. The only correct handling is the fallback the
    ladder promises — count it and re-prefill."""

    def __init__(self, rung: str, msg: str):
        super().__init__(msg)
        self.rung = rung


def encode_span(digest_hex: str, tokens: int, geometry: tuple,
                payload: bytes, *, gateway: str = "xfer") -> bytes:
    """Pack one span for the wire. The crc is banked over the TRUE
    payload before the chaos sites run, so an injected ``xfer_corrupt``
    flip or ``xfer_trunc`` cut is exactly what silent wire damage looks
    like to the receiver: a record whose ladder fails."""
    payload = bytes(payload)
    import zlib
    hdr = json.dumps({
        "digest": str(digest_hex), "tokens": int(tokens),
        "nbytes": len(payload), "crc": zlib.crc32(payload),
        "geometry": list(geometry),
    }).encode()
    blob = MAGIC + _HEAD.pack(len(hdr)) + hdr + payload
    c = _ctr(gateway)
    c["spans"].inc()
    c["bytes"].inc(len(blob))
    if faults.inject("xfer_corrupt", gateway=gateway,
                     digest=str(digest_hex)[:12]):
        # one payload byte flipped AFTER the crc banked: the decode
        # side must catch it, drop the span, and re-prefill
        pos = len(blob) - max(len(payload) // 2, 1)
        blob = blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]
    if faults.inject("xfer_trunc", gateway=gateway,
                     digest=str(digest_hex)[:12]):
        blob = blob[:len(blob) // 2]     # severed mid-body
    return blob


def decode_span(blob: bytes, geometry: tuple, *,
                gateway: str = "xfer") -> Tuple[str, int, bytes]:
    """Walk the wire-decode ladder; returns ``(digest_hex, tokens,
    payload)`` or raises :class:`XferError` (checksum rungs also count
    ``kv_xfer_checksum_failures_total``). ``geometry`` is the
    RECEIVER's — a span from a skewed engine is refused here, before
    any bytes land in the arena."""
    import zlib
    blob = bytes(blob)
    if len(blob) < len(MAGIC) + _HEAD.size \
            or blob[:len(MAGIC)] != MAGIC:
        raise XferError("truncated", "short or unmagical record")
    (hlen,) = _HEAD.unpack_from(blob, len(MAGIC))
    body = len(MAGIC) + _HEAD.size
    if len(blob) < body + hlen:
        raise XferError("truncated", "record cut inside its header")
    try:
        hdr = json.loads(blob[body:body + hlen])
        digest = str(hdr["digest"])
        tokens = int(hdr["tokens"])
        nbytes = int(hdr["nbytes"])
        crc = int(hdr["crc"])
        geo = tuple(hdr["geometry"])
    except (ValueError, KeyError, TypeError):
        raise XferError("header", "unparseable span header")
    if geo != tuple(tuple(geometry)):
        raise XferError(
            "geometry",
            f"span geometry {geo} != engine geometry "
            f"{tuple(geometry)}")
    payload = blob[body + hlen:]
    if len(payload) != nbytes:
        raise XferError("truncated",
                        f"payload {len(payload)}B != declared "
                        f"{nbytes}B")
    if zlib.crc32(payload) != crc:
        _ctr(gateway)["checksum_failures"].inc()
        raise XferError("checksum", "payload crc32 mismatch")
    return digest, tokens, payload


def export_span(arena, digest_hex: str, geometry: tuple, *,
                gateway: str = "xfer") -> Optional[bytes]:
    """Lift one arena record onto the wire (the ``GET /kvz`` body).
    Rides the arena's own validated ``take`` — a locally bit-rotted
    record is dropped THERE and never shipped. ``None`` when the
    digest isn't restorable (the fetcher falls back to re-prefill)."""
    try:
        raw = bytes.fromhex(digest_hex)
    except ValueError:
        return None
    got = arena.take(raw, tuple(geometry))
    if got is None:
        _ctr(gateway)["fallbacks"].inc()
        return None
    payload, tokens = got
    return encode_span(digest_hex, tokens, geometry, payload,
                       gateway=gateway)


def inject_span(arena, blob: bytes, geometry: tuple, *,
                gateway: str = "xfer") -> Optional[Tuple[str, int]]:
    """Land a wire record in the receiving arena: decode ladder, then
    the arena's own capacity ladder (over-capacity refusal is a
    counted fallback too). Returns ``(digest_hex, tokens)`` on
    success — the span is now restorable by ``_arena_restore`` exactly
    like a local spill — or ``None`` after counting the fallback; the
    caller re-prefills and the stream stays bitwise identical."""
    c = _ctr(gateway)
    try:
        digest_hex, tokens, payload = decode_span(
            blob, geometry, gateway=gateway)
        raw = bytes.fromhex(digest_hex)
    except XferError:
        c["fallbacks"].inc()
        return None
    except ValueError:
        c["fallbacks"].inc()
        return None
    if not arena.put(raw, payload, tokens, tuple(geometry)):
        c["fallbacks"].inc()         # over-capacity refusal
        return None
    c["hits"].inc()
    return digest_hex, tokens
