"""Per-request latency waterfalls as Chrome-trace/perfetto JSON
(the request layer): turn the gateway's
``reqtrace_*.json`` ring dumps — and, when present, the engines'
``tickphase_*.json`` phase rings — into one timeline loadable at
https://ui.perfetto.dev or chrome://tracing:

    python -m paddle_tpu_torch.tools.trace_export RUNDIR_OR_FILES... -o trace.json
    python -m paddle_tpu_torch.tools.trace_export gwA_dir gwB_dir -o trace.json   # fleet

Every source process (``<gateway>/<replica>`` from the ring labels)
becomes one trace PROCESS; every request becomes a THREAD inside it,
carrying nested duration spans:

    request <outcome>                 accept -> last event
      queue_wait                      queue_enter -> slot_take
      prefill                         slot_take -> prefill_done
      decode                          first_token -> finish

plus instant markers for the interesting punctual events (first_token,
preempt, shed, and the fleet failover hops: proxy_to / peer_fail /
resubmit / resume_offset / migrate_out). Cross-process stitching
reuses ``trace_report``'s fleet-merge wall-clock convention verbatim —
an event's absolute time is ``wall_accept + t_ms/1e3`` (entries carry
the accept wall clock; event times are offsets from it) — so a
frontend -> gwA -> gwB mid-stream failover renders as one left-to-
right waterfall across three process lanes with no clock fixup.

Tick-phase rings ride in as one extra process per source engine: each
recorded tick is a span on a per-phase thread lane (host / h2d /
dispatch / device / drain stacked under the tick wall), wall-anchored
via the dump's ``dumped_wall - clock_now`` offset, the same mapping
``fleet_dash`` uses for flight-recorder markers.

``--check`` validates the emitted document against the Chrome trace
event schema (``validate_chrome_trace``) and exits non-zero on any
problem — the shape tests pin.

The port's copy of ``tools/trace_export.py``, with the same command line and
output; it imports ``paddle_tpu_torch`` only (no jax), so it reads a
chip run's dumps on the card machine. Run it as ``python -m
paddle_tpu_torch.tools.trace_export``.
"""
import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional


from paddle_tpu_torch.tools.trace_report import load_rings

# punctual timeline markers worth a perfetto instant (everything else
# is either a span boundary or per-tick noise)
INSTANT_KINDS = (
    "first_token", "preempt", "shed", "queue_expire",
    "replica_fail", "watchdog_fire", "resubmit", "resume_offset",
    "proxy_to", "peer_fail", "migrate_out",
    "breaker_open", "breaker_half_open", "breaker_close",
)

# per-source cap on exported tick spans: a long soak's 1024-deep ring
# x 5 phases would dwarf the request lanes; the newest ticks are the
# ones a capture just profiled
MAX_TICKS_PER_SOURCE = 256


def _us(wall_s: float) -> float:
    """Epoch seconds -> Chrome trace microseconds."""
    return wall_s * 1e6


def _span(name: str, cat: str, ts_us: float, dur_us: float,
          pid: str, tid: str, args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, cat: str, ts_us: float, pid: str, tid: str,
             args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
          "ts": round(ts_us, 3), "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _meta(name: str, pid: str, tid: Optional[str],
          value: str) -> dict:
    ev: Dict[str, Any] = {"name": name, "ph": "M", "pid": pid,
                          "args": {"name": value}}
    ev["tid"] = tid if tid is not None else 0
    return ev


def _entry_events(entry: dict, pid: str) -> List[dict]:
    """One ring entry -> its waterfall events (empty for entries whose
    timeline was dropped by tail retention — only the retained ones
    can render)."""
    evs = entry.get("events") or []
    if not evs:
        return []
    rid = str(entry["request_id"])
    w0 = float(entry.get("wall_accept") or 0.0)
    t_last = max(t for t, _, _ in evs)
    marks: Dict[str, float] = {}
    for t, kind, _ in evs:
        marks.setdefault(kind, t)     # first occurrence wins

    def abs_us(t_ms: float) -> float:
        return _us(w0 + t_ms / 1e3)

    out: List[dict] = []
    args = {"slo": entry.get("slo"), "outcome": entry.get("outcome"),
            "tokens": entry.get("tokens"),
            "ttft_ms": entry.get("ttft_ms"),
            "failovers": entry.get("failovers")}
    if entry.get("phase_share") is not None:
        args["phase_share"] = entry["phase_share"]
    out.append(_span(f"request {entry.get('outcome')}", "request",
                     abs_us(0.0), (t_last / 1e3) * 1e6, pid, rid,
                     args={k: v for k, v in args.items()
                           if v is not None}))
    for name, a, b in (
            ("queue_wait", "queue_enter", "slot_take"),
            ("prefill", "slot_take", "prefill_done"),
            ("decode", "first_token", "finish")):
        ta, tb = marks.get(a), marks.get(b)
        if name == "decode" and ta is not None and tb is None:
            tb = t_last               # no finish event: decode ran out
        if ta is None or tb is None or tb < ta:
            continue
        out.append(_span(name, "phase", abs_us(ta),
                         ((tb - ta) / 1e3) * 1e6, pid, rid))
    # chunked prefill: each chunk is its own nested slice
    chunks = [(t, f) for t, k, f in evs if k == "prefill_chunk"]
    for i, (t, f) in enumerate(chunks):
        t_end = chunks[i + 1][0] if i + 1 < len(chunks) \
            else marks.get("prefill_done", t)
        out.append(_span(f"chunk[{i}]", "prefill_chunk", abs_us(t),
                         max(t_end - t, 0.0) / 1e3 * 1e6, pid, rid,
                         args={k: v for k, v in f.items()}))
    for t, kind, fields in evs:
        if kind in INSTANT_KINDS:
            out.append(_instant(kind, "event", abs_us(t), pid, rid,
                                args=dict(fields) or None))
    return out


def load_tickphase(paths: List[str]) -> List[dict]:
    """Expand dirs to tickphase_*.json and schema-validate (invalid
    docs are skipped with a warning, like ``load_rings``)."""
    from paddle_tpu_torch.utils.observability import validate_tickphase_doc
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(
                os.path.join(p, "tickphase_*.json"))))
        elif os.path.basename(p).startswith("tickphase_"):
            files.append(p)
    docs = []
    for f in files:
        try:
            with open(f) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"warning: skipping {f}: {e}", file=sys.stderr)
            continue
        problems = validate_tickphase_doc(doc)
        if problems:
            print(f"warning: {f} failed schema check "
                  f"({problems[0]}; {len(problems)} total) — skipped",
                  file=sys.stderr)
            continue
        doc["_file"] = os.path.basename(f)
        docs.append(doc)
    return docs


def _tickphase_events(doc: dict) -> List[dict]:
    """One tickphase dump -> per-phase tick spans. The engine clock is
    mapped to wall time with the dump-instant offset
    (``dumped_wall - clock_now``) — exact for the monotonic default
    clock, best-effort for an injected one."""
    src = doc["_file"].replace("tickphase_", "").replace(".json", "")
    pid = f"tickphase:{src}"
    offset = float(doc.get("dumped_wall", 0.0)) \
        - float(doc.get("clock_now", 0.0))
    out: List[dict] = [_meta("process_name", pid, None, pid)]
    entries = doc.get("entries") or []
    dropped = len(entries) - MAX_TICKS_PER_SOURCE
    if dropped > 0:
        print(f"note: {doc['_file']}: exporting newest "
              f"{MAX_TICKS_PER_SOURCE} of {len(entries)} ticks "
              f"({dropped} older dropped)", file=sys.stderr)
        entries = entries[-MAX_TICKS_PER_SOURCE:]
    for lane in ("tick",) + tuple(
            k for k in ("host", "h2d", "dispatch", "device", "drain")):
        out.append(_meta("thread_name", pid, lane, lane))
    for rec in entries:
        t_end = offset + float(rec["t"])
        wall_ms = float(rec["wall_ms"])
        t0 = t_end - wall_ms / 1e3
        out.append(_span(f"tick {rec['tick']}", "tick", _us(t0),
                         wall_ms * 1e3, pid, "tick",
                         args={"dispatches": rec.get("dispatches"),
                               "active": rec.get("active"),
                               "bytes": rec.get("bytes"),
                               "patches": rec.get("patches")}))
        # phases stacked left-to-right inside the tick window (the
        # real interleave is finer; the widths are exact)
        cur = t0
        for p in ("host", "h2d", "dispatch", "device", "drain"):
            d_ms = float(rec.get(f"{p}_ms", 0.0))
            if d_ms <= 0.0:
                continue
            out.append(_span(p, "tick_phase", _us(cur), d_ms * 1e3,
                             pid, p))
            cur += d_ms / 1e3
    return out


def export(ring_docs: List[dict],
           tick_docs: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Build the Chrome trace document."""
    events: List[dict] = []
    sources: List[str] = []
    requests = set()
    for d in ring_docs:
        lbl = d.get("labels") or {}
        pid = (f"{lbl.get('gateway', '?')}/"
               f"{lbl.get('replica', '?')}")
        sources.append(pid)
        events.append(_meta("process_name", pid, None, pid))
        for e in d["entries"]:
            evs = _entry_events(e, pid)
            if evs:
                rid = str(e["request_id"])
                requests.add(rid)
                events.append(_meta("thread_name", pid, rid, rid))
                events.extend(evs)
    for d in tick_docs or []:
        events.extend(_tickphase_events(d))
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "tools/trace_export.py",
            "sources": sources,
            "tick_sources": [d["_file"] for d in tick_docs or []],
            "requests": len(requests),
        },
    }


def validate_chrome_trace(doc: Any) -> List[str]:
    """Chrome trace event format check (the subset perfetto's legacy
    JSON importer requires). Returns problems; empty = valid."""
    bad: List[str] = []
    if not isinstance(doc, dict):
        return ["doc is not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            bad.append(f"{where} not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            bad.append(f"{where} unknown ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                bad.append(f"{where} missing {k!r}")
        if ph == "M":
            continue                  # metadata events carry no ts
        if not isinstance(ev.get("ts"), (int, float)):
            bad.append(f"{where}.ts not numeric: {ev.get('ts')!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"{where}.dur not a non-negative number: "
                           f"{dur!r}")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            bad.append(f"{where}.s not a valid instant scope: "
                       f"{ev.get('s')!r}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rings", nargs="+",
                    help="reqtrace_*.json / tickphase_*.json files or "
                         "dirs holding them")
    ap.add_argument("-o", "--out", default=None,
                    help="output trace path (default: stdout)")
    ap.add_argument("--no-ticks", action="store_true",
                    help="skip tickphase_*.json phase lanes")
    ap.add_argument("--check", action="store_true",
                    help="validate the emitted doc against the Chrome "
                         "trace schema; non-zero exit on any problem")
    ns = ap.parse_args(argv)
    ring_docs = load_rings([p for p in ns.rings
                            if not os.path.basename(p).startswith(
                                "tickphase_")])
    tick_docs = [] if ns.no_ticks else load_tickphase(ns.rings)
    if not ring_docs and not tick_docs:
        print("no valid trace rings found", file=sys.stderr)
        return 2
    doc = export(ring_docs, tick_docs)
    if ns.check:
        problems = validate_chrome_trace(doc)
        if problems:
            for p in problems[:20]:
                print(f"invalid: {p}", file=sys.stderr)
            return 1
    blob = json.dumps(doc)
    if ns.out:
        tmp = ns.out + ".tmp"
        with open(tmp, "w") as f:
            f.write(blob)
        os.replace(tmp, ns.out)
        od = doc["otherData"]
        print(f"wrote {ns.out}: {len(doc['traceEvents'])} events, "
              f"{od['requests']} requests over "
              f"{len(od['sources'])} sources"
              + (f" + {len(od['tick_sources'])} tick rings"
                 if od["tick_sources"] else ""))
    else:
        print(blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
