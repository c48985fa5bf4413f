"""Terminal fleet dashboard: render the serving fleet's
telemetry as one time-aligned timeline — per-replica tok/s, queue
depth and SLO burn rate as unicode sparklines, with burn-rate alerts
and autoscaler actions marked on a shared axis. Replaces the "run
loadgen, dump rings, join offline" debugging loop with one look.

    python -m paddle_tpu_torch.tools.fleet_dash RUN_DIR                # dumped series
    python -m paddle_tpu_torch.tools.fleet_dash series_gw0.json [...]  # specific files
    python -m paddle_tpu_torch.tools.fleet_dash --url HOST:PORT        # live fleet
    python -m paddle_tpu_torch.tools.fleet_dash --url HOST:PORT --watch 30
    python -m paddle_tpu_torch.tools.fleet_dash SIM_DUMP_DIR           # fleet_sim runs

File mode reads the ``series_<name>.json`` documents a drained
gateway (or ``observability.reset()``) flushes — each file becomes
one replica row — plus any ``flight_*.json`` beside them for
``fleet_autoscale`` events. ``tools/fleet_sim.py --dump-dir`` writes
the SAME two document shapes (``sim_*_series.json`` /
``sim_*_flight.json``, frontend-level ``fleet_*`` metrics, injected
incidents and frontend kills in the flight log), so a rehearsed
1000-replica incident renders on the identical timeline axis as a
live run — that is the point of sharing the writer. Live mode polls a gateway's or fleet
frontend's ``GET /metricsz`` (the frontend federates every peer's
cached windowed doc, so one URL shows the whole fleet) and redraws
until ``--watch`` seconds elapse.

Stdlib-only, like every serving tool in this repo.

The port's copy of ``tools/fleet_dash.py``, with the same command line and
output; it imports ``paddle_tpu_torch`` only (no jax), so it reads a
chip run's dumps on the card machine. Run it as ``python -m
paddle_tpu_torch.tools.fleet_dash``.
"""
import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple


BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(vals: List[Optional[float]], lo: float = None,
              hi: float = None) -> str:
    """Unicode sparkline; None renders as a gap (no sample in bin)."""
    present = [v for v in vals if v is not None]
    if not present:
        return " " * len(vals)
    lo = min(present) if lo is None else lo
    hi = max(present) if hi is None else hi
    span = hi - lo
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(BLOCKS[0] if hi <= 0 else BLOCKS[3])
        else:
            i = int((v - lo) / span * (len(BLOCKS) - 1) + 0.5)
            out.append(BLOCKS[max(0, min(i, len(BLOCKS) - 1))])
    return "".join(out)


def counter_rate_points(samples: List[list]) -> List[Tuple[float,
                                                           float]]:
    """(t, rate) from consecutive cumulative samples."""
    out = []
    for a, b in zip(samples, samples[1:]):
        dt = b[0] - a[0]
        if dt > 0:
            out.append((b[0], (b[1] - a[1]) / dt))
    return out


def resample(points: List[Tuple[float, float]], t0: float, t1: float,
             width: int) -> List[Optional[float]]:
    """Mean per fixed-width time bin (None = empty bin) — what maps
    every series onto ONE shared axis regardless of sample cadence."""
    if t1 <= t0:
        t1 = t0 + 1e-9
    bins: List[List[float]] = [[] for _ in range(width)]
    for t, v in points:
        i = int((t - t0) / (t1 - t0) * width)
        if 0 <= i < width:
            bins[i].append(v)
        elif i == width:
            bins[-1].append(v)
    return [sum(b) / len(b) if b else None for b in bins]


def _metric_points(doc: dict, base: str,
                   agg=sum) -> List[Tuple[float, float]]:
    """Merge every label variant of metric ``base`` in a series doc:
    counters become summed rates, gauges/burn series aggregate with
    ``agg`` per timestamp."""
    by_t: Dict[float, List[float]] = {}
    kind = None
    for full, ent in (doc.get("metrics") or {}).items():
        if full.split("{", 1)[0] != base:
            continue
        kind = ent["kind"]
        pts = counter_rate_points(ent["samples"]) \
            if kind == "counter" else \
            [(s[0], s[1]) for s in ent["samples"]]
        for t, v in pts:
            by_t.setdefault(round(t, 6), []).append(v)
    return sorted((t, agg(vs)) for t, vs in by_t.items())


def _label_value(full: str, key: str) -> Optional[str]:
    """Value of label ``key`` in a ``name{k="v",...}`` series key."""
    if "{" not in full:
        return None
    for kv in full.split("{", 1)[1].rstrip("}").split(","):
        k, _, v = kv.partition("=")
        if k.strip() == key:
            return v.strip().strip('"')
    return None


def _phase_share_points(doc: dict) -> Dict[str, List[Tuple[float,
                                                           float]]]:
    """{phase: [(t, phase-ms per wall second)]} derived from the
    ``paged_tick_phase_ms{phase=...}`` histogram SUM deltas a profiled
    engine exports — cumulative sums subtract like counter
    samples, so consecutive samples give the windowed phase-time
    rate."""
    by_phase: Dict[str, Dict[float, float]] = {}
    for full, ent in (doc.get("metrics") or {}).items():
        if full.split("{", 1)[0] != "paged_tick_phase_ms" \
                or ent.get("kind") != "histogram":
            continue
        phase = _label_value(full, "phase")
        if phase is None:
            continue
        merged = by_phase.setdefault(phase, {})
        samples = list(ent["samples"])
        for a, b in zip(samples, samples[1:]):
            dt = b[0] - a[0]
            if dt > 0:
                t = round(b[0], 6)
                merged[t] = merged.get(t, 0.0) \
                    + max(b[2] - a[2], 0.0) / dt
    return {p: sorted(m.items()) for p, m in sorted(by_phase.items())}


# one unambiguous letter per phase (first letters collide:
# host/h2d, dispatch/device/drain)
PHASE_LETTERS = {"host": "H", "h2d": "U", "dispatch": "D",
                 "device": "C", "drain": "R"}


def _phase_row(d: dict, t0: float, t1: float,
               width: int) -> Optional[str]:
    """The stacked phase-share row: per time bin, the
    DOMINANT phase's letter (H host, U h2d upload, D dispatch,
    C device compute, R drain readback) — uppercase when it holds a
    majority of the tick wall, lowercase for a mere plurality. One
    glance says "this replica went dispatch-bound at t=40s"."""
    shares = _phase_share_points(d)
    if not shares:
        return None
    binned = {p: resample(pts, t0, t1, width)
              for p, pts in shares.items()}
    out = []
    for i in range(width):
        tot = sum(v[i] for v in binned.values()
                  if v[i] is not None)
        if tot <= 0:
            out.append(" ")
            continue
        p, v = max(((p, v[i] or 0.0) for p, v in binned.items()),
                   key=lambda kv: kv[1])
        ch = PHASE_LETTERS.get(p, p[0].upper())
        out.append(ch if v / tot > 0.5 else ch.lower())
    return "".join(out)


def doc_time_range(docs: Dict[str, dict]) -> Tuple[float, float]:
    ts = [s[0]
          for d in docs.values()
          for ent in (d.get("metrics") or {}).values()
          for s in ent["samples"]]
    if not ts:
        return 0.0, 1.0
    return min(ts), max(ts)


def _flight_event(ev: dict, t: float) -> Optional[dict]:
    """One flight-recorder event → one timeline marker (or None for
    kinds the dashboard doesn't chart). Covers both the live
    recorder's ``fleet_autoscale`` and the simulator's injected
    ``incident_*`` / ``frontend_kill`` chaos events."""
    kind = ev.get("kind")
    if kind == "fleet_autoscale":
        return {"t": t, "kind": f"scale_{ev.get('action')}",
                "who": ev.get("fleet", "fleet"),
                "what": f"replicas_before="
                        f"{ev.get('replicas_before')}"}
    if kind in ("incident_start", "incident_end"):
        return {"t": t, "kind": kind,
                "who": ev.get("incident", "incident"),
                "what": "page expected"
                if ev.get("page_expected") else ""}
    if kind == "frontend_kill":
        return {"t": t, "kind": "frontend_kill",
                "who": ev.get("frontend", "frontend"),
                "what": "SIGKILL (leaderless failover)"}
    if kind == "profilez_capture":
        # an on-demand /profilez capture landed — mark WHEN
        # the phase rings / jax trace were cut so the sparkline shape
        # around the marker is what the capture actually saw
        return {"t": t, "kind": "profilez_capture",
                "who": ev.get("gateway", "gateway"),
                "what": f"duration_s={ev.get('duration_s')} "
                        f"traced={ev.get('traced')}"}
    return None


def collect_events(docs: Dict[str, dict],
                   flights: List[dict]) -> List[dict]:
    """Alerts from the series docs + autoscaler actions / injected
    chaos from flight dumps, mapped onto the series' monotonic axis
    via each doc's ``dumped_wall``/``clock_now`` offset."""
    events = []
    for name, d in docs.items():
        off = None
        if isinstance(d.get("dumped_wall"), (int, float)) \
                and isinstance(d.get("clock_now"), (int, float)):
            off = d["dumped_wall"] - d["clock_now"]
        for a in d.get("alerts") or ():
            events.append({"t": a.get("t"), "kind":
                           f"alert_{a.get('kind')}",
                           "who": name,
                           "what": f"{a.get('slo')}/{a.get('rule')} "
                                   f"burn={a.get('burn_fast')}"})
        for fl in flights:
            for ev in fl.get("events", ()):
                if off is None:
                    continue
                mapped = _flight_event(ev,
                                       ev.get("wall", 0.0) - off)
                if mapped is not None:
                    events.append(mapped)
        flights = []   # flight events mapped once, via the first doc
    seen = set()
    out = []
    for ev in sorted(events, key=lambda e: e.get("t") or 0.0):
        key = (ev["kind"], ev["who"], round(ev.get("t") or 0.0, 3))
        if key not in seen:
            seen.add(key)
            out.append(ev)
    return out


def _doc_rows(d: dict) -> tuple:
    """Pick the three sparkline rows by what the doc actually holds:
    a gateway series doc carries ``gateway_*`` metrics, a fleet_sim
    (or frontend-level) doc carries the frontend's ``fleet_*``
    counters — same renderer either way."""
    bases = {full.split("{", 1)[0]
             for full in (d.get("metrics") or {})}
    if "gateway_tokens_total" not in bases \
            and "fleet_requests_total" in bases:
        return (
            ("req/s", _metric_points(d, "fleet_requests_total")),
            ("tok/s", _metric_points(d,
                                     "fleet_proxied_tokens_total")),
            ("burn", _metric_points(d, "slo_burn_rate", agg=max)),
        )
    rows = (
        ("tok/s", _metric_points(d, "gateway_tokens_total")),
        ("queue", _metric_points(d, "gateway_queue_depth")),
        ("burn", _metric_points(d, "slo_burn_rate", agg=max)),
    )
    if "kv_spill_hits_total" in bases:
        # spill-tier restores — only gateways running with
        # an attached arena export the series, so the row is opt-in
        rows += (("spill", _metric_points(d, "kv_spill_hits_total")),)
    if "kv_xfer_hits_total" in bases:
        # cross-replica KV transfers landed — exported only
        # by gateways that injected at least one migrated/peer span
        rows += (("xfer", _metric_points(d, "kv_xfer_hits_total")),)
    return rows


def render(docs: Dict[str, dict], events: Optional[List[dict]] = None,
           width: int = 60) -> str:
    """One fleet timeline: per replica, tok/s + queue depth + max burn
    sparklines over a shared time axis, then the event markers."""
    t0, t1 = doc_time_range(docs)
    lines = [f"fleet timeline  t=[0 .. {t1 - t0:.1f}s]  "
             f"({len(docs)} replica{'s' if len(docs) != 1 else ''}, "
             f"width {width} bins)"]
    axis = "".join("|" if i % 10 == 0 else "-"
                   for i in range(width))
    lines.append(f"{'':<12s} {axis}")
    for name in sorted(docs):
        d = docs[name]
        rows = _doc_rows(d)
        for label, pts in rows:
            vals = resample(pts, t0, t1, width)
            present = [v for v in vals if v is not None]
            peak = max(present) if present else 0.0
            lines.append(f"{name[:12]:<12s} {sparkline(vals)} "
                         f"{label} peak {peak:.1f}")
        ph = _phase_row(d, t0, t1, width)
        if ph is not None:
            lines.append(f"{name[:12]:<12s} {ph} "
                         f"phase (H host U h2d D dispatch C device "
                         f"R drain; UPPER = majority)")
        lines.append("")
    marks = list(events or ())
    if marks:
        row = [" "] * width
        for ev in marks:
            t = ev.get("t")
            if t is None:
                continue
            i = int((t - t0) / max(t1 - t0, 1e-9) * (width - 1))
            row[max(0, min(i, width - 1))] = \
                "!" if ev["kind"].startswith("alert_fire") else \
                "." if ev["kind"].startswith("alert") else \
                "#" if ev["kind"].startswith("incident") else \
                "x" if ev["kind"] == "frontend_kill" else \
                "P" if ev["kind"] == "profilez_capture" else "^"
        lines.append(f"{'events':<12s} {''.join(row)} "
                     f"(! fire  . resolve  ^ scale  # incident  "
                     f"x fe-kill  P profilez)")
        for ev in marks[-12:]:
            t = ev.get("t")
            lines.append(f"  t={t - t0:7.1f}s  {ev['kind']:<14s} "
                         f"{ev['who']}: {ev['what']}"
                         if t is not None else
                         f"  t=      ?   {ev['kind']} {ev['who']}")
    return "\n".join(lines)


# ------------------------------------------------------------------- live
def _fetch_metricsz(host: str, port: int,
                    window_s: float) -> Optional[dict]:
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=3.0)
    try:
        conn.request("GET", f"/metricsz?window_s={window_s:g}")
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        return json.loads(resp.read())
    except (OSError, ValueError):
        return None
    finally:
        conn.close()


def _live_rows(doc: dict) -> Dict[str, Dict[str, float]]:
    """One poll → {replica: {tok_s, queue, burn, alerts}} for either a
    single gateway's /metricsz or a frontend's federated one."""
    rows: Dict[str, Dict[str, float]] = {}

    def fold(name: str, mdoc: dict):
        tok = q = burn = 0.0
        ph: Dict[str, float] = {}
        for full, view in (mdoc.get("metrics") or {}).items():
            base = full.split("{", 1)[0]
            if base == "gateway_tokens_total":
                tok += view.get("rate_per_s", 0.0)
            elif base == "gateway_queue_depth":
                q += view.get("last", 0.0)
            elif base == "paged_tick_phase_ms":
                # windowed phase-ms total = count * mean
                p = _label_value(full, "phase")
                if p is not None:
                    ph[p] = ph.get(p, 0.0) + view.get("count", 0) \
                        * view.get("mean", 0.0)
        slo = mdoc.get("slo") or {}
        for by_w in (slo.get("burn") or {}).values():
            burn = max([burn] + list(by_w.values()))
        letter = " "
        tot = sum(ph.values())
        if tot > 0:
            p, v = max(ph.items(), key=lambda kv: kv[1])
            letter = PHASE_LETTERS.get(p, p[0].upper())
            if v / tot <= 0.5:
                letter = letter.lower()
        rows[name] = {"tok_s": tok, "queue": q, "burn": burn,
                      "phase": letter,
                      "alerts": len(slo.get("active") or ())}

    if "replicas" in doc and "totals" in doc:     # federated frontend
        for peer, mz in (doc.get("replicas") or {}).items():
            inner = mz.get("doc")
            if inner and inner.get("enabled"):
                fold(peer, inner)
        rows["(fleet)"] = {
            "tok_s": doc["totals"].get("tokens_per_sec", 0.0),
            "queue": doc["totals"].get("queue_depth", 0.0),
            "burn": max([0.0] + list(
                doc["totals"].get("burn_rate_max", {}).values())),
            "alerts": len(doc["totals"].get("alerts_active", ()))}
    elif doc.get("enabled"):
        fold(doc.get("gateway", "gw"), doc)
    return rows


def live(host: str, port: int, watch_s: float, window_s: float,
         interval_s: float, width: int) -> int:
    hist: Dict[str, Dict[str, list]] = {}
    t_end = time.monotonic() + watch_s
    first = True
    while True:
        now = time.monotonic()
        doc = _fetch_metricsz(host, port, window_s)
        if doc is None:
            print(f"poll failed: {host}:{port} unreachable or no "
                  f"sampler", file=sys.stderr)
        else:
            for name, row in _live_rows(doc).items():
                h = hist.setdefault(name, {"tok_s": [], "queue": [],
                                           "burn": [], "phase": [],
                                           "alerts": 0})
                for k in ("tok_s", "queue", "burn"):
                    h[k].append(row[k])
                    del h[k][:-width]
                h["phase"].append(row.get("phase", " "))
                del h["phase"][:-width]
                h["alerts"] = row["alerts"]
            if not first:
                sys.stdout.write("\x1b[2J\x1b[H")
            first = False
            print(f"{host}:{port}  window={window_s:g}s  "
                  f"poll={interval_s:g}s  "
                  f"{time.strftime('%H:%M:%S')}")
            for name in sorted(hist):
                h = hist[name]
                flag = f"  ALERTS:{h['alerts']}" if h["alerts"] else ""
                print(f"{name[:12]:<12s} tok/s "
                      f"{sparkline(h['tok_s']):<{width}s} "
                      f"{h['tok_s'][-1]:8.1f}{flag}")
                print(f"{'':<12s} queue "
                      f"{sparkline(h['queue']):<{width}s} "
                      f"{h['queue'][-1]:8.1f}")
                print(f"{'':<12s} burn  "
                      f"{sparkline(h['burn']):<{width}s} "
                      f"{h['burn'][-1]:8.2f}")
                if any(c != " " for c in h["phase"]):
                    print(f"{'':<12s} phase "
                          f"{''.join(h['phase']):<{width}s} "
                          f"(H host U h2d D disp C dev R drain)")
            sys.stdout.flush()
        if now >= t_end:
            return 0
        time.sleep(min(interval_s, max(t_end - now, 0.0)))


# ------------------------------------------------------------------- main
def load_docs(paths: List[str]) -> Tuple[Dict[str, dict],
                                         List[dict]]:
    files: List[str] = []
    flights: List[dict] = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(glob.glob(os.path.join(p,
                                                   "series_*.json")))
            # fleet_sim --dump-dir naming (same document schema)
            files += sorted(glob.glob(os.path.join(
                p, "sim_*_series.json")))
            for fp in sorted(
                    glob.glob(os.path.join(p, "flight_*.json"))
                    + glob.glob(os.path.join(p,
                                             "sim_*_flight.json"))):
                try:
                    with open(fp) as f:
                        flights.append(json.load(f))
                except (OSError, ValueError):
                    pass
        else:
            files.append(p)
    docs = {}
    for fp in files:
        try:
            with open(fp) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"skipping {fp}: {e}", file=sys.stderr)
            continue
        docs[doc.get("name") or os.path.basename(fp)] = doc
    return docs, flights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="series_*.json files or run dirs")
    ap.add_argument("--url", default=None,
                    help="live mode: poll HOST:PORT/metricsz")
    ap.add_argument("--watch", type=float, default=10.0,
                    help="live mode duration, seconds")
    ap.add_argument("--window-s", type=float, default=5.0,
                    help="windowed-rate horizon per poll")
    ap.add_argument("--interval-s", type=float, default=0.5,
                    help="live poll cadence")
    ap.add_argument("--width", type=int, default=60,
                    help="timeline width, bins")
    ns = ap.parse_args(argv)
    if ns.url:
        h, _, p = ns.url.partition(":")
        return live(h, int(p), ns.watch, ns.window_s, ns.interval_s,
                    ns.width)
    if not ns.paths:
        ap.error("series files / run dir required (or --url)")
    docs, flights = load_docs(ns.paths)
    if not docs:
        print("no series_*.json documents found", file=sys.stderr)
        return 2
    from paddle_tpu_torch.utils.observability import validate_series_doc
    for name, d in docs.items():
        problems = validate_series_doc(d)
        if problems:
            print(f"warning: {name}: {problems[:3]}", file=sys.stderr)
    print(render(docs, collect_events(docs, flights), width=ns.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())
