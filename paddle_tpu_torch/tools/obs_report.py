"""Render a run dir's observability artifacts: step-time
p50/p99, MFU/throughput, stall counters, and the fault/rollback/
checkpoint event timeline from the flight recorder — the "what
happened to this run" one-pager.

    python -m paddle_tpu_torch.tools.obs_report runs/                 # human summary
    python -m paddle_tpu_torch.tools.obs_report runs/ --json          # machine-readable
    python -m paddle_tpu_torch.tools.obs_report runs/ --serve 9090    # /metrics scrape
    python -m paddle_tpu_torch.tools.obs_report --check               # CI self-test

A run dir (``<output_dir>/runs`` for the Trainer) holds:

- ``metrics.jsonl``  — LogWriter scalars + merged registry publishes
- ``metrics.prom``   — Prometheus text snapshot (what ``--serve`` serves)
- ``trace_<k>.json`` — chrome-trace spans per elastic attempt k
                       (load in Perfetto / chrome://tracing)
- ``flight_<k>.json``— flight-recorder dump per attempt (crash /
                       preemption / rollback postmortems)
- ``flight_supervisor.json`` / ``metrics_supervisor.prom`` — the
  elastic supervisor's own child-launch/exit events and
  restart/preemption counters (``supervise(run_dir=…)`` / ``--run-dir``)

``--check`` builds a synthetic run dir with the observability library
itself, re-parses it, and exits nonzero if the schema drifted —
runnable in CI with no devices.

The port's copy of ``tools/obs_report.py``, with the same command line and
output; it imports ``paddle_tpu_torch`` only (no jax), so it reads a
chip run's dumps on the card machine. Run it as ``python -m
paddle_tpu_torch.tools.obs_report``.
"""
import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional


# event kinds that belong on the human timeline (per-step step_end
# records feed the latency stats instead — hundreds of them would
# drown the signal)
TIMELINE_KINDS = (
    "train_start", "fault_fire", "divergence", "rollback",
    "preempt_latch", "preempt_exit", "preempt_ckpt_failed", "hang",
    "crash", "prefetch_stall", "ckpt_save", "ckpt_restore",
    "ckpt_committed", "eval", "elastic_child_launch",
    "elastic_child_exit", "serve_reject", "serve_preempt",
    # SLO burn-rate incidents: the flight recorder holds
    # them beside the replica failures that caused them
    "alert_fire", "alert_resolve",
)


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    idx = q * (len(xs) - 1)
    lo, hi = int(idx), min(int(idx) + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (idx - lo)


def _load_jsonl(path: str) -> Dict[str, List]:
    """tag -> [(step, value)] series from a LogWriter stream."""
    series: Dict[str, List] = {}
    if not os.path.exists(path):
        return series
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                series.setdefault(rec["tag"], []).append(
                    (rec["step"], rec["value"]))
            except (ValueError, KeyError):
                continue   # torn tail line from a crash: skip, don't die
    return series


def _load_flights(run_dir: str) -> List[dict]:
    flights = []
    for path in sorted(glob.glob(os.path.join(run_dir, "flight_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
            doc["_file"] = os.path.basename(path)
            flights.append(doc)
        except (OSError, ValueError):
            continue
    return flights


def _load_prom(path: str) -> Dict[str, float]:
    prom: Dict[str, float] = {}
    if not os.path.exists(path):
        return prom
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name, value = line.rsplit(" ", 1)
            prom[name] = float(value)
        except ValueError:
            continue
    return prom


def _load_traces(run_dir: str) -> List[dict]:
    traces = []
    for path in sorted(glob.glob(os.path.join(run_dir, "trace_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
            doc["_file"] = os.path.basename(path)
            traces.append(doc)
        except (OSError, ValueError):
            continue
    return traces


def _load_tickphase(run_dir: str) -> List[dict]:
    """Load + schema-validate the ``tickphase_*.json`` phase rings a
    profiled engine (or a gateway drain / ``/profilez`` capture)
    leaves in the run dir."""
    from paddle_tpu_torch.utils.observability import validate_tickphase_doc
    docs = []
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "tickphase_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if validate_tickphase_doc(doc):
            continue                 # torn/drifted file: skip, not die
        doc["_file"] = os.path.basename(path)
        docs.append(doc)
    return docs


def phase_decompose(docs: List[dict]) -> Optional[Dict[str, Any]]:
    """The ``phase_decompose`` view: split tick wall time —
    and therefore tok/s — into host / h2d / dispatch / device / drain
    SHARES per profiled engine and fleet-wide, and name the dominant
    term. This is the slope-vs-intercept read ROADMAP item 1 needs:
    device share is the slope (model compute), dispatch+host share is
    the intercept (per-tick machinery) — a tok/s gap attributed to the
    intercept is a tick-machinery problem, not a kernel problem."""
    if not docs:
        return None
    per: Dict[str, Any] = {}
    agg_tot: Dict[str, float] = {}
    agg_wall = 0.0
    agg_ticks = 0
    for d in docs:
        wall = float(d.get("wall_total_ms") or 0.0)
        tot = {k: float(v) for k, v in
               (d.get("phase_totals_ms") or {}).items()}
        name = d.get("engine") or d["_file"]
        per[name] = {
            "ticks": int(d.get("ticks") or 0),
            "wall_ms": round(wall, 3),
            "shares": {k: round(v / wall, 4) if wall > 0 else 0.0
                       for k, v in sorted(tot.items())},
        }
        agg_wall += wall
        agg_ticks += int(d.get("ticks") or 0)
        for k, v in tot.items():
            agg_tot[k] = agg_tot.get(k, 0.0) + v
    shares = {k: round(v / agg_wall, 4) if agg_wall > 0 else 0.0
              for k, v in sorted(agg_tot.items())}
    dominant = max(shares, key=shares.get) if shares else None
    return {
        "sources": [d["_file"] for d in docs],
        "ticks": agg_ticks,
        "wall_ms": round(agg_wall, 3),
        "shares": shares,
        "dominant": dominant,
        "per_engine": per,
    }


def summarize(run_dir: str) -> Dict[str, Any]:
    """Parse every artifact in ``run_dir`` into one summary dict (the
    schema ``--check`` pins)."""
    series = _load_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    flights = _load_flights(run_dir)
    traces = _load_traces(run_dir)

    # step latency: flight step_end events are the primary series (they
    # survive crashes); train_step trace spans are the fallback
    step_ms = [ev["ms"] for fl in flights for ev in fl.get("events", ())
               if ev.get("kind") == "step_end" and "ms" in ev]
    span_ms = [ev["dur"] / 1e3 for tr in traces
               for ev in tr.get("traceEvents", ())
               if ev.get("name") == "train_step" and "dur" in ev]
    lat = step_ms or span_ms

    def last(tag: str) -> Optional[float]:
        return series[tag][-1][1] if series.get(tag) else None

    timeline = sorted(
        (ev for fl in flights for ev in fl.get("events", ())
         if ev.get("kind") in TIMELINE_KINDS),
        key=lambda ev: ev.get("wall", 0.0))

    prom = _load_prom(os.path.join(run_dir, "metrics.prom"))
    # the supervisor process keeps its own registry (children can't
    # count their own relaunches): a separate snapshot, merged here
    sup_prom = _load_prom(os.path.join(run_dir,
                                       "metrics_supervisor.prom"))

    def prom_sum(prefix: str, src: Optional[Dict[str, float]] = None
                 ) -> float:
        return sum(v for k, v in (prom if src is None else src).items()
                   if k.split("{")[0] == prefix)

    return {
        "run_dir": os.path.abspath(run_dir),
        # the supervisor's flight doc is not a child attempt
        "attempts": sorted({fl.get("attempt", 0) for fl in flights
                            if fl["_file"] != "flight_supervisor.json"}),
        "flight_reasons": [(fl["_file"], fl.get("reason"))
                           for fl in flights],
        "steps_recorded": len(lat),
        "step_ms": {
            "p50": round(_percentile(lat, 0.5), 3),
            "p99": round(_percentile(lat, 0.99), 3),
            "mean": round(sum(lat) / len(lat), 3) if lat else 0.0,
            "max": round(max(lat), 3) if lat else 0.0,
        },
        "train": {
            "loss": last("loss") if last("loss") is not None
            else last("train_loss"),
            "mfu": last("mfu") if last("mfu") is not None
            else last("train_mfu"),
            "tokens_per_sec": last("tokens_per_sec")
            if last("tokens_per_sec") is not None
            else last("train_tokens_per_sec"),
        },
        "counters": {
            "prefetch_sync_fallbacks":
                prom_sum("prefetch_sync_fallbacks_total"),
            "prefetch_stall_degradations":
                prom_sum("prefetch_stall_degradations_total"),
            "fault_fires": prom_sum("fault_fires_total"),
            "rollbacks": prom_sum("train_rollbacks_total"),
            "train_steps": prom_sum("train_steps_total"),
            "elastic_restarts":
                prom_sum("elastic_restarts_total", sup_prom),
            "elastic_preemptions":
                prom_sum("elastic_preemptions_total", sup_prom),
        },
        "trace_spans": sum(len(tr.get("traceEvents", ()))
                           for tr in traces),
        # tick-phase decomposition: present only when a
        # profiled engine left tickphase_*.json rings in the run dir
        "phase_decompose": phase_decompose(_load_tickphase(run_dir)),
        "timeline": timeline,
        "jsonl_tags": sorted(series),
    }


def render(s: Dict[str, Any]) -> str:
    import datetime
    lines = [f"run dir: {s['run_dir']}",
             f"attempts: {s['attempts'] or [0]}   "
             f"trace spans: {s['trace_spans']}   "
             f"steps recorded: {s['steps_recorded']}"]
    st = s["step_ms"]
    lines.append(f"step time  p50 {st['p50']:.1f} ms   "
                 f"p99 {st['p99']:.1f} ms   mean {st['mean']:.1f} ms   "
                 f"max {st['max']:.1f} ms")
    tr = s["train"]
    if tr["loss"] is not None:
        mfu = tr["mfu"] or 0.0
        tps = tr["tokens_per_sec"] or 0.0
        lines.append(f"train      loss {tr['loss']:.4f}   "
                     f"mfu {mfu:.2%}   tokens/s {tps:,.0f}")
    c = s["counters"]
    # metrics.prom is a per-process snapshot: after an elastic run it
    # holds the LAST attempt's registry (the timeline spans them all)
    lines.append(f"counters (last attempt)   "
                 f"steps {c['train_steps']:.0f}   "
                 f"fault fires {c['fault_fires']:.0f}   "
                 f"rollbacks {c['rollbacks']:.0f}   "
                 f"prefetch stalls "
                 f"{c['prefetch_stall_degradations']:.0f} "
                 f"(sync fallbacks {c['prefetch_sync_fallbacks']:.0f})")
    if c["elastic_restarts"] or c["elastic_preemptions"]:
        lines.append(f"supervisor restarts {c['elastic_restarts']:.0f}   "
                     f"preemptions {c['elastic_preemptions']:.0f}")
    pd = s.get("phase_decompose")
    if pd:
        sh = " ".join(f"{k} {v:.1%}" for k, v in pd["shares"].items())
        lines.append(f"tick phases ({pd['ticks']} ticks, "
                     f"{pd['wall_ms']:.0f} ms wall)   {sh}   "
                     f"dominant: {pd['dominant']}")
        for name, p in sorted(pd["per_engine"].items()):
            sh = " ".join(f"{k} {v:.1%}"
                          for k, v in p["shares"].items())
            lines.append(f"  {name}: {p['ticks']} ticks   {sh}")
    for fname, reason in s["flight_reasons"]:
        lines.append(f"flight     {fname}: {reason}")
    if s["timeline"]:
        lines.append("timeline:")
        for ev in s["timeline"][-40:]:
            wall = datetime.datetime.fromtimestamp(
                ev.get("wall", 0.0)).strftime("%H:%M:%S.%f")[:-3]
            extra = " ".join(f"{k}={v}" for k, v in ev.items()
                             if k not in ("wall", "kind"))
            lines.append(f"  {wall}  {ev['kind']:<22s} {extra}")
    return "\n".join(lines)


# ------------------------------------------------------------------ serve
def serve(run_dir: str, port: int) -> int:
    """Serve ``/metrics`` (Prometheus text, re-read per scrape) and
    ``/`` (the JSON summary) with the stdlib http server — a sidecar
    scrape endpoint with zero dependencies."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") == "/metrics":
                path = os.path.join(run_dir, "metrics.prom")
                try:
                    body = open(path, "rb").read()
                except OSError:
                    self.send_error(404, "no metrics.prom yet")
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.end_headers()
                self.wfile.write(body)
            else:
                body = json.dumps(summarize(run_dir)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        def log_message(self, *a):   # quiet: scrapes every few seconds
            pass

    httpd = http.server.HTTPServer(("", port), Handler)
    print(f"serving {run_dir} on :{port} (/metrics for Prometheus, "
          f"/ for the JSON summary)", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


# ------------------------------------------------------------------ check
def self_check() -> int:
    """CI mode: synthesize a run dir with the observability library,
    re-parse it, and verify the summary schema — no devices, no model.
    Nonzero exit = the reader and the writer drifted apart."""
    import tempfile

    from paddle_tpu_torch.utils import observability as obs
    from paddle_tpu_torch.utils.logging import LogWriter

    failures: List[str] = []

    def expect(cond: bool, what: str):
        if not cond:
            failures.append(what)

    obs.reset()
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "runs")
        obs.configure(run)
        # a fake 5-step run with one fault fire and a checkpoint
        writer = LogWriter(run)
        for step in range(1, 6):
            with obs.span("train_step", step=step):
                pass
            obs.counter("train_steps_total").inc()
            obs.histogram("train_step_wall_ms").observe(10.0 + step)
            obs.record_event("step_end", step=step, ms=10.0 + step)
        obs.gauge("train_mfu").set(0.41)
        obs.record_event("fault_fire", site="preempt", occurrence=0)
        obs.record_event("ckpt_save", step=5, wait=True, ms=12.5)
        writer.add_scalar("loss", 2.5, 5)
        writer.add_scalar("mfu", 0.41, 5)
        writer.add_scalar("tokens_per_sec", 123456.0, 5)
        obs.publish(writer, 5)
        writer.close()
        obs.dump_flight("preempt")
        # a fake supervisor view (separate recorder/registry — in real
        # runs it's a separate PROCESS writing these two files)
        sup = obs.FlightRecorder()
        sup.record("elastic_child_launch", attempt=0, argv0="python")
        sup.record("elastic_child_exit", attempt=0, rc=76)
        sup.dump(os.path.join(run, "flight_supervisor.json"),
                 "supervise_exit")
        sreg = obs.MetricsRegistry()
        sreg.counter("elastic_preemptions_total").inc()
        with open(os.path.join(run, "metrics_supervisor.prom"), "w") as f:
            f.write(sreg.prometheus_text())

        # request-trace ring: write one with the library,
        # re-validate with the same checker trace_report's loader
        # runs — ring writer and report reader must not drift
        from paddle_tpu_torch.serving.reqtrace import (RequestTrace,
                                                 RequestTraceRing,
                                                 validate_ring_doc)
        ring = RequestTraceRing(capacity=8, slow_ttft_ms=50.0,
                                labels={"gateway": "chk",
                                        "replica": "r0"})
        slow = RequestTrace("chk-slow", slo="interactive")
        for t, kind, fields in (
                (0.0, "accept", {}), (0.1, "queue_enter", {}),
                (10.0, "queue_leave", {}), (10.1, "slot_take", {}),
                (40.0, "prefill_done", {}),
                (80.0, "first_token", {}), (90.0, "finish", {})):
            slow.ev(kind, t_ms=t, **fields)
        ring.finish(slow, "stop", tokens=4)
        fast = RequestTrace("chk-fast", slo="interactive")
        for t, kind in ((0.0, "accept"), (0.1, "queue_enter"),
                        (0.5, "slot_take"), (1.0, "prefill_done"),
                        (2.0, "first_token")):
            fast.ev(kind, t_ms=t)
        ring.finish(fast, "stop", tokens=4)
        shed = RequestTrace("chk-shed", slo="batch")
        shed.ev("accept", t_ms=0.0)
        shed.ev("shed", t_ms=0.2)
        ring.finish(shed, "shed")
        ring_path = os.path.join(run, "reqtrace_chk_r0.json")
        ring.dump(ring_path)
        with open(ring_path) as f:
            ring_doc = json.load(f)
        problems = validate_ring_doc(ring_doc)
        expect(not problems,
               f"trace-ring schema drift: {problems[:3]}")
        by_id = {e["request_id"]: e for e in ring_doc["entries"]}
        expect(by_id["chk-slow"]["retained"]
               and by_id["chk-slow"]["events"],
               "slow request's full timeline not retained")
        expect(not by_id["chk-fast"]["retained"]
               and not by_id["chk-fast"]["events"],
               "fast healthy request not tail-dropped")
        expect(by_id["chk-shed"]["retained"],
               "shed request not retained")
        expect(by_id["chk-slow"]["queue_wait_ms"] == 10.0
               and by_id["chk-slow"]["prefill_ms"] == 29.9
               and by_id["chk-slow"]["first_tick_ms"] == 40.0,
               "attribution decomposition wrong")

        # time-series + alert-log document: write one with
        # the library (injected clock — rate derivation is PINNED to
        # exact values), round-trip through JSON, re-validate with the
        # same checker fleet_dash's loader runs
        from paddle_tpu_torch.serving.slo import BurnRateEngine, BurnRule
        from paddle_tpu_torch.utils.observability import (MetricsTimeSeries,
                                                    validate_series_doc)
        sreg2 = obs.MetricsRegistry()
        tok = sreg2.counter("toks_total")
        q = sreg2.gauge("queue")
        lat = sreg2.histogram("lat_ms", buckets=(1, 2, 5))
        clk = [0.0]
        ts = MetricsTimeSeries(name="chk", registry=sreg2,
                               interval_s=1.0, capacity=4,
                               clock=lambda: clk[0])
        for i in range(6):
            clk[0] = float(i)
            tok.inc(5)
            q.set(i)
            lat.observe(1.5)
            ts.sample()
        expect(len(ts.series("toks_total")) == 4,
               "series ring bound not enforced")
        w = ts.window(3.0, now=5.0)
        expect(w["toks_total"]["rate_per_s"] == 5.0,
               "counter rate derivation drifted "
               f"(got {w['toks_total']['rate_per_s']})")
        expect(w["queue"]["mean"] == 3.5,
               "gauge window mean drifted")
        expect(w["lat_ms"]["p50"] == 1.5 and w["lat_ms"]["count"] == 3,
               "windowed histogram quantile drifted")
        bclk = [0.0]
        beng = BurnRateEngine(targets={"interactive": 0.9},
                              rules=(BurnRule("page", 5.0, 20.0,
                                              2.0),),
                              clock=lambda: bclk[0])
        for i in range(20):
            bclk[0] = float(i)
            beng.observe("interactive", True)
        for i in range(5):
            bclk[0] = 20.0 + i
            beng.observe("interactive", False)
        for i in range(40):
            bclk[0] = 26.0 + i
            beng.observe("interactive", True)
        kinds_seq = [a["kind"] for a in beng.alerts]
        expect(kinds_seq == ["fire", "resolve"],
               f"burn-rate fire/resolve sequence drifted: {kinds_seq}")
        series_path = os.path.join(run, "series_chk.json")
        ts.dump(series_path, alerts=beng.alerts)
        with open(series_path) as f:
            series_doc = json.load(f)
        problems = validate_series_doc(series_doc)
        expect(not problems,
               f"time-series schema drift: {problems[:3]}")
        expect(series_doc["alerts"][0]["slo"] == "interactive",
               "alert log lost the SLO class")
        broken = json.loads(json.dumps(series_doc))
        broken["metrics"]["toks_total"]["samples"][0][1] = 1e9
        expect(any("regressed" in p
                   for p in validate_series_doc(broken)),
               "counter regression not caught by the validator")

        # tick-phase ring: synthesize one with the library's
        # validator vocabulary, re-validate, and pin the decompose math
        from paddle_tpu_torch.utils.observability import (
            TICK_PHASES, validate_tickphase_doc)
        tp_doc = {
            "schema": "tickphase/1", "engine": "chk-e0",
            "dumped_wall": 1000.0, "clock_now": 10.0, "capacity": 8,
            "ticks": 2, "wall_total_ms": 10.0,
            "phase_totals_ms": {"host": 2.0, "h2d": 1.0,
                                "dispatch": 5.0, "device": 1.5,
                                "drain": 0.5},
            "entries": [
                {"tick": k, "t": 9.0 + k, "wall_ms": 5.0,
                 "host_ms": 1.0, "h2d_ms": 0.5, "dispatch_ms": 2.5,
                 "device_ms": 0.75, "drain_ms": 0.25,
                 "dispatches": 1, "uploads": 0, "bytes": 0,
                 "patches": 0, "active": 2} for k in range(2)],
        }
        problems = validate_tickphase_doc(tp_doc)
        expect(not problems,
               f"tickphase schema drift: {problems[:3]}")
        expect(set(tp_doc["phase_totals_ms"]) == set(TICK_PHASES),
               "TICK_PHASES vocabulary drifted")
        broken_tp = json.loads(json.dumps(tp_doc))
        broken_tp["entries"][0]["host_ms"] = 99.0
        expect(any("sum" in p
                   for p in validate_tickphase_doc(broken_tp)),
               "phase-sum != wall not caught by the validator")
        with open(os.path.join(run, "tickphase_chk_r0.json"),
                  "w") as f:
            json.dump(tp_doc, f)

        s = summarize(run)
        pd = s["phase_decompose"]
        expect(pd is not None and pd["dominant"] == "dispatch",
               "phase_decompose missing or dominant term wrong")
        expect(pd is not None
               and pd["shares"].get("dispatch") == 0.5
               and abs(sum(pd["shares"].values()) - 1.0) < 0.01,
               "phase_decompose shares drifted")
        expect(s["steps_recorded"] == 5, "step_end events lost")
        expect(s["step_ms"]["p50"] > 0, "p50 not computed")
        expect(s["step_ms"]["p99"] >= s["step_ms"]["p50"],
               "p99 < p50")
        expect(s["train"]["loss"] == 2.5, "loss not read from jsonl")
        expect(s["train"]["mfu"] == 0.41, "mfu not read from jsonl")
        expect(s["counters"]["train_steps"] == 5,
               "train_steps_total not in metrics.prom")
        kinds = [ev["kind"] for ev in s["timeline"]]
        expect("fault_fire" in kinds, "fault_fire missing from timeline")
        expect("ckpt_save" in kinds, "ckpt_save missing from timeline")
        expect("elastic_child_exit" in kinds,
               "supervisor flight events missing from timeline")
        expect(s["counters"]["elastic_preemptions"] == 1,
               "supervisor counters not read from "
               "metrics_supervisor.prom")
        expect(len(s["attempts"]) == 1,
               "flight_supervisor.json polluted the attempts set")
        expect(s["flight_reasons"] and
               s["flight_reasons"][0][1] == "preempt",
               "flight reason lost")
        expect(s["trace_spans"] >= 5, "train_step spans missing")
        expect(any(t.startswith("train_step_wall_ms")
                   for t in s["jsonl_tags"]),
               "registry publish missing from jsonl")
        # the trace must be chrome-trace shaped (Perfetto-loadable)
        tr = _load_traces(run)[0]
        ev = next(e for e in tr["traceEvents"]
                  if e["name"] == "train_step")
        expect(ev["ph"] == "X" and "ts" in ev and "dur" in ev
               and ev["args"]["step"] in range(1, 6),
               "trace events not chrome-trace shaped")
        expect("run_id" in tr.get("otherData", {}),
               "trace missing run_id metadata")
        render(s)   # rendering must not throw on a well-formed summary
    obs.reset()
    if failures:
        print("obs_report schema drift:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("obs_report --check: schema OK "
          "(writer and reader agree on all artifacts)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", nargs="?", help="run dir (e.g. out/runs)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable summary")
    ap.add_argument("--serve", type=int, metavar="PORT",
                    help="serve /metrics + the JSON summary over HTTP")
    ap.add_argument("--check", action="store_true",
                    help="synthetic self-test (CI; no devices)")
    ns = ap.parse_args(argv)
    if ns.check:
        return self_check()
    if not ns.run_dir:
        ap.error("run_dir required (or --check)")
    if not os.path.isdir(ns.run_dir):
        print(f"not a directory: {ns.run_dir}", file=sys.stderr)
        return 2
    if ns.serve:
        return serve(ns.run_dir, ns.serve)
    s = summarize(ns.run_dir)
    print(json.dumps(s) if ns.json else render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
