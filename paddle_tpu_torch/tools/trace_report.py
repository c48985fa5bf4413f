"""SLO-attribution report over request-trace rings: ingest
the per-replica ``reqtrace_*.json`` ring dumps the gateway writes (on
drain, via ``Gateway.dump_traces``, or ``serve_loadgen --trace-dir``)
plus, optionally, the loadgen's client-side per-request JSONL, and
print the p50/p99 TTFT decomposition per component and per SLO class:

    python -m paddle_tpu_torch.tools.trace_report RUNDIR_OR_FILES...        # human
    python -m paddle_tpu_torch.tools.trace_report DIR --jsonl lg.jsonl      # + client join
    python -m paddle_tpu_torch.tools.trace_report DIR --json                # machine

The decomposition is the formula (docs/OBSERVABILITY.md):

    ttft = queue_wait + prefill + first_tick   (+ accept residual)

so a bad p99 TTFT is attributed to the admission queue, the prefill
chunking, or the decode/dispatch path — per SLO class, with the exact
p99 request id named (percentiles here are EXACT order statistics over
the ring entries, not bucket interpolations). The client join matches
server rings against client-minted ``X-Request-Id``s: the TTFT delta
is the wire + gateway parse overhead, and client-only outcomes (shed
before a ring existed, connection errors) are counted separately.

Fleet merge: point the CLI at SEVERAL gateway run dirs (or
one shared ``--trace-dir`` a fleet loadgen run filled) and rings from
different PROCESSES merge into one timeline. A request that crossed
processes — proxied by the fleet frontend, or failed over to a
surviving peer mid-stream — is followed by request id: the report
counts cross-process requests, names the hop chain
(``fleet/frontend -> gwA/r0 -> gwB/r0``), and prints the merged
event-by-event timeline on one wall-clock axis (entries carry
``wall_accept``; event times are offsets from it).

The port's copy of ``tools/trace_report.py``, with the same command line and
output; it imports ``paddle_tpu_torch`` only (no jax), so it reads a
chip run's dumps on the card machine. Run it as ``python -m
paddle_tpu_torch.tools.trace_report``.
"""
import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional


COMPONENTS = ("queue_wait_ms", "prefill_ms", "first_tick_ms")


def _pct(pairs: List[tuple], q: float) -> tuple:
    """Exact order-statistic percentile over (value, request_id) pairs
    — returns (value, exemplar_request_id)."""
    if not pairs:
        return 0.0, None
    pairs = sorted(pairs)
    i = min(int(q * (len(pairs) - 1) + 0.5), len(pairs) - 1)
    return pairs[i]


def load_rings(paths: List[str]) -> List[dict]:
    """Expand dirs to reqtrace_*.json, load and schema-validate each
    doc (invalid docs are skipped with a warning — one torn file must
    not kill the report)."""
    from paddle_tpu_torch.serving.reqtrace import validate_ring_doc
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(
                os.path.join(p, "reqtrace_*.json"))))
        else:
            files.append(p)
    docs = []
    for f in files:
        try:
            with open(f) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"warning: skipping {f}: {e}", file=sys.stderr)
            continue
        problems = validate_ring_doc(doc)
        if problems:
            print(f"warning: {f} failed schema check "
                  f"({problems[0]}; {len(problems)} total) — skipped",
                  file=sys.stderr)
            continue
        doc["_file"] = os.path.basename(f)
        docs.append(doc)
    return docs


def load_client_jsonl(path: str) -> Dict[str, dict]:
    recs: Dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                recs[str(rec["request_id"])] = rec
            except (ValueError, KeyError):
                continue   # torn tail line: skip, don't die
    return recs


def fleet_merge(docs: List[dict], top: int = 5) -> Optional[dict]:
    """Join entries across rings from different PROCESSES by request
    id. A request is cross-process when it has ring entries
    in more than one dump, or its timeline carries fleet hop events
    (``proxy_to``/``peer_fail``/``resubmit``). Returns None when the
    input is a single-process view with no hops — the report then
    stays in its classic shape."""
    by_rid: Dict[str, List[tuple]] = {}
    for d in docs:
        lbl = d.get("labels") or {}
        where = (f"{lbl.get('gateway', '?')}/"
                 f"{lbl.get('replica', '?')}")
        for e in d["entries"]:
            by_rid.setdefault(str(e["request_id"]),
                              []).append((where, e))

    def _hops(entries):
        return sum(1 for _, e in entries
                   for _, k, _f in e.get("events", ())
                   if k == "peer_fail")

    cross = {rid: hops for rid, hops in by_rid.items()
             if len(hops) > 1
             or any(k in ("proxy_to", "peer_fail")
                    for _, e in hops
                    for _, k, _f in e.get("events", ()))}
    if not cross:
        return None
    chains = []
    for rid, hops in cross.items():
        # order hops by accept wall time: the frontend accepts first,
        # then each peer the request touched in failover order
        hops = sorted(hops, key=lambda we: we[1].get("wall_accept", 0))
        merged = []
        for where, e in hops:
            w0 = e.get("wall_accept") or 0.0
            for t, kind, fields in e.get("events", ()):
                merged.append((w0 + t / 1e3, where, kind, fields))
        merged.sort(key=lambda ev: ev[0])
        chains.append({
            "request_id": rid,
            "chain": [where for where, _ in hops],
            "outcomes": {where: e["outcome"] for where, e in hops},
            "peer_failovers": _hops(hops),
            "events": merged,
        })
    chains.sort(key=lambda c: (-c["peer_failovers"],
                               -len(c["chain"]), c["request_id"]))
    return {
        "cross_process_requests": len(cross),
        "with_peer_failover": sum(1 for c in chains
                                  if c["peer_failovers"]),
        "chains": chains[:top],
    }


def summarize(docs: List[dict],
              client: Optional[Dict[str, dict]] = None,
              top: int = 5) -> Dict[str, Any]:
    entries = [e for d in docs for e in d["entries"]]
    by_slo: Dict[str, List[dict]] = {}
    for e in entries:
        by_slo.setdefault(e["slo"], []).append(e)

    classes: Dict[str, Any] = {}
    for slo, es in sorted(by_slo.items()):
        outcomes: Dict[str, int] = {}
        for e in es:
            outcomes[e["outcome"]] = outcomes.get(e["outcome"], 0) + 1
        comps: Dict[str, Any] = {}
        for key in ("ttft_ms",) + COMPONENTS + ("tpot_ms",):
            pairs = [(e[key], e["request_id"]) for e in es
                     if e.get(key) is not None]
            p50, _ = _pct(pairs, 0.50)
            p99, rid99 = _pct(pairs, 0.99)
            comps[key] = {"n": len(pairs),
                          "p50": round(p50, 2), "p99": round(p99, 2),
                          "p99_request_id": rid99}
        # failover hops: how many requests in this class
        # rode a replica failure, and the total resubmission count —
        # failed-over timelines are always retained, so the hops are
        # printed event-by-event below
        fo = [e.get("failovers", 0) or 0 for e in es]
        classes[slo] = {"requests": len(es), "outcomes": outcomes,
                        "failed_over": sum(1 for n in fo if n),
                        "failover_hops": sum(fo),
                        "components": comps}

    slowest = sorted((e for e in entries if e.get("retained")
                      and e.get("ttft_ms") is not None),
                     key=lambda e: -e["ttft_ms"])[:top]

    out: Dict[str, Any] = {
        "rings": [d["_file"] for d in docs],
        "requests": len(entries),
        "retained": sum(bool(e.get("retained")) for e in entries),
        "classes": classes,
        "slowest_retained": slowest,
    }
    fleet = fleet_merge(docs, top=top)
    if fleet is not None:
        out["fleet"] = fleet
    if client is not None:
        server_ids = {e["request_id"] for e in entries}
        matched = [(client[e["request_id"]], e) for e in entries
                   if e["request_id"] in client]
        deltas = [(c["ttft_ms"] - e["ttft_ms"], e["request_id"])
                  for c, e in matched
                  if c.get("ttft_ms") is not None
                  and e.get("ttft_ms") is not None]
        client_only = {rid: rec.get("outcome")
                       for rid, rec in client.items()
                       if rid not in server_ids}
        d50, _ = _pct(deltas, 0.50)
        d99, rid = _pct(deltas, 0.99)
        out["client_join"] = {
            "client_records": len(client),
            "matched": len(matched),
            "client_only": len(client_only),
            "client_only_outcomes": sorted(
                {str(v) for v in client_only.values()})[:8],
            "wire_overhead_ms": {"n": len(deltas),
                                 "p50": round(d50, 2),
                                 "p99": round(d99, 2),
                                 "p99_request_id": rid},
        }
    return out


def render(s: Dict[str, Any]) -> str:
    lines = [f"rings: {', '.join(s['rings']) or '(none)'}",
             f"requests: {s['requests']}   retained timelines: "
             f"{s['retained']}"]
    for slo, cls in s["classes"].items():
        oc = " ".join(f"{k}={v}" for k, v in
                      sorted(cls["outcomes"].items()))
        fo = ""
        if cls.get("failed_over"):
            fo = (f"   failed-over {cls['failed_over']} "
                  f"({cls['failover_hops']} hops)")
        lines.append(f"class {slo}: n={cls['requests']}   {oc}{fo}")
        for key in ("ttft_ms",) + COMPONENTS + ("tpot_ms",):
            c = cls["components"][key]
            if not c["n"]:
                continue
            tail = f"   p99-req {c['p99_request_id']}" \
                if key == "ttft_ms" else ""
            lines.append(f"  {key:<14s} p50 {c['p50']:>9.2f}   "
                         f"p99 {c['p99']:>9.2f}   (n={c['n']}){tail}")
    if s["slowest_retained"]:
        lines.append("slowest retained timelines:")
        for e in s["slowest_retained"]:
            hop = (f" failovers={e['failovers']}"
                   if e.get("failovers") else "")
            lines.append(
                f"  {e['request_id']}  slo={e['slo']} "
                f"outcome={e['outcome']}{hop} ttft={e['ttft_ms']}ms "
                f"(queue {e.get('queue_wait_ms')} / prefill "
                f"{e.get('prefill_ms')} / first-tick "
                f"{e.get('first_tick_ms')})")
            for t, kind, fields in e.get("events", [])[:24]:
                extra = " ".join(f"{k}={v}" for k, v in fields.items())
                lines.append(f"    {t:>10.3f}ms  {kind:<14s} {extra}")
    fl = s.get("fleet")
    if fl:
        lines.append(
            f"fleet: {fl['cross_process_requests']} cross-process "
            f"requests ({fl['with_peer_failover']} rode a peer "
            f"failover)")
        for c in fl["chains"]:
            oc = " ".join(f"{w}={o}" for w, o in
                          sorted(c["outcomes"].items()))
            lines.append(f"  {c['request_id']}  "
                         f"{' -> '.join(c['chain'])}  "
                         f"peer_failovers={c['peer_failovers']}  {oc}")
            for t, where, kind, fields in c["events"][:32]:
                extra = " ".join(f"{k}={v}"
                                 for k, v in fields.items())
                lines.append(f"    {t:.3f}  {where:<24s} "
                             f"{kind:<14s} {extra}")
    cj = s.get("client_join")
    if cj:
        w = cj["wire_overhead_ms"]
        lines.append(
            f"client join: {cj['matched']}/{cj['client_records']} "
            f"matched ({cj['client_only']} client-only: "
            f"{cj['client_only_outcomes']})   wire overhead "
            f"p50 {w['p50']:.2f}ms p99 {w['p99']:.2f}ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rings", nargs="+",
                    help="reqtrace_*.json files or dirs holding them")
    ap.add_argument("--jsonl", default=None,
                    help="loadgen per-request JSONL to join "
                         "(tools/serve_loadgen.py --jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest retained timelines to print")
    ns = ap.parse_args(argv)
    docs = load_rings(ns.rings)
    if not docs:
        print("no valid trace rings found", file=sys.stderr)
        return 2
    client = load_client_jsonl(ns.jsonl) if ns.jsonl else None
    s = summarize(docs, client=client, top=ns.top)
    print(json.dumps(s) if ns.json else render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
