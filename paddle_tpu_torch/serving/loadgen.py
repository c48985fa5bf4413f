"""Open-loop load generator for the port's serving gateway and fleet
(counterpart of ``tools/serve_loadgen.py``; reference: the open-loop
methodology of the serving comparisons in PAPERS.md — arrivals keep
coming at the offered rate whether or not the server keeps up, so
queueing delay shows up in TTFT instead of being hidden by a closed
loop).

    python -m paddle_tpu_torch.serving.loadgen
        [--model stub|tiny|llama3-8b|llama3-70b|ernie-tiny|ernie45-21b-a3b]
        [--device cpu] [--fleet N [--tp T [--ep E]] [--fleet-kill K] [--frontends F
        --frontend-kill K] [--autoscale]] [--url HOST:PORT ... [--tp T]]
        [--chaos] [--spill on] [--migrate on] [--churn] [--diurnal]
        [--jsonl PATH] [--trace-dir DIR] [--out PATH]

Default mode self-hosts a gateway in-process (tiny-llama replicas with
chunked prefill + prefix caching; ``--model stub`` swaps in a
negligible-compute stub so CI measures the gateway machinery, not the
model; ``--model llama3-8b`` serves Llama-3-8B at full width with random
weights in the card's serving geometry). ``--url HOST:PORT`` attaches to
an external gateway instead. The engines run on the CUDA card unless
``--device cpu`` asks for the CPU. ``--tp T`` makes each ``--fleet``
replica a tensor-parallel one of T rank processes (``replica_main --tp
T`` under the launcher, T cards a replica), the only way to serve
``--model llama3-70b`` (``--url`` accepts both flags: the remote
replicas were started with their own). ``--ep E`` splits an MoE model's
experts (``--model ernie45-21b-a3b``) over E more ranks a replica (T x E
processes and cards). The in-process gateway serves at tp 1.

Workload: ``--share-frac`` of requests carry a shared, chunk-grid-
aligned system prompt (``--sys-tokens``) plus a short unique tail —
the prompt-sharing mix knob that makes prefix-affinity routing
measurable; the rest are fully random prompts. ``--interactive-frac``
splits the SLO-class mix.

Reports ONE ``LOADGEN_JSON`` line: p50/p99 TTFT + TPOT, total
tokens/s, goodput (tokens from requests whose TTFT met
``--ttft-slo-ms``, per second), shed/timeout counts and the
prefix-route hit split. ``--out PATH`` also writes it to a file; by
default nothing is written.

``--chaos`` turns the run into the seeded fault-tolerance acceptance
harness: replicas are killed/hung mid-run at deterministic points, every
completed greedy stream is replayed BITWISE against a fresh reference
engine, and the run fails (nonzero exit) on any corrupted stream, on 5xx
counts beyond the retry-budget bound, or on a completed fraction below
``--goodput-floor``.

Telemetry: the self-hosted gateways run the time-series sampler + SLO
burn-rate alerting by default, and the rung banks the fired-alert log,
the peak burn rate per class and the windowed tok/s trajectory summary.
``--slo-windows 0.01`` scales the burn windows down so a CI-length run
can fire; ``--telemetry off`` is the A/B reference.

``--spill on`` hands the self-hosted replicas one shared host-RAM
:class:`KVSpillArena`: spans evicted under block pressure (and
everything parked at drain) are checksummed into the arena, and a warm
miss — including on a supervisor-REBUILT replica after a chaos kill —
restores them instead of re-prefilling. The rung banks
``kv_spill_hit_frac`` and ``kv_spill_restored_tokens``; ``--spill off``
(default) is the A/B reference every greedy stream must match bitwise.

``--churn`` swaps in a transition-heavy mix — short, staggered
per-request budgets so replica slots finish and readmit every few ticks
— and the rung records ``full_rebuilds`` / ``delta_patches`` /
``h2d_upload_bytes``; ``--delta off`` and ``--patch-fuse off`` keep the
full-rebuild and standalone-patch references.

Fleet mode: ``--url`` may repeat (client-side round-robin over several
fleet front doors), ``--diurnal`` replaces the flat offered rate with a
seeded sinusoid over the run (the autoscaler's evaluation trace), and
``--fleet N`` self-hosts N SEPARATE gateway processes
(:mod:`.fleet.replica_main`) behind an in-process :class:`FleetFrontend`.
``--fleet-kill K`` SIGKILLs K replica processes at seeded mid-run points
(completed greedy stub streams replay bitwise, the goodput floor
applies); ``--frontends F --frontend-kill K`` runs gossip-linked sibling
frontends and kills some mid-run; ``--autoscale`` runs the closed-loop
:class:`FleetAutoscaler` and the rung reports ``fleet_tokens_per_sec``
plus goodput-per-replica (good tokens per replica-second).
"""
import argparse
import asyncio
import json
import math
import os
import random
import sys
import time

import torch


def diurnal_rate(i: int, n_requests: int, base_rate: float,
                 amp: float = 0.8, cycles: float = 1.0,
                 phase: float = 0.0) -> float:
    """Seeded sinusoidal offered-rate trace: request ``i``
    of ``n_requests`` arrives at instantaneous rate
    ``base * (1 + amp * sin(2*pi*cycles*i/n + phase))`` — a compressed
    diurnal load curve the autoscaler must ride up AND back down.
    Floored at 5% of base so the open loop never stalls entirely.
    Deterministic in (i, n, base, amp, cycles, phase); the CLI derives
    ``phase`` from ``--seed``."""
    frac = i / max(n_requests - 1, 1)
    r = base_rate * (1.0 + amp * math.sin(
        2.0 * math.pi * cycles * frac + phase))
    return max(r, 0.05 * base_rate)


# ------------------------------------------------------------------ client
async def sse_generate(host: str, port: int, payload: dict,
                       timeout_s: float = 120.0,
                       request_id: str = None, skip: int = 0,
                       ha: bool = False, on_token=None):
    """One SSE request; returns a per-request record with wire-level
    TTFT/TPOT timings (measured at the CLIENT, queueing included).
    ``request_id`` is the CLIENT-minted trace id, sent as
    the ``X-Request-Id`` header the gateway honors — the join key a
    trace report matches client and server views on.

    HA: ``skip`` drops the first N token events (a resumed
    stream re-emits the committed prefix first — dedupe by count, the
    frontend's own rule one tier down); ``ha=True`` converts a
    MID-STREAM connection loss (frontend SIGKILL) into a returned
    record with ``finish_reason="severed"`` carrying the committed
    tokens/lps, instead of raising them away — the caller retries
    against a sibling with that prefix as ``resume_tokens``."""
    rec = {"status": 0, "tokens": [], "lps": [], "ttft_ms": None,
           "tpot_ms": None, "finish_reason": None,
           "retry_after": None, "request_id": request_id}
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode()
        rid_hdr = (f"X-Request-Id: {request_id}\r\n"
                   if request_id else "")
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                      f"{rid_hdr}"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        status = await asyncio.wait_for(reader.readline(), timeout_s)
        parts = status.split()
        if len(parts) < 2:
            # EOF before a status line (server mid-restart closed the
            # accepted connection): a per-request conn_error, not a
            # run-killing IndexError
            raise ConnectionError("connection closed before response")
        rec["status"] = int(parts[1])
        while True:   # headers
            ln = await asyncio.wait_for(reader.readline(), timeout_s)
            if ln in (b"\r\n", b"\n", b""):
                break
            if ln.lower().startswith(b"retry-after:"):
                rec["retry_after"] = ln.split(b":", 1)[1].strip().decode()
        if rec["status"] != 200:
            rec["finish_reason"] = "rejected"
            return rec
        t_first = t_last = None
        seen = 0
        try:
            while True:
                ln = await asyncio.wait_for(reader.readline(),
                                            timeout_s)
                if not ln:
                    if ha:
                        rec["finish_reason"] = "severed"
                    break
                ln = ln.strip()
                if not ln.startswith(b"data: "):
                    continue
                ev = json.loads(ln[6:])
                if ev.get("done"):
                    rec["finish_reason"] = ev.get(
                        "finish_reason",
                        "error" if "error" in ev else None)
                    if skip == 0:
                        rec["tokens"] = ev.get("tokens", rec["tokens"])
                    else:
                        # resumed stream: keep the streamed NEW tokens
                        # authoritative for the caller's merge; the
                        # server's full list rides along for the
                        # bitwise cross-check
                        rec["final_tokens"] = ev.get("tokens")
                    break
                seen += 1
                if seen <= skip:
                    continue    # committed-prefix replay: dedupe
                now = time.perf_counter()
                t_last = now
                if t_first is None:
                    t_first = now
                    rec["ttft_ms"] = (now - t0) * 1e3
                rec["tokens"].append(ev["token"])
                rec["lps"].append(ev.get("lp"))
                if on_token is not None:
                    # --migrate probe hook: lets the caller fire a
                    # mid-stream drain at a deterministic token count
                    on_token(seen)
        except (ConnectionError, OSError) as e:
            # mid-stream sever (the frontend died under us): the
            # committed prefix in rec is the client's resume state
            if not ha:
                raise
            rec["finish_reason"] = "severed"
            rec["error"] = repr(e)[:80]
        n = len(rec["tokens"])
        if t_first is not None and t_last is not None and n >= 2:
            rec["tpot_ms"] = (t_last - t_first) / (n - 1) * 1e3
        return rec
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def sse_generate_ha(targets, start: int, payload: dict,
                          timeout_s: float = 120.0,
                          request_id: str = None, resumes: int = 2):
    """Leaderless-HA client: one logical request across up
    to ``resumes`` frontend failovers. A severed stream (frontend
    SIGKILL mid-flight) is retried against the NEXT frontend with the
    committed prefix as ``resume_tokens``/``resume_lps`` — the same
    resubmit the frontend itself performs one tier down when a PEER
    dies — so the client sees every token exactly once and a greedy
    stream stays bitwise the uninterrupted run's."""
    orig_prompt = list(payload["prompt"])
    orig_max = int(payload["max_new_tokens"])
    committed, lps = [], []
    first_ttft = None
    rec = None
    for attempt in range(resumes + 1):
        h, p = targets[(start + attempt) % len(targets)]
        if committed:
            spec = dict(payload,
                        prompt=orig_prompt + committed,
                        resume_tokens=list(committed),
                        resume_lps=list(lps),
                        max_new_tokens=orig_max - len(committed))
        else:
            spec = payload
        try:
            rec = await sse_generate(h, p, spec, timeout_s,
                                     request_id=request_id,
                                     skip=len(committed), ha=True)
        except (ConnectionError, OSError) as e:
            # refused/reset before any response (corpse still in the
            # client's rotation): nothing new committed, next sibling
            rec = {"status": 0, "tokens": [], "lps": [],
                   "ttft_ms": None, "tpot_ms": None,
                   "finish_reason": "severed", "retry_after": None,
                   "request_id": request_id, "error": repr(e)[:80]}
        if rec["ttft_ms"] is not None and first_ttft is None:
            first_ttft = rec["ttft_ms"]
        if rec["finish_reason"] == "severed":
            committed += rec["tokens"]
            lps += rec["lps"]
            continue
        # terminal (done / rejected / error): merge the resume chain
        rec["resumes"] = attempt
        if committed:
            full = committed + rec["tokens"]
            ft = rec.pop("final_tokens", None)
            if ft is not None and ft != full:
                # the server's authoritative list disagrees with the
                # client's merge: a real token was lost or duplicated
                # across the failover — surface it, don't paper over
                rec["resume_mismatch"] = {"client": len(full),
                                          "server": len(ft)}
            rec["tokens"] = full
            rec["lps"] = lps + rec["lps"]
            rec["ttft_ms"] = first_ttft
        return rec
    # every attempt severed: report the request as a conn_error with
    # whatever prefix was committed (the gate counts it against the
    # goodput floor)
    rec = dict(rec, tokens=committed + rec["tokens"],
               finish_reason="conn_error", resumes=resumes)
    return rec


# ----------------------------------------------------------------- fleet
def _build_gateway(ns):
    """Self-hosted replica fleet: chunked prefill + prefix caching on
    every engine so affinity routing has warm blocks to find. Returns
    ``(gateway, engines, engine_factory)`` — the factory is what
    ``--chaos`` hands the supervisor so killed replicas rebuild on
    fresh engines."""
    from ..generation.paged import PagedEngine
    from . import Gateway
    from .fleet.replica_main import build_model, engine_kw as geometry

    engine_kw = geometry(ns.model, _chunk(ns))
    if ns.model == "stub":
        # non-chaos rung semantics unchanged: ONE shared stub (ticks
        # serialize on the per-model lock exactly as before). Under
        # --chaos each engine gets its own stub — a hung replica's
        # abandoned thread must never share a layer tree (or a tick
        # lock) with its replacement.
        shared_stub = None if getattr(ns, "chaos", False) \
            else _stub_model(ns)

        def _model():
            return shared_stub if shared_stub is not None \
                else _stub_model(ns)
    else:
        # the Llama's weights are drawn from seed 0 whatever --seed
        # says (the traffic's seed), as the fleet's replica processes
        # draw theirs
        model = build_model(ns.model, getattr(ns, "device", None), 0)

        def _model():
            return model
    # --ring off: the synchronous-readback reference engines (the
    # A/B — same workload, same gateway, only the tick readback
    # architecture differs); --delta off likewise keeps the full-
    # rebuild transition reference (A/B)
    engine_kw["ring_mode"] = getattr(ns, "ring", "on") == "on"
    engine_kw["delta_transitions"] = \
        getattr(ns, "delta", "on") == "on"
    # --patch-fuse off: the standalone-patch-dispatch reference
    # (A/B — same descriptors, dispatched one tiny program
    # per transition instead of staged into the tick). Only the "off"
    # side is passed through: the default (None) lets the engine fuse
    # whenever delta transitions are on.
    if getattr(ns, "patch_fuse", "on") == "off" \
            and engine_kw["delta_transitions"]:
        engine_kw["patch_fuse"] = False
    # --tick-profile on: per-tick phase attribution — the
    # rung banks phase_breakdown from the engines' phase totals
    engine_kw["tick_profile"] = \
        getattr(ns, "tick_profile", "off") == "on"

    chaos = bool(getattr(ns, "chaos", False))
    # host-RAM KV spill tier (A/B): --spill on hands every
    # replica (and every supervisor REBUILD) one shared arena, so
    # evicted/killed warm prefixes restore instead of re-prefilling;
    # --spill off (default) is the reference the bitwise gate and the
    # kv_spill_hit_frac rung compare against
    spill_arena = None
    migrate_on = getattr(ns, "migrate", "off") == "on"
    if getattr(ns, "spill", "off") == "on" or migrate_on:
        # --migrate on implies an arena: migration IS spill + wire
        # (export_resumable descriptors serialized D2H)
        from .kvspill import KVSpillArena
        spill_arena = KVSpillArena(
            int(getattr(ns, "spill_mb", 256)) << 20,
            name="loadgen")
    # telemetry plane: sampler + burn-rate alerting default
    # ON (host-side, pinned harmless); --telemetry off is the A/B
    # reference that reproduces the pre-plane gateway exactly.
    # --slo-windows scales the burn windows so a CI-length run can
    # fire (and resolve) real alerts.
    if getattr(ns, "telemetry", "on") == "on":
        gw_telemetry_kw = dict(
            slo_window_scale=getattr(ns, "slo_windows", 1.0))
    else:
        gw_telemetry_kw = dict(sample_interval_s=None,
                               slo_alerting=False)

    def engine_factory():
        eng = PagedEngine(_model(), **engine_kw)
        if chaos:
            # warm-before-traffic (what a real fleet's readiness
            # probe guarantees): a cold engine's FIRST steps pay the
            # kernel loads and graph captures — far over the sub-second
            # chaos watchdog deadline — so warm every engine (and
            # every supervisor REBUILD, which runs this same factory)
            # before it can take traffic
            eng.submit("warmup", list(range(1, 5)), max_new_tokens=4)
            eng.run()
            eng.results.pop("warmup", None)
            eng.logprobs.pop("warmup", None)
        return eng

    engines = [engine_factory() for _ in range(ns.replicas)]
    gw_kw = dict(routing=ns.policy, max_queue=ns.max_queue,
                 spill_arena=spill_arena, **gw_telemetry_kw)
    if migrate_on:
        # live requests at drain time cut over (terminal migrated
        # events + resume_kv spans) instead of finishing here
        gw_kw.update(migrate_on_drain=True)
    if chaos:
        # fast-recovery supervision knobs sized for a short chaos run:
        # sub-second watchdog + breaker backoff so kills, failovers
        # AND rejoins all land inside the measured window
        gw_kw.update(engine_factory=engine_factory,
                     failover_budget=getattr(ns, "failover_budget", 2),
                     watchdog_timeout_s=getattr(
                         ns, "watchdog_timeout_s", 0.5),
                     watchdog_interval_s=0.02,
                     breaker_backoff_s=0.2)
    gw = Gateway(engines, **gw_kw)
    return gw, engines, engine_factory


def _stub_model(ns):
    """Negligible-compute CausalLM: loadgen numbers then measure
    gateway + engine machinery, not model FLOPs (the shared reference
    stub in ``paddle_tpu_torch/generation/stub.py``)."""
    from .fleet.replica_main import build_model
    return build_model("stub", getattr(ns, "device", None))


def _chunk(ns) -> int:
    """The engines' prefill chunk: the shared system prompt's length
    (so it lands on the chunk grid), else the model's default."""
    return ns.sys_tokens or {"stub": 8, "tiny": 32, "llama3-8b": 128,
                             "llama3-70b": 128, "ernie-tiny": 32,
                             "ernie45-21b-a3b": 128}[ns.model]


def _build_fleet(ns):
    """Fleet mode: spawn ``--fleet`` SEPARATE gateway
    processes (``fleet/replica_main.py``, warmed before ready) and an
    in-process :class:`FleetFrontend` routing over their
    :class:`RemoteReplica` adapters. Returns
    ``(frontend, manager, autoscaler_or_None)`` — the frontend is NOT
    started yet (the caller awaits ``start()`` on its loop)."""
    from .fleet import (FleetAutoscaler, FleetFrontend,
                        LocalProcessManager, link_frontends)
    chunk = _chunk(ns)
    n_fe = max(int(getattr(ns, "frontends", 1) or 1), 1)
    fes = []
    for i in range(n_fe):
        # the single-frontend name stays "fleet" (metric labels and
        # rung fields downstream key on it); HA siblings are fleet0..
        name = "fleet" if n_fe == 1 else f"fleet{i}"
        fes.append(FleetFrontend(
            [], chunk_tokens=chunk, routing=ns.policy,
            failover_budget=getattr(ns, "failover_budget", 2),
            breaker_backoff_s=0.2, name=name))
    fe = fes[0]
    links = []
    if n_fe > 1:
        # leaderless HA: full-mesh gossip of prefix
        # digests, breaker states and sticky assignments — a fast
        # cadence so a CI-length run converges before the kill
        links = link_frontends(fes, interval_s=0.25,
                               seed=getattr(ns, "seed", 0))
    extra = []
    trace_dir = getattr(ns, "trace_dir", None)
    if trace_dir:
        # peer gateways dump their reqtrace rings here on SIGTERM
        # drain — the multi-run-dir input trace_report's fleet merge
        # joins with the frontend's own ring by request id (
        # their series_<gw>.json trajectories land beside them)
        extra += ["--run-dir", trace_dir]
    if getattr(ns, "telemetry", "on") == "on":
        # thread the CI-speed burn windows into the replica PROCESSES
        # so their engines can fire alerts inside a short run; the
        # frontend's federated /metricsz surfaces them
        scale = getattr(ns, "slo_windows", 1.0)
        if scale != 1.0:
            extra += ["--slo-window-scale", str(scale)]
    else:
        extra += ["--telemetry", "off"]
    if getattr(ns, "spill", "off") == "on" \
            or getattr(ns, "migrate", "off") == "on":
        # each replica PROCESS gets its own arena (host RAM dies with
        # the process; migrated spans ship inline over /kvz during the
        # drain grace window, so cross-process cutover still restores)
        extra += ["--spill-mb", str(int(getattr(ns, "spill_mb", 256)))]
        if getattr(ns, "migrate", "off") == "on":
            extra += ["--migrate", "on"]
    manager = LocalProcessManager(
        fes, model=ns.model, chunk_tokens=chunk,
        device=getattr(ns, "device", None), extra_args=extra,
        tp=getattr(ns, "tp", None), ep=getattr(ns, "ep", None),
        probe_interval_s=0.1, stale_after_s=1.5)
    for _ in range(ns.fleet):
        manager.spawn()
    scaler = None
    if getattr(ns, "autoscale", False):
        scaler = FleetAutoscaler(
            manager,
            min_replicas=getattr(ns, "autoscale_min", 1),
            max_replicas=getattr(ns, "autoscale_max",
                                 max(ns.fleet, 2)),
            up_queue_depth=1.0, hold_s=0.3, hold_down_s=1.5,
            cooldown_s=getattr(ns, "autoscale_cooldown_s", 3.0),
            interval_s=0.1,
            signal_mode=getattr(ns, "autoscale_mode", "windowed"),
            signal_window_s=getattr(ns, "autoscale_window_s", 1.0))
        fe.attach_autoscaler(scaler)
    return fes, manager, scaler, links


# ---------------------------------------------------- migrate A/B probe
async def _migrate_probe(ns) -> dict:
    """Drain-migration A/B: a dedicated two-gateway mini
    fleet, SIGTERM-drained mid-stream, run twice — ``on`` resolves
    each migrated stream's ``resume_kv`` span so the survivor RESTORES
    the KV, ``off`` is the re-prefill control (identical cut-over, no
    transfer). The drain point is deterministic (fired by the client
    the moment every stream has its first token), prompts are UNIQUE
    (survivor prefix hits can only come from the transfer), so
    ``recompute = resubmitted prefill tokens - prefix-hit tokens`` is
    measured, not modeled. Retries with fresh gateway names if the
    race between drain and stream completion yields zero migrations.
    """
    from ..generation.paged import PagedEngine
    from ..utils import observability as obs
    from . import Gateway, kvxfer
    from .fleet import FleetFrontend, RemoteReplica
    from .fleet.replica_main import stub_engine_kw
    from .kvspill import KVSpillArena

    reqs = max(int(getattr(ns, "migrate_requests", 6)), 2)
    prompt_len, max_new = 64, 32
    rng = random.Random(ns.seed + 11)
    prompts = [[rng.randrange(1, 120) for _ in range(prompt_len)]
               for _ in range(reqs)]

    def _eng():
        eng = PagedEngine(_stub_model(ns), **stub_engine_kw(8))
        eng.submit("warmup", list(range(1, 5)), max_new_tokens=4)
        eng.run()
        eng.results.pop("warmup", None)
        eng.logprobs.pop("warmup", None)
        return eng

    # uninterrupted single-engine reference: the bitwise truth both
    # modes (and every migrated stream) must reproduce
    ref = PagedEngine(_stub_model(ns), **stub_engine_kw(8))
    for i in range(reqs):
        ref.submit(f"migprobe-{i:03d}", prompts[i],
                   max_new_tokens=max_new)
    expect = ref.run()

    async def _run_mode(mode: str, attempt: int):
        gws = []
        for j in range(2):
            # attempt-unique names: kvxfer counters key on the
            # gateway name, and a retry must not inherit stale counts
            name = f"migprobe{attempt}-{mode}{j}"
            gw = Gateway([_eng()], name=name,
                         spill_arena=KVSpillArena(64 << 20, name=name),
                         migrate_on_drain=True)
            await gw.start()
            gws.append(gw)
        fleet_name = f"migprobe{attempt}-{mode}"
        reps = [RemoteReplica(g.name, g.host, g.port,
                              probe_interval_s=0.05) for g in gws]
        fe = FleetFrontend(reps, chunk_tokens=8, name=fleet_name,
                           migrate=(mode == "on"),
                           breaker_backoff_s=60.0)
        await fe.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and not all(r.healthy() for r in reps):
            await asyncio.sleep(0.02)

        firsts = [False] * reqs
        fired = []

        def _on_token(i):
            firsts[i] = True
            if all(firsts) and not fired:
                # every stream is live: drain gateway 0 — its
                # in-flight requests cut over to gateway 1
                fired.append(asyncio.ensure_future(
                    gws[0].drain(migrate=True)))

        async def _one(i):
            rec = await sse_generate(
                fe.host, fe.port,
                {"prompt": prompts[i], "max_new_tokens": max_new,
                 "temperature": 0.0, "stream": True,
                 "timeout_s": 60.0},
                request_id=f"migprobe-{i:03d}",
                on_token=lambda n, i=i: _on_token(i))
            return i, rec

        done = await asyncio.gather(*[_one(i) for i in range(reqs)])
        if fired:
            await fired[0]
        hz = fe.healthz()
        mig_events = [e for e in obs.recorder().snapshot()
                      if e.get("kind") == "fleet_peer_migrated"
                      and e.get("fleet") == fleet_name]
        resubmit_prefill = sum(prompt_len + int(e.get("committed", 0))
                               for e in mig_events)
        engs = [w.engine for g in gws for w in g._workers]
        restored = sum(e.stats.get("spill_restored_tokens", 0)
                       for e in engs)
        hits = sum(e.stats.get("prefix_hit_tokens", 0) for e in engs)
        xfer = {}
        for g in gws:
            for k, v in kvxfer.counters_snapshot(g.name).items():
                xfer[k] = xfer.get(k, 0) + int(v)
        await fe.drain()
        for g in gws:
            await g.drain()
        toks = {i: list(r["tokens"]) for i, r in done}
        lps = {i: list(r.get("lps", ())) for i, r in done}
        res = {
            "migrated": int(hz.get("migrated_requests", 0)),
            "resubmit_prefill_tokens": resubmit_prefill,
            "prefix_hit_tokens": hits,
            "restored_tokens": restored,
            "recompute_tokens": max(resubmit_prefill - hits, 0),
            "errors": sum(1 for _, r in done
                          if r["finish_reason"] != "stop"),
            "corrupted_streams": sum(
                1 for i, r in done
                if r["finish_reason"] == "stop"
                and r["tokens"] != expect[f"migprobe-{i:03d}"]),
            "xfer": xfer,
        }
        return res, toks, lps

    probe = {"requests": reqs, "prompt_tokens": prompt_len,
             "max_new": max_new, "modes": {}}
    toks_m, lps_m = {}, {}
    for attempt in range(3):
        for mode in ("on", "off"):
            res, toks, lps = await _run_mode(mode, attempt)
            probe["modes"][mode] = res
            toks_m[mode], lps_m[mode] = toks, lps
        probe["attempts"] = attempt + 1
        if probe["modes"]["on"]["migrated"] >= 1:
            break
    on, off = probe["modes"]["on"], probe["modes"]["off"]
    probe["kv_xfer_hit_frac"] = round(
        on["restored_tokens"]
        / max(on["resubmit_prefill_tokens"], 1), 4)
    probe["recompute_tokens_saved"] = \
        off["recompute_tokens"] - on["recompute_tokens"]
    probe["recompute_amplification"] = round(
        off["recompute_tokens"] / max(on["recompute_tokens"], 1), 2)
    # bitwise A/B parity: migration must never change what a greedy
    # client observes — tokens exactly, logprobs to float tolerance
    # (prefill- vs decode-computed KV differ in the last ulp; the
    # existing resume contract)
    probe["parity_ok"] = all(
        toks_m["on"].get(i) == toks_m["off"].get(i)
        for i in range(reqs))
    diff = 0.0
    for i in range(reqs):
        for a, b in zip(lps_m["on"].get(i) or (),
                        lps_m["off"].get(i) or ()):
            if a is not None and b is not None:
                diff = max(diff, abs(float(a) - float(b)))
    probe["lps_max_abs_diff"] = round(diff, 9)
    probe["ok"] = bool(probe["parity_ok"]
                       and on["corrupted_streams"] == 0
                       and off["corrupted_streams"] == 0
                       and on["errors"] == 0 and off["errors"] == 0)
    return probe


# ------------------------------------------------------------------- run
def _tok_trajectory(sampler, base="gateway_tokens_total",
                    max_points=24):
    """Windowed tok/s trajectory summary: the
    sampled cumulative token counters (summed across label variants)
    differenced into a rate series, downsampled to <= max_points —
    the shape trend lines can carry so a rung records HOW
    the run served, not just its end-of-run mean."""
    import math as _math
    by_t = {}
    for name in sampler.names():
        if name.split("{", 1)[0] != base:
            continue
        for t, v in sampler.series(name):
            by_t[t] = by_t.get(t, 0.0) + v
    pts = sorted(by_t.items())
    rates = [(b[0], (b[1] - a[1]) / (b[0] - a[0]))
             for a, b in zip(pts, pts[1:]) if b[0] > a[0]]
    if not rates:
        return None
    t0 = pts[0][0]
    stride = max(1, _math.ceil(len(rates) / max_points))
    return {
        "points": [[round(t - t0, 2), round(r, 1)]
                   for t, r in rates[::stride]],
        "peak": round(max(r for _, r in rates), 1),
        "mean": round(sum(r for _, r in rates) / len(rates), 1),
        "samples": len(rates),
    }


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


async def run_loadgen(ns) -> dict:
    rng = random.Random(ns.seed)
    gw = engines = engine_factory = None
    fe = manager = scaler = None
    fes, fe_links = [], []
    chaos = bool(getattr(ns, "chaos", False))
    fleet = int(getattr(ns, "fleet", 0) or 0)
    urls = ns.url if isinstance(ns.url, list) \
        else ([ns.url] if ns.url else [])
    if (urls or fleet) and getattr(ns, "delta", "on") == "off":
        # --fleet replica processes and external --url servers run
        # their own engine defaults (replica_main has no --delta);
        # silently recording "delta": "off" would mislabel a delta-on
        # run as the full-rebuild reference in the A/B rung
        raise SystemExit("--delta off requires in-process replicas "
                         "(no --fleet / --url): fleet peers and "
                         "external servers don't receive it")
    if (urls or fleet) and getattr(ns, "patch_fuse", "on") == "off":
        # same mislabeling hazard as --delta off: the knob only
        # reaches engines this process constructs
        raise SystemExit("--patch-fuse off requires in-process "
                         "replicas (no --fleet / --url)")
    if (urls or fleet) and getattr(ns, "tick_profile", "off") == "on":
        # phase_breakdown is summed from THIS process's engine
        # objects; fleet replica processes and external servers never
        # see the knob, so the rung would bank an empty breakdown
        raise SystemExit("--tick-profile on requires in-process "
                         "replicas (no --fleet / --url)")
    tp = getattr(ns, "tp", None)
    ep = getattr(ns, "ep", None)
    if not (urls or fleet) and ((tp or 1) > 1 or (ep or 1) > 1
                                or ns.model == "llama3-70b"):
        raise ValueError(
            f"the in-process gateway serves at tp 1 (--tp {tp}, --ep {ep}, "
            f"--model {ns.model}): a tp replica is N rank processes, so "
            f"serve it with --fleet K --tp N, or attach to one with --url")
    if ep is not None and tp is None:
        raise ValueError("--ep needs --tp (a replica's ranks are tp x ep)")
    if int(getattr(ns, "frontends", 1) or 1) > 1 and not fleet:
        raise SystemExit("--frontends needs --fleet: sibling "
                         "frontends share one replica-process fleet")
    if urls:
        if chaos or fleet:
            raise SystemExit("--chaos/--fleet require self-hosted "
                             "mode (they inject faults into / spawn "
                             "their own fleet)")
        targets = []
        for u in urls:
            h, _, p = u.partition(":")
            targets.append((h, int(p)))
    elif fleet:
        if chaos:
            raise SystemExit("--chaos is the single-process harness; "
                             "the fleet analogue is --fleet-kill")
        fes, manager, scaler, fe_links = _build_fleet(ns)
        fe = fes[0]
        for f in fes:
            await f.start()
        targets = [(f.host, f.port) for f in fes]
    else:
        gw, engines, engine_factory = _build_gateway(ns)
        await gw.start()
        if gw.sampler is not None:
            # explicit t0 baseline: the sampler thread's first tick is
            # a full interval away, and a warm-cache CI run can finish
            # inside it — without this the tok/s trajectory would need
            # two timer ticks it never gets
            gw.sampler.sample()
        targets = [(gw.host, gw.port)]
    # fleet-mode trajectory: the frontend's own proxied-
    # token counter lives in THIS process's registry — a local sampler
    # over it yields the fleet tok/s series the rung banks (replica-
    # side series land in --trace-dir as series_<gw>.json on drain)
    local_sampler = None
    if fe is not None and getattr(ns, "telemetry", "on") == "on":
        from ..utils import observability as obs
        local_sampler = obs.MetricsTimeSeries(
            name="loadgen", interval_s=0.2, capacity=1024).start()
        local_sampler.sample()    # t0 baseline (see gateway twin)
    host, port = targets[0]
    # chaos schedule: seeded kill/hang points spread evenly
    # over the request stream — deterministic per (--seed,
    # --chaos-kills, --chaos-mode), replica picked by a seeded RNG
    chaos_plan = {}
    chaos_events = []
    if chaos:
        if ns.replicas < 2:
            raise SystemExit("--chaos needs --replicas >= 2: failover "
                             "requires a surviving replica, so a "
                             "single-replica chaos run can only fail")
        if getattr(ns, "chaos_mode", "mix") == "hang" \
                or getattr(ns, "chaos_mode", "mix") == "mix":
            # a finite injected hang: the abandoned thread wakes after
            # the watchdog already replaced it, sees the flag and exits
            os.environ.setdefault("PADDLE_TPU_FAULT_DISPATCH_HANG_S",
                                  "2")
        crng = random.Random(ns.seed + 1)
        kinds = {"kill": ("crash",), "hang": ("hang",),
                 "mix": ("crash", "hang")}[getattr(ns, "chaos_mode",
                                                   "mix")]
        kills = max(int(getattr(ns, "chaos_kills", 2)), 1)
        for j in range(kills):
            pt = max(1, round((j + 1) * ns.requests / (kills + 1)))
            while pt in chaos_plan and pt < ns.requests - 1:
                pt += 1
            if pt in chaos_plan:
                # more kills than schedulable request points: say so
                # instead of silently under-delivering fault coverage
                print(f"warning: only {len(chaos_plan)} of "
                      f"{kills} --chaos-kills fit before request "
                      f"{ns.requests}", file=sys.stderr)
                break
            chaos_plan[pt] = (kinds[j % len(kinds)],
                              crng.randrange(ns.replicas))
    # fleet process-kill schedule: seeded SIGKILL points —
    # the remote analogue of --chaos (no in-process hooks exist into a
    # separate gateway process; death arrives as dropped connections
    # and failed probes, which is exactly what the failover must eat)
    fleet_kill_plan = set()
    fleet_kill_events = []
    if fleet and int(getattr(ns, "fleet_kill", 0) or 0) > 0:
        kk = int(ns.fleet_kill)
        for j in range(kk):
            pt = max(1, round((j + 1) * ns.requests / (kk + 1)))
            while pt in fleet_kill_plan and pt < ns.requests - 1:
                pt += 1
            if pt in fleet_kill_plan:
                print(f"warning: only {len(fleet_kill_plan)} of {kk} "
                      f"--fleet-kill points fit", file=sys.stderr)
                break
            fleet_kill_plan.add(pt)
    # frontend SIGKILL schedule (HA): sever a FRONTEND
    # mid-run — the last single point of failure. Clients recover by
    # resuming against a surviving sibling; requires >= 2 frontends.
    fe_kill_plan = set()
    fe_kill_events = []
    fe_dead = set()
    n_fe_kills = int(getattr(ns, "frontend_kill", 0) or 0)
    if n_fe_kills > 0:
        if len(fes) < 2:
            raise SystemExit("--frontend-kill needs --frontends >= 2: "
                             "clients must have a survivor to resume "
                             "against")
        if n_fe_kills >= len(fes):
            raise SystemExit(f"--frontend-kill {n_fe_kills} would "
                             f"leave no survivor of {len(fes)} "
                             "frontends")
        for j in range(n_fe_kills):
            pt = max(1, round((j + 1) * ns.requests
                              / (n_fe_kills + 1)))
            while pt in fe_kill_plan and pt < ns.requests - 1:
                pt += 1
            fe_kill_plan.add(pt)
    krng = random.Random(ns.seed + 2)
    # seeded diurnal phase: the trace is deterministic per --seed
    phase = random.Random(ns.seed + 3).uniform(0, 2 * math.pi)
    vocab = 120
    sysp = [rng.randrange(1, vocab) for _ in range(ns.sys_tokens)]

    def _payload(i):
        shared = rng.random() < ns.share_frac
        tail = [rng.randrange(1, vocab) for _ in range(ns.tail_tokens)]
        prompt = (sysp + tail) if shared else \
            [rng.randrange(1, vocab)
             for _ in range(ns.sys_tokens + ns.tail_tokens)]
        slo = "interactive" if rng.random() < ns.interactive_frac \
            else "batch"
        # --churn: transition-heavy traffic — short,
        # STAGGERED budgets so a slot finishes (and an admit lands)
        # every few ticks per replica. Deterministic in i so the
        # chaos/fleet replay gates can rebuild the exact request.
        mn = 2 + (i % 6) if getattr(ns, "churn", False) else ns.max_new
        return {"prompt": prompt, "max_new_tokens": mn,
                "temperature": 0.0, "slo": slo,
                "tenant": f"t{i % ns.tenants}", "stream": True,
                "timeout_s": ns.timeout_s}, shared

    # warmup (compiles the prefill/decode executables untimed); a
    # failed warmup against a restarting --url gateway must not kill
    # the run the per-request guard below protects
    for wh, wp in targets:
        try:
            await sse_generate(wh, wp, _payload(0)[0])
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass

    records = []

    async def _one(i):
        payload, shared = _payload(i)
        rid = f"lg{ns.seed}-{i:05d}"     # client-minted trace id
        # client-side round-robin over the fleet front doors
        # (several --url targets, or the one frontend)
        th, tp = targets[i % len(targets)]
        try:
            if len(fes) > 1:
                # HA client: round-robin over the sibling
                # frontends, resuming a severed stream on the next
                # one with the committed prefix
                rec = await sse_generate_ha(
                    targets, i % len(targets), payload,
                    request_id=rid,
                    resumes=max(2, len(targets)))
            else:
                rec = await sse_generate(th, tp, payload,
                                         request_id=rid)
        except (ConnectionError, OSError, asyncio.TimeoutError) as e:
            # one dropped connection (external gateway restarting,
            # request timeout) must not discard the whole run's rung
            rec = {"status": 0, "tokens": [], "ttft_ms": None,
                   "tpot_ms": None, "finish_reason": "conn_error",
                   "retry_after": None, "request_id": rid,
                   "error": repr(e)[:80]}
        rec["shared"] = shared
        rec["tenant"] = payload["tenant"]
        rec["slo"] = payload["slo"]
        if chaos or fleet:
            rec["prompt"] = payload["prompt"]   # for the reference replay
            rec["max_new"] = payload["max_new_tokens"]
        records.append(rec)

    def _fire_chaos(i):
        kind, target = chaos_plan[i]
        workers = gw._workers
        w = workers[target % len(workers)]
        if w.failed or w.abandoned or not w.is_alive():
            w = next((x for x in workers
                      if x.is_alive() and not x.failed
                      and not x.abandoned), w)
        w.inject_fault(kind)
        chaos_events.append({"at_request": i, "kind": kind,
                             "replica": w.replica.name})

    def _fire_fleet_kill(i):
        names = sorted(manager.procs)
        if not names:
            return
        name = manager.kill(names[krng.randrange(len(names))])
        fleet_kill_events.append({"at_request": i, "peer": name})

    def _fire_frontend_kill(i):
        live = [j for j in range(len(fes)) if j not in fe_dead]
        if len(live) < 2:
            return               # never kill the last survivor
        victim = live[krng.randrange(len(live))]
        fe_dead.add(victim)
        fes[victim].kill()
        fe_kill_events.append({"at_request": i,
                               "frontend": fes[victim].name})
        print(f"# frontend kill: {fes[victim].name} at request {i}",
              file=sys.stderr)

    t0 = time.perf_counter()
    tasks = []
    for i in range(ns.requests):
        tasks.append(asyncio.ensure_future(_one(i)))
        if i in chaos_plan:
            _fire_chaos(i)
        if i in fleet_kill_plan:
            _fire_fleet_kill(i)
        if i in fe_kill_plan:
            _fire_frontend_kill(i)
        if i < ns.requests - 1:
            # open-loop Poisson arrivals: exponential gaps at the
            # offered rate, slept regardless of completions. --diurnal
            # modulates the instantaneous rate along the seeded
            # sinusoid (the autoscaler's evaluation trace).
            rate_i = ns.rate
            if getattr(ns, "diurnal", False):
                rate_i = diurnal_rate(
                    i, ns.requests, ns.rate,
                    amp=getattr(ns, "diurnal_amp", 0.8),
                    cycles=getattr(ns, "diurnal_cycles", 1.0),
                    phase=phase)
            await asyncio.sleep(rng.expovariate(rate_i))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0

    ok = [r for r in records if r["finish_reason"] == "stop"]
    shed = sum(r["status"] == 429 for r in records)
    timeouts = sum(r["finish_reason"] == "timeout" for r in records)
    ttfts = sorted(r["ttft_ms"] for r in ok if r["ttft_ms"] is not None)
    tpots = sorted(r["tpot_ms"] for r in ok if r["tpot_ms"] is not None)
    total_tokens = sum(len(r["tokens"]) for r in ok)
    good_tokens = sum(len(r["tokens"]) for r in ok
                      if r["ttft_ms"] is not None
                      and r["ttft_ms"] <= ns.ttft_slo_ms)
    rung = {
        "metric": "gateway_serving",
        "gateway_tokens_per_sec": round(total_tokens / wall, 1),
        "gateway_p50_ttft_ms": round(_pct(ttfts, 0.50), 2),
        "gateway_p99_ttft_ms": round(_pct(ttfts, 0.99), 2),
        "gateway_p50_tpot_ms": round(_pct(tpots, 0.50), 2),
        "gateway_p99_tpot_ms": round(_pct(tpots, 0.99), 2),
        "goodput_tokens_per_sec": round(good_tokens / wall, 1),
        "goodput_frac": round(good_tokens / max(total_tokens, 1), 3),
        "requests": ns.requests,
        "completed": len(ok),
        "shed": shed,
        "timeouts": timeouts,
        "conn_errors": sum(r["finish_reason"] == "conn_error"
                           for r in records),
        "wall_s": round(wall, 2),
        "rate_rps": ns.rate,
        "share_frac": ns.share_frac,
        "policy": ns.policy,
        "replicas": ns.replicas,
        "model": ns.model if not urls else "external",
        "ring": getattr(ns, "ring", "on"),
        "delta": getattr(ns, "delta", "on"),
        "patch_fuse": getattr(ns, "patch_fuse", "on"),
        "tick_profile": getattr(ns, "tick_profile", "off"),
        "churn": bool(getattr(ns, "churn", False)),
        "targets": len(targets),
        "diurnal": bool(getattr(ns, "diurnal", False)),
        "telemetry": getattr(ns, "telemetry", "on"),
        "slo_windows": getattr(ns, "slo_windows", 1.0),
    }
    # SLO health in the rung: fired alerts, peak
    # burn and the windowed tok/s trajectory, so trend lines
    # capture how the run served — not just its end-of-run throughput
    if gw is not None and gw.sampler is not None:
        # final sample pairs with the t0 baseline so even a run that
        # finished inside one sampler interval yields a >=1-point rate
        # series (deterministic under warm compile caches)
        gw.sampler.sample()
        traj = _tok_trajectory(gw.sampler)
        if traj is not None:
            rung["tok_s_trajectory"] = traj
    if gw is not None and gw._slo is not None:
        snap = gw._slo.snapshot()
        rung["alerts"] = list(gw._slo.alerts)
        rung["alerts_fired"] = snap["fires_total"]
        rung["peak_burn_rate"] = max(
            snap["peak_burn"].values(), default=0.0)
        rung["peak_burn_by_class"] = snap["peak_burn"]
    if engines is not None and getattr(ns, "ring", "on") == "on":
        rung["ring_drains"] = sum(e.ring_drains for e in engines)
        rung["ring_blocking_drains"] = sum(e.ring_blocking_drains
                                           for e in engines)
    if engines is not None:
        # how the run's slot churn was paid for — one-row
        # patches vs full-state rebuilds, and the H2D bytes either way
        rung["full_rebuilds"] = sum(e.full_rebuilds for e in engines)
        rung["delta_patches"] = sum(e.delta_patches for e in engines)
        rung["h2d_upload_bytes"] = sum(e.h2d_upload_bytes
                                       for e in engines)
        # the fleet-level one-dispatch-per-tick evidence —
        # staged rows carried the churn, dispatches/tick stays ~1 plus
        # the run's prefill share
        rung["patches_fused"] = sum(e.patches_fused for e in engines)
        rung["patch_queue_overflows"] = sum(
            e.patch_queue_overflows for e in engines)
        ticks = sum(e.stats["decode_steps"] for e in engines)
        rung["dispatches_per_tick"] = round(
            sum(e.dispatch_count for e in engines) / ticks, 3) \
            if ticks else 0.0
        rung["prefix_hit_tokens"] = sum(
            e.stats["prefix_hit_tokens"] for e in engines)
        # where the tick wall went — host (staging + patch
        # flush, h2d broken out as detail), dispatch (python call into
        # the jit program), device (block-until-ready at the readback
        # boundary) and drain (D2H copies). host is the residual of
        # the bracketed phases, so the shares sum to 1.0 of the
        # measured wall by construction — coverage pins that.
        if getattr(ns, "tick_profile", "off") == "on":
            totals = {}
            wall = 0.0
            ticks_p = 0
            for e in engines:
                pt = e.tick_phase_totals
                if pt is None:
                    continue
                for p, v in pt.items():
                    totals[p] = totals.get(p, 0.0) + v
                wall += e.tick_wall_ms_total
                ticks_p += e._prof.ticks
            phase_sum = sum(totals.values())
            rung["phase_breakdown"] = {
                "ticks": ticks_p,
                "wall_ms": round(wall, 3),
                "host_frac": round(
                    (totals.get("host", 0.0)
                     + totals.get("h2d", 0.0)) / wall, 4)
                if wall else 0.0,
                "h2d_frac": round(
                    totals.get("h2d", 0.0) / wall, 4) if wall else 0.0,
                "dispatch_frac": round(
                    totals.get("dispatch", 0.0) / wall, 4)
                if wall else 0.0,
                "device_frac": round(
                    totals.get("device", 0.0) / wall, 4)
                if wall else 0.0,
                "drain_frac": round(
                    totals.get("drain", 0.0) / wall, 4)
                if wall else 0.0,
                "coverage": round(phase_sum / wall, 4)
                if wall else 0.0,
            }
        router = gw.health()["router"]
        rung["prefix_route_hits"] = router["prefix_route_hits"]
        rung["prefix_route_misses"] = router["prefix_route_misses"]
        # KV spill tier A/B: re-prefill tokens saved + the
        # fraction of prefix-hit tokens the HOST tier supplied (0.0
        # with --spill off — the regression-gated number). Summed over
        # the LIVE workers, not the launch list: rebuilt engines are
        # where crash-recovery restores land
        rung["spill"] = getattr(ns, "spill", "off")
        rung["migrate"] = getattr(ns, "migrate", "off")
        engs = [w.engine for w in gw._workers] if gw is not None \
            else list(engines)
        restored = sum(e.stats.get("spill_restored_tokens", 0)
                       for e in engs)
        hit_all = sum(e.stats.get("prefix_hit_tokens", 0)
                      for e in engs)
        rung["kv_spill_restored_tokens"] = restored
        rung["kv_spill_hit_frac"] = round(
            restored / hit_all, 4) if hit_all else 0.0
        rung["kv_spill_restores"] = sum(
            e.stats.get("spill_restores", 0) for e in engs)
        rung["kv_spill_restore_failures"] = sum(
            e.stats.get("spill_restore_failures", 0) for e in engs)
        if gw is not None and gw._spill_arena is not None:
            rung["kv_spill_arena"] = gw._spill_arena.snapshot()
    # per-request JSONL: the CLIENT side of the
    # trace join — request id, tenant, SLO class, wire TTFT/TPOT and
    # outcome, one line per request, keyed by the X-Request-Id the
    # server rings recorded
    jsonl = getattr(ns, "jsonl", None)
    if jsonl:
        tmp = jsonl + ".tmp"
        with open(tmp, "w") as f:
            for r in sorted(records,
                            key=lambda r: r.get("request_id") or ""):
                f.write(json.dumps({
                    "request_id": r.get("request_id"),
                    "tenant": r.get("tenant"),
                    "slo": r.get("slo"),
                    "status": r.get("status"),
                    "outcome": r.get("finish_reason"),
                    "ttft_ms": r.get("ttft_ms"),
                    "tpot_ms": r.get("tpot_ms"),
                    "tokens": len(r.get("tokens", ())),
                    "shared": r.get("shared"),
                }) + "\n")
        os.replace(tmp, jsonl)
        rung["jsonl"] = jsonl
    if gw is not None:
        await gw.drain()
        # server-side trace rings, dumped AFTER drain (the tick
        # threads close every in-flight trace before exiting), where a
        # trace report joins them with the --jsonl client records
        trace_dir = getattr(ns, "trace_dir", None)
        if trace_dir:
            rung["trace_rings"] = gw.dump_traces(trace_dir)
    if chaos:
        rung["chaos"] = _verify_chaos(ns, gw, engine_factory, records,
                                      chaos_events)
        if gw is not None:
            from . import kvxfer as _kvx
            rung["kv_xfer"] = _kvx.counters_snapshot(gw.name)
    if getattr(ns, "migrate", "off") == "on" and gw is not None:
        # cross-replica KV transfer A/B: the dedicated
        # two-gateway drain-migration probe — the main run's final
        # drain has no in-flight work left to migrate, so the knob's
        # regression-gated numbers come from a mid-stream drain pair
        # (migrate vs re-prefill control) on the same workload
        probe = await _migrate_probe(ns)
        rung["migrate_probe"] = probe
        rung["kv_xfer_hit_frac"] = probe["kv_xfer_hit_frac"]
        rung["recompute_tokens_saved"] = \
            probe["recompute_tokens_saved"]
        rung["recompute_amplification"] = \
            probe["recompute_amplification"]
    if fe is not None:
        # fleet rung: fleet_tokens_per_sec is the headline;
        # goodput-per-replica divides the good
        # tokens by REPLICA-SECONDS (the autoscaler's chip-cost
        # denominator), so a fleet that scales down through the trough
        # scores higher than one that holds peak capacity all run
        hz = fe.healthz()
        rep_secs = (scaler.replica_seconds if scaler is not None
                    else fleet * wall)
        rung["metric"] = "fleet_serving"
        rung["fleet_tokens_per_sec"] = round(total_tokens / wall, 1)
        rung["fleet_replicas"] = fleet
        rung["fleet_peer_failovers"] = sum(
            f.healthz()["peer_failovers"] for f in fes) \
            if len(fes) > 1 else hz["peer_failovers"]
        rung["fleet_retry_budget_exhausted"] = \
            hz["retry_budget_exhausted"]
        if len(fes) > 1:
            # frontend HA accounting: the client-observed
            # failover story — severed streams must all be resumed
            # with the committed prefix intact
            resumed = [r for r in records if r.get("resumes", 0) > 0]
            rung["frontend_ha"] = {
                "frontends": len(fes),
                "frontend_kills": fe_kill_events,
                "resumed_streams": sum(
                    1 for r in resumed
                    if r["finish_reason"] == "stop"),
                "resumed_failed": sum(
                    1 for r in resumed
                    if r["finish_reason"] != "stop"),
                "resume_mismatches": sum(
                    1 for r in records if r.get("resume_mismatch")),
                "gossip": [ln.snapshot() for ln in fe_links],
            }
        rung["replica_seconds"] = round(rep_secs, 2)
        rung["mean_replicas"] = round(rep_secs / max(wall, 1e-9), 2)
        rung["goodput_per_replica"] = round(
            good_tokens / max(rep_secs, 1e-9), 2)
        rung["router"] = hz["router"]
        if fleet_kill_events:
            rung["fleet_kills"] = fleet_kill_events
        if scaler is not None:
            snap = scaler.snapshot()
            rung["autoscale"] = {
                "scale_ups": snap["scale_ups"],
                "scale_downs": snap["scale_downs"],
                "min_replicas": snap["min_replicas"],
                "max_replicas": snap["max_replicas"],
                "signal_mode": snap["signal_mode"],
                "signal_window_s": snap["signal_window_s"],
                "events": snap["events"],
            }
        trace_dir = getattr(ns, "trace_dir", None)
        if trace_dir:
            rung["trace_rings"] = fe.dump_traces(trace_dir)
        if local_sampler is not None:
            # fleet SLO health: the frontend-side tok/s
            # trajectory plus the peers' federated burn/alert state,
            # read off the SAME probe caches /metricsz serves
            local_sampler.stop()
            local_sampler.sample()   # final point (see gateway twin)
            traj = _tok_trajectory(local_sampler,
                                   base="fleet_proxied_tokens_total")
            if traj is not None:
                rung["tok_s_trajectory"] = traj
            recent = []
            peak = {}
            total_fires = 0
            for peer, cache in fe.metricsz()["replicas"].items():
                slo = (cache.get("doc") or {}).get("slo") or {}
                recent += [dict(a, peer=peer)
                           for a in slo.get("alerts", ())]
                # fires_total is the UNTRUNCATED count — the peers'
                # snapshot "alerts" field is only the recent tail, so
                # counting fires off it would undercount alert-heavy
                # runs (and disagree with single-gateway mode)
                total_fires += int(slo.get("fires_total", 0))
                for cls, v in (slo.get("peak_burn") or {}).items():
                    peak[cls] = max(peak.get(cls, 0.0), v)
            rung["alerts"] = recent
            rung["alerts_fired"] = total_fires
            rung["peak_burn_rate"] = max(peak.values(), default=0.0)
            rung["peak_burn_by_class"] = peak
        if ns.model == "stub":
            rung["fleet_gate"] = _verify_fleet(
                ns, hz, records, fleet_kill_events,
                frontend_kills=fe_kill_events)
        for ln in fe_links:
            ln.stop()
        for j, f in enumerate(fes if fes else [fe]):
            if j in fe_dead:
                continue          # a killed frontend has no streams
            await f.drain()
        manager.stop_all()
    return rung


def _verify_fleet(ns, fleet_health, records, kill_events,
                  frontend_kills=()):
    """The fleet acceptance gate: replay every COMPLETED
    greedy stream on a fresh single-engine reference (same stub
    geometry the replica processes run — ``replica_main.py`` is the
    single source of truth) and demand bitwise token equality: a
    cross-process failover that duplicated, dropped or rewrote a token
    shows up as a corrupted stream. Error counts must stay within the
    retry-budget bound (process kills <= budget ==> zero 5xx) and the
    completed fraction must clear ``--goodput-floor``.

    a stream that crossed a FRONTEND kill reaches here as
    its client-side merge (committed prefix + survivor's remainder) —
    the same bitwise replay proves the resume dropped and duplicated
    nothing; ``resume_mismatches`` (client merge vs the survivor's
    authoritative final list) must be zero too."""
    from ..generation.paged import PagedEngine
    from .fleet.replica_main import stub_engine_kw
    ref = PagedEngine(_stub_model(ns), **stub_engine_kw(_chunk(ns)))
    done = [r for r in records if r["finish_reason"] == "stop"]
    for r in done:
        ref.submit(r["request_id"], r["prompt"],
                   max_new_tokens=r.get("max_new", ns.max_new))
    expect = ref.run()
    corrupted = [r["request_id"] for r in done
                 if r["tokens"] != expect[r["request_id"]]]
    errors = sum(r["finish_reason"] in ("error", "conn_error")
                 for r in records) \
        + sum(r["status"] in (500, 503) for r in records)
    budget = getattr(ns, "failover_budget", 2)
    floor = float(getattr(ns, "goodput_floor", 0.95))
    error_bound = 0 if len(kill_events) <= budget else ns.requests
    completed_frac = len(done) / max(ns.requests, 1)
    mismatches = sum(1 for r in records if r.get("resume_mismatch"))
    resumed_ok = sum(1 for r in done if r.get("resumes", 0) > 0)
    gate = {
        "kills": len(kill_events),
        "frontend_kills": len(frontend_kills),
        "failover_budget": budget,
        "peer_failovers": int(fleet_health["peer_failovers"]),
        "replays_checked": len(done),
        "resumed_streams_checked": resumed_ok,
        "corrupted_streams": len(corrupted),
        "corrupted_ids": corrupted[:8],
        "resume_mismatches": mismatches,
        "errors_5xx": errors,
        "error_bound": error_bound,
        "completed_frac": round(completed_frac, 3),
        "goodput_floor": floor,
    }
    gate["ok"] = (not corrupted and not mismatches
                  and errors <= error_bound
                  and completed_frac >= floor)
    return gate


def _verify_chaos(ns, gw, engine_factory, records, chaos_events):
    """The --chaos acceptance gate: replay every COMPLETED
    greedy stream on a fresh reference engine and demand bitwise
    equality — a failover that duplicated, dropped or rewrote a token
    shows up as a corrupted stream; assert the error count stays
    within the retry-budget bound (kills <= budget ==> every stream
    survives, so zero 5xx) and the completed fraction clears the
    goodput floor. ``ok`` False flips the CLI's exit code."""
    ref = engine_factory()
    done = [r for r in records if r["finish_reason"] == "stop"]
    for r in done:
        ref.submit(r["request_id"], r["prompt"],
                   max_new_tokens=r.get("max_new", ns.max_new))
    expect = ref.run()
    corrupted = [r["request_id"] for r in done
                 if r["tokens"] != expect[r["request_id"]]]
    errors = sum(r["finish_reason"] == "error" for r in records) \
        + sum(r["status"] in (500, 503) for r in records)
    h = gw.health()
    budget = getattr(ns, "failover_budget", 2)
    floor = float(getattr(ns, "goodput_floor", 0.95))
    # the documented amplification bound: a request rides at most one
    # failover per replica kill, so kills within the budget mean no
    # request can exhaust it — any 5xx is then a real defect
    error_bound = 0 if len(chaos_events) <= budget else ns.requests
    completed_frac = len(done) / max(ns.requests, 1)
    ch = {
        "events": chaos_events,
        "kills": len(chaos_events),
        "failover_budget": budget,
        "failovers": int(h["failovers"]),
        "retry_budget_exhausted": int(h["retry_budget_exhausted"]),
        "replays_checked": len(done),
        "corrupted_streams": len(corrupted),
        "corrupted_ids": corrupted[:8],
        "errors_5xx": errors,
        "error_bound": error_bound,
        "completed_frac": round(completed_frac, 3),
        "goodput_floor": floor,
    }
    ch["ok"] = (not corrupted and errors <= error_bound
                and completed_frac >= floor)
    return ch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the self-hosted engines' and replica "
                         "processes' device (default: the CUDA card; "
                         "'cpu' asks for the CPU)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="offered arrival rate, req/s (open loop)")
    ap.add_argument("--share-frac", type=float, default=0.5,
                    help="fraction of requests carrying the shared "
                         "system prompt")
    ap.add_argument("--sys-tokens", type=int, default=32)
    ap.add_argument("--tail-tokens", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--interactive-frac", type=float, default=0.7)
    ap.add_argument("--ttft-slo-ms", type=float, default=1000.0)
    ap.add_argument("--timeout-s", type=float, default=60.0)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--policy", default="prefix",
                    choices=("prefix", "least_loaded", "round_robin"))
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--model", default="tiny",
                    choices=("tiny", "stub", "llama3-8b", "llama3-70b",
                             "ernie-tiny", "ernie45-21b-a3b"),
                    help="llama3-8b / llama3-70b / ernie45-21b-a3b: "
                         "Llama-3-8B / 70B, ERNIE-4.5-21B-A3B at full "
                         "width with random weights, in the card's "
                         "serving geometry (70B needs --fleet K --tp N)")
    ap.add_argument("--tp", type=int, default=None,
                    help="--fleet: each replica a tensor-parallel one of "
                         "N rank processes on N cards of its own (with "
                         "--url the remote replicas' own: accepted, not "
                         "used)")
    ap.add_argument("--ep", type=int, default=None,
                    help="--fleet --tp N: split each replica's MoE "
                         "experts over E more ranks (N x E processes)")
    ap.add_argument("--ring", default="on", choices=("on", "off"),
                    help="async token-ring decode on the replica "
                         "engines (off = synchronous per-tick "
                         "readback, the A/B reference)")
    ap.add_argument("--delta", default="on", choices=("on", "off"),
                    help="delta slot transitions on the replica "
                         "engines (off = full mirror rebuild per "
                         "transition, the A/B reference)")
    ap.add_argument("--churn", action="store_true",
                    help="transition-heavy workload mix: "
                         "short staggered max-new budgets so slots "
                         "finish + readmit every few ticks; the rung "
                         "records full_rebuilds/delta_patches")
    ap.add_argument("--patch-fuse", dest="patch_fuse", default="on",
                    choices=("on", "off"),
                    help="fused patch+tick program: stage "
                         "transition descriptors into the device "
                         "queue the next tick applies in-program (off "
                         "= one standalone patch dispatch per "
                         "transition, the A/B reference); the "
                         "rung records patches_fused and "
                         "dispatches_per_tick")
    ap.add_argument("--tick-profile", dest="tick_profile",
                    default="off", choices=("on", "off"),
                    help="tick-phase profiler on the replica engines "
                         ": per-tick host/h2d/dispatch/"
                         "device/drain attribution; the rung banks "
                         "phase_breakdown (requires in-process "
                         "replicas)")
    ap.add_argument("--spill", default="off", choices=("on", "off"),
                    help="host-RAM KV spill tier: one "
                         "shared KVSpillArena across the replicas "
                         "(and every supervisor rebuild), so evicted "
                         "or crash-killed warm prefixes restore via "
                         "one H2D scatter instead of re-prefilling; "
                         "the rung banks kv_spill_hit_frac + "
                         "kv_spill_restored_tokens (off = the "
                         "bitwise A/B reference)")
    ap.add_argument("--spill-mb", type=int, default=256,
                    help="arena capacity in MiB under --spill on")
    ap.add_argument("--migrate", default="off", choices=("on", "off"),
                    help="cross-replica KV transfer: the "
                         "gateway cuts live requests over on drain "
                         "(terminal migrated events + resume_kv "
                         "spans; implies a spill arena) and the run "
                         "appends a two-gateway drain-migration A/B "
                         "probe — migrate vs re-prefill control — "
                         "banking kv_xfer_hit_frac, "
                         "recompute_tokens_saved and the "
                         "amplification ratio in the rung; under "
                         "--fleet the replica processes get "
                         "--spill-mb/--migrate so SIGTERM scale-downs "
                         "migrate instead of finishing in place")
    ap.add_argument("--migrate-requests", type=int, default=6,
                    help="in-flight streams the migrate probe drains "
                         "mid-run (per A/B side)")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded chaos harness: kill/hang "
                         "replicas mid-run, then assert zero "
                         "corrupted streams (bitwise replay against "
                         "a fresh reference engine), errors within "
                         "the retry-budget bound, and the goodput "
                         "floor; nonzero exit on violation")
    ap.add_argument("--chaos-kills", type=int, default=2,
                    help="replica faults to inject, spread evenly "
                         "over the request stream")
    ap.add_argument("--chaos-mode", default="mix",
                    choices=("kill", "hang", "mix"),
                    help="tick-thread crash, stuck dispatch, or "
                         "alternating")
    ap.add_argument("--failover-budget", type=int, default=2,
                    help="replica failures one request may ride "
                         "through before it errors (Gateway "
                         "failover_budget)")
    ap.add_argument("--watchdog-timeout-s", type=float, default=0.5,
                    help="dispatch-to-drain watchdog deadline under "
                         "--chaos")
    ap.add_argument("--goodput-floor", type=float, default=0.95,
                    help="minimum completed-request fraction the "
                         "chaos run must clear")
    ap.add_argument("--slo-windows", type=float, default=1.0,
                    help="scale the burn-rate alert windows: "
                         "1.0 = production-shaped (60s/300s "
                         "page pair), 0.01 lets a CI-length run fire "
                         "and resolve real alerts")
    ap.add_argument("--telemetry", default="on",
                    choices=("on", "off"),
                    help="time-series sampler + burn-rate alerting "
                         "on the gateways (off = the snapshot-only "
                         "stack, the bitwise A/B "
                         "reference)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--url", action="append", default=None,
                    help="attach to HOST:PORT instead of self-hosting "
                         "(repeatable: client-side round-robin over "
                         "several fleet front doors)")
    ap.add_argument("--diurnal", action="store_true",
                    help="modulate the offered rate along a seeded "
                         "sinusoid over the run (the autoscaler's "
                         "evaluation trace; see --diurnal-amp/-cycles)")
    ap.add_argument("--diurnal-amp", type=float, default=0.8,
                    help="sinusoid amplitude as a fraction of --rate")
    ap.add_argument("--diurnal-cycles", type=float, default=1.0,
                    help="full day-cycles compressed into the run")
    ap.add_argument("--fleet", type=int, default=0,
                    help="self-host N SEPARATE gateway processes "
                         "behind an in-process FleetFrontend "
                         "(remote-replica adapter routing)")
    ap.add_argument("--fleet-kill", type=int, default=0,
                    help="SIGKILL this many replica processes at "
                         "seeded mid-run points (fleet chaos: bitwise "
                         "replay gate + goodput floor apply)")
    ap.add_argument("--frontends", type=int, default=1,
                    help="run N sibling FleetFrontends over the same "
                         "replica fleet, gossip-linked (leaderless "
                         "frontend HA); clients round-robin "
                         "and resume severed streams on a sibling")
    ap.add_argument("--frontend-kill", type=int, default=0,
                    help="kill this many FRONTENDS at seeded mid-run "
                         "points (needs --frontends >= 2 and must "
                         "leave a survivor); the fleet gate then also "
                         "demands zero dropped/duplicated committed "
                         "tokens across the client-side resumes")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the closed-loop FleetAutoscaler over "
                         "the run (pair with --diurnal)")
    ap.add_argument("--autoscale-min", type=int, default=1)
    ap.add_argument("--autoscale-max", type=int, default=4)
    ap.add_argument("--autoscale-cooldown-s", type=float, default=3.0)
    ap.add_argument("--autoscale-mode", default="windowed",
                    choices=("windowed", "instant"),
                    help="decision signals: windowed means over "
                         "--autoscale-window-s (default) vs "
                         "the single-sample instant reference")
    ap.add_argument("--autoscale-window-s", type=float, default=1.0)
    ap.add_argument("--out", default="",
                    help="also write the rung to this JSON file "
                         "(default: none)")
    ap.add_argument("--jsonl", default="",
                    help="per-request JSONL for a trace report's "
                         "client-side join ('' disables)")
    ap.add_argument("--trace-dir", default="", dest="trace_dir",
                    help="dump the gateway's request-trace rings here "
                         "(self-hosted mode; '' disables)")
    ns = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(ns.device)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    started = time.strftime("%Y-%m-%d %H:%M:%S")
    rung = asyncio.run(run_loadgen(ns))
    print("LOADGEN_JSON " + json.dumps(rung))
    if ns.out:
        tmp = ns.out + ".tmp"
        section = "fleet" if ns.fleet else "gateway"
        with open(tmp, "w") as f:
            json.dump({"started": started, "device": device,
                       section: rung}, f, indent=1)
        os.replace(tmp, ns.out)
        print(f"wrote {ns.out}", file=sys.stderr)
    ch = rung.get("chaos")
    if ch is not None and not ch["ok"]:
        print("CHAOS FAILED: "
              f"corrupted={ch['corrupted_streams']} "
              f"errors_5xx={ch['errors_5xx']} (bound "
              f"{ch['error_bound']}) completed_frac="
              f"{ch['completed_frac']} (floor {ch['goodput_floor']})",
              file=sys.stderr)
        return 1
    mp = rung.get("migrate_probe")
    if mp is not None and not mp["ok"]:
        on, off = mp["modes"]["on"], mp["modes"]["off"]
        print("MIGRATE PROBE FAILED: "
              f"parity_ok={mp['parity_ok']} "
              f"corrupted on/off={on['corrupted_streams']}/"
              f"{off['corrupted_streams']} "
              f"errors on/off={on['errors']}/{off['errors']}",
              file=sys.stderr)
        return 1
    fg = rung.get("fleet_gate")
    if fg is not None and not fg["ok"]:
        print("FLEET GATE FAILED: "
              f"corrupted={fg['corrupted_streams']} "
              f"errors_5xx={fg['errors_5xx']} (bound "
              f"{fg['error_bound']}) completed_frac="
              f"{fg['completed_frac']} (floor {fg['goodput_floor']})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
