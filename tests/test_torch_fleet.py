"""The port's serving fleet (``paddle_tpu_torch/serving/fleet/``) on the
CPU, mirroring the default-tier cases of ``tests/test_fleet.py`` over the
port's stub gateways (the port's ``TickStubModel`` carrying the JAX
stub's weights), and held against the JAX package on the same inputs:

- ``prefix_digest_chain`` equals the JAX function's byte for byte on
  seeded ids and chunk sizes, and the port engine's own digests;
- a port ``FleetFrontend`` over two in-process port ``Gateway``s serving
  ``llama_tiny`` with the JAX model's weights: greedy streams, one of
  them across a mid-stream ``peer_conn_drop``, equal the JAX
  ``generate()`` tokens, logprobs within ``ATOL_LP`` of the JAX engine's;
- stub streams through the port fleet equal the JAX fleet's, in process
  (tokens bit for bit, logprobs within ``ATOL_LP``), with a peer drop on
  both sides;
- the JAX and the port ``FleetAutoscaler`` make the same decisions on
  one scripted signal trace, in ``"instant"`` and ``"windowed"`` modes;
- the port's load generator gives the JAX tool's ``LOADGEN_JSON`` keys
  and writes no file in the repository; two stub replica processes on
  the CPU, one SIGKILLed mid-run, replay bit for bit (the fast
  representative of the ``slow`` multi-process cases, which stay slow
  as in the JAX file);
- the cases that waited for the fleet: the fleet drain that migrates a
  stream (``test_kvxfer.py``), the loadgen JSONL joined with the server
  rings (``test_reqtrace.py``), the federated ``/profilez``
  (``test_tick_profile.py``), and the chaos loadgen runs of
  ``test_failover.py``, ``test_kvspill.py``, ``test_kvxfer.py`` and
  ``test_telemetry.py`` (slow there, slow here).
"""
import asyncio
import json
import os
import time
import types

import pytest

import numpy as np
import paddle_tpu as pt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.generation.stub import TickStubModel as JaxStub
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import Gateway as JaxGateway
from paddle_tpu.serving.fleet import FleetAutoscaler as JaxAutoscaler
from paddle_tpu.serving.fleet import FleetFrontend as JaxFrontend
from paddle_tpu.serving.fleet import RemoteReplica as JaxRemote
from paddle_tpu.serving.fleet import prefix_digest_chain as jax_chain
from paddle_tpu.utils import faults as jax_faults

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving import Gateway, PrefixAffinityRouter
from paddle_tpu_torch.serving import loadgen
from paddle_tpu_torch.serving.fleet import (FleetAutoscaler, FleetFrontend,
                                            RemoteReplica,
                                            prefix_digest_chain)
from paddle_tpu_torch.serving.supervisor import (BREAKER_CLOSED,
                                                 BREAKER_OPEN)
from paddle_tpu_torch.utils import faults

from test_torch_gateway import _engine
from test_torch_gateway_gpu import http as _http
from test_torch_gateway_gpu import poll as _poll
from test_torch_gateway_gpu import sse as _sse

PROMPT = list(range(1, 20))          # 2 full chunks + tail at chunk 8
# fp32 logprobs, port against the JAX package: the same math summed in
# another order by XLA and torch
ATOL_LP = 1e-4


def _load_loadgen():
    return loadgen


def _loadgen_ns(**kw):
    """The JAX tests' loadgen namespace, on the CPU."""
    base = dict(requests=6, rate=100.0, share_frac=0.5, sys_tokens=8,
                tail_tokens=4, max_new=6, interactive_frac=0.7,
                ttft_slo_ms=5000.0, timeout_s=60.0, tenants=2,
                replicas=1, policy="prefix", max_queue=256,
                model="stub", seed=0, url=None, out="", device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


async def _refresh(rep):
    """Synchronous probe off the event loop (the peers serve ON this
    loop; a blocking probe from a coroutine would deadlock them)."""
    return await asyncio.to_thread(rep.refresh)


async def _raw(port, payload, request_id=None):
    """One request, returning the COMPLETE raw response bytes — the
    byte-for-byte proxy-parity probe."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    rid = f"X-Request-Id: {request_id}\r\n" if request_id else ""
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"{rid}Content-Length: {len(body)}\r\n\r\n"
                      ).encode() + body)
        await writer.drain()
        return await asyncio.wait_for(reader.read(), 30)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


def _direct(prompt=PROMPT, max_new=12, **kw):
    eng = _engine()
    eng.submit("ref", [prompt], max_new_tokens=max_new, **kw)
    eng.run()
    return eng.results["ref"], eng.logprobs["ref"]


# ============================================================ digest chain
def test_prefix_digest_chain_matches_engine():
    """Fleet routing keys are the engine's cache keys, byte-for-byte —
    computed standalone (the frontend has no engine)."""
    eng = _engine()
    for prompt in (PROMPT, list(range(1, 9)), list(range(1, 45))):
        assert prefix_digest_chain(prompt, 8) \
            == eng.prefix_digests(prompt)
    # cap semantics: at least one live token must remain
    assert prefix_digest_chain(list(range(1, 9)), 8) == []
    assert prefix_digest_chain(PROMPT, 0) == []


# ================================================================== gossip
def test_debugz_prefix_digest_set_and_conditional_fetch():
    """/debugz/prefix: digest-set union + monotonic generation; the
    ``if_gen`` conditional answers the tiny unchanged-marker."""
    async def run():
        eng = _engine()
        gw = Gateway(eng, name="t-gossip")
        await gw.start()
        st, _, toks, fin = await _sse(gw.port,
                                      {"prompt": PROMPT,
                                       "max_new_tokens": 4,
                                       "temperature": 0.0})
        assert st == 200 and fin["finish_reason"] == "stop"
        st, _, doc = await _http(gw.port, "GET", "/debugz/prefix")
        doc = json.loads(doc)
        assert st == 200 and doc["generation"] > 0
        assert doc["entries"] == len(doc["digests"]) > 0
        assert set(doc["digests"]) \
            == {k.hex() for k in eng.prefix_cache}
        gen = doc["generation"]
        # unchanged: the conditional poll skips the digest list
        st, _, doc2 = await _http(gw.port, "GET",
                                  f"/debugz/prefix?if_gen={gen}")
        doc2 = json.loads(doc2)
        assert doc2 == {"generation": gen, "unchanged": True}
        # a different cacheable prompt moves the generation
        await _sse(gw.port, {"prompt": [7] * 30, "max_new_tokens": 4,
                             "temperature": 0.0})
        st, _, doc3 = await _http(gw.port, "GET",
                                  f"/debugz/prefix?if_gen={gen}")
        doc3 = json.loads(doc3)
        assert doc3.get("unchanged") is None
        assert doc3["generation"] > gen
        # the full /debugz carries the same summary
        st, _, dz = await _http(gw.port, "GET", "/debugz")
        assert json.loads(dz)["prefix_digest_set"]["generation"] \
            == doc3["generation"]
        # a supervisor rebuild through engine_factory swaps in a
        # FRESH engine (counter restarts at 0): the gateway's ratchet
        # must keep the exported generation strictly advancing — a
        # regressed-then-recovered sum must never replay an old value
        gw._workers[0].engine.prefix_generation = 0
        st, _, doc4 = await _http(
            gw.port, "GET",
            f"/debugz/prefix?if_gen={doc3['generation']}")
        doc4 = json.loads(doc4)
        assert doc4.get("unchanged") is None
        assert doc4["generation"] > doc3["generation"]
        await gw.drain()
    asyncio.run(run())


def test_remote_replica_probe_gossip_and_warm_routing():
    """The remote seam end-to-end: probes fill the cached snapshot,
    gossip fills the digest set, and the UNMODIFIED router ladder
    places a request on the warm PEER."""
    async def run():
        gws = [Gateway(_engine(), name=f"t-rr{i}") for i in range(2)]
        for gw in gws:
            await gw.start()
        reps = [RemoteReplica(f"p{i}", "127.0.0.1", gw.port)
                for i, gw in enumerate(gws)]
        for r in reps:
            assert await _refresh(r)
            assert r.healthy() and r.load() == 0.0
        # warm ONLY peer 1, then re-gossip
        await _sse(gws[1].port, {"prompt": PROMPT, "max_new_tokens": 4,
                                 "temperature": 0.0})
        for r in reps:
            assert await _refresh(r)
        digest = _engine().prefix_digest(PROMPT)
        assert not reps[0].has_prefix(digest)
        assert reps[1].has_prefix(digest)
        # conditional-fetch accounting: second unchanged poll skipped
        n_unchanged = reps[1].gossip_unchanged_total
        assert await _refresh(reps[1])
        assert reps[1].gossip_unchanged_total == n_unchanged + 1
        router = PrefixAffinityRouter(reps)
        meta = {}
        pick = router.route(
            _engine().prefix_digests(PROMPT)[::-1], meta=meta)
        assert pick is reps[1] and meta["verdict"] == "warm"
        for gw in gws:
            await gw.drain()
    asyncio.run(run())


def test_remote_replica_staleness_bound_and_flap_eviction():
    """A peer whose probes stop landing goes unhealthy two ways:
    consecutive failures flip the latch (opening the breaker), and a
    stale snapshot fails ``healthy()`` on its own."""
    async def run():
        gw = Gateway(_engine(), name="t-stale")
        await gw.start()
        t = [0.0]
        rep = RemoteReplica("p0", "127.0.0.1", gw.port,
                            stale_after_s=2.0, clock=lambda: t[0])
        assert await _refresh(rep)
        assert rep.healthy()
        t[0] = 3.0           # nobody probed for > stale_after_s
        assert not rep.healthy()
        assert rep.signals()["stale"]
        assert not rep.has_prefix("00")   # stale gossip: never warm
        t[0] = 0.0
        assert await _refresh(rep) and rep.healthy()
        await gw.drain()
        # flap: the listener is gone — consecutive failures evict and
        # open the attached breaker exactly once
        from paddle_tpu_torch.serving.supervisor import CircuitBreaker
        rep.breaker = CircuitBreaker(backoff_s=60.0)
        assert not await _refresh(rep)    # 1st failure: still latched
        assert rep._healthy
        assert not await _refresh(rep)    # 2nd: evicted
        assert not rep._healthy
        assert rep.breaker.state == BREAKER_OPEN
        assert rep.breaker.snapshot()["opens"] == 1
        assert not await _refresh(rep)    # more failures don't re-open
        assert rep.breaker.snapshot()["opens"] == 1
    asyncio.run(run())


# ========================================================== proxy parity
def test_fleet_proxy_stream_byte_parity_and_nonstream():
    """A proxied response is BYTE-identical to a direct one — SSE
    head, every token event (token + logprob), the final done event;
    and the non-stream JSON path too."""
    async def run():
        outs = []
        for mode in ("direct", "proxied"):
            gw = Gateway(_engine(), name=f"t-par-{mode}")
            await gw.start()
            port = gw.port
            fe = None
            if mode == "proxied":
                rep = RemoteReplica("p0", "127.0.0.1", gw.port,
                                    probe_interval_s=0.05)
                fe = FleetFrontend([rep], chunk_tokens=8,
                                   name=f"t-flt-{mode}")
                await fe.start()
                await _poll(rep.healthy, 5)
                port = fe.port
            sse = await _raw(port, {"prompt": PROMPT,
                                    "max_new_tokens": 8,
                                    "temperature": 0.0}, "par-1")
            nonstream = await _raw(port, {"prompt": PROMPT,
                                          "max_new_tokens": 8,
                                          "temperature": 0.0,
                                          "stream": False}, "par-2")
            outs.append((sse, nonstream))
            if fe is not None:
                await fe.drain()
            await gw.drain()
        assert outs[0][0] == outs[1][0]      # SSE bytes
        assert b'"lp":' in outs[0][0]        # logprobs ride the events
        assert outs[0][1] == outs[1][1]      # non-stream JSON bytes
    asyncio.run(run())


# ======================================================== remote failover
def test_fleet_midstream_peer_drop_resumes_bitwise():
    """The acceptance pin: a peer severed mid-stream fails over to a
    survivor through the HTTP resume seam — the client sees every
    token exactly once, tokens BITWISE the uninterrupted run, final
    logprobs float-epsilon equal, and the frontend retains the hop
    timeline."""
    ref_toks, ref_lps = _direct()
    async def run():
        gws = [Gateway(_engine(), name=f"t-ko{i}") for i in range(2)]
        for gw in gws:
            await gw.start()
        reps = [RemoteReplica(f"p{i}", "127.0.0.1", gw.port,
                              probe_interval_s=0.05)
                for i, gw in enumerate(gws)]
        fe = FleetFrontend(reps, chunk_tokens=8, name="t-ko",
                           breaker_backoff_s=60.0)
        await fe.start()
        await _poll(lambda: all(r.healthy() for r in reps), 5)
        with faults.scoped("peer_conn_drop@4"):
            st, _, toks, fin = await _sse(
                fe.port, {"prompt": PROMPT, "max_new_tokens": 12,
                          "temperature": 0.0})
        hz = fe.healthz()
        await fe.drain()
        for gw in gws:
            await gw.drain()
        return st, toks, fin, hz, fe
    st, toks, fin, hz, fe = asyncio.run(run())
    assert st == 200
    assert toks == ref_toks                  # no dup, no gap, bitwise
    assert fin["tokens"] == ref_toks
    assert fin["finish_reason"] == "stop"
    assert fin["logprobs"] == pytest.approx(ref_lps)
    assert hz["peer_failovers"] == 1
    assert hz["retry_budget_exhausted"] == 0
    # the dead peer is out, the survivor carried it
    assert sum(v["healthy"] for v in hz["peers"].values()) == 1
    # hop timeline retained on the frontend ring (always, even fast)
    entries = [e for e in fe.ring.snapshot()
               if e["outcome"] == "stop" and e["retained"]]
    assert len(entries) == 1
    kinds = [k for _, k, _ in entries[0]["events"]]
    assert "proxy_to" in kinds and "peer_fail" in kinds \
        and "resume_offset" in kinds
    off = next(f for _, k, f in entries[0]["events"]
               if k == "resume_offset")
    assert off["offset"] == 4                # seen 4, resumed after


def test_fleet_fully_committed_kill_never_errors():
    """A stream severed between its LAST token and the done event is
    complete in the client's hands: the frontend synthesizes the
    final event from the committed prefix BEFORE the budget check —
    even a zero budget never errors a complete result."""
    ref_toks, ref_lps = _direct(max_new=4)
    async def run():
        gws = [Gateway(_engine(), name=f"t-fc{i}") for i in range(2)]
        for gw in gws:
            await gw.start()
        reps = [RemoteReplica(f"p{i}", "127.0.0.1", gw.port,
                              probe_interval_s=0.05)
                for i, gw in enumerate(gws)]
        fe = FleetFrontend(reps, chunk_tokens=8, name="t-fc",
                           failover_budget=0, breaker_backoff_s=60.0)
        await fe.start()
        await _poll(lambda: all(r.healthy() for r in reps), 5)
        # occurrences 0-3 are the 4 token units; @4 severs the done
        with faults.scoped("peer_conn_drop@4"):
            st, _, toks, fin = await _sse(
                fe.port, {"prompt": PROMPT, "max_new_tokens": 4,
                          "temperature": 0.0})
        hz = fe.healthz()
        await fe.drain()
        for gw in gws:
            await gw.drain()
        return st, toks, fin, hz
    st, toks, fin, hz = asyncio.run(run())
    assert st == 200 and toks == ref_toks
    assert fin["finish_reason"] == "stop"
    assert fin["tokens"] == ref_toks
    assert fin["logprobs"] == pytest.approx(ref_lps)
    assert hz["retry_budget_exhausted"] == 0


def test_fleet_failover_budget_exhausted():
    """Every peer keeps dropping: after ``failover_budget`` hops the
    client gets a terminal SSE error event, counted."""
    async def run():
        gws = [Gateway(_engine(), name=f"t-bx{i}") for i in range(2)]
        for gw in gws:
            await gw.start()
        reps = [RemoteReplica(f"p{i}", "127.0.0.1", gw.port,
                              probe_interval_s=0.05)
                for i, gw in enumerate(gws)]
        fe = FleetFrontend(reps, chunk_tokens=8, name="t-bx",
                           failover_budget=1, breaker_backoff_s=60.0)
        await fe.start()
        await _poll(lambda: all(r.healthy() for r in reps), 5)
        with faults.scoped("peer_conn_drop"):     # every occurrence
            st, _, toks, fin = await _sse(
                fe.port, {"prompt": PROMPT, "max_new_tokens": 8,
                          "temperature": 0.0})
        hz = fe.healthz()
        await fe.drain()
        for gw in gws:
            await gw.drain()
        return st, toks, fin, hz
    st, toks, fin, hz = asyncio.run(run())
    assert st == 200 and toks == []          # head sent, then error
    assert fin["done"] and "budget exhausted" in fin["error"]
    assert hz["retry_budget_exhausted"] == 1
    assert hz["peer_failovers"] == 2         # initial + 1 retry


def test_peer_restart_rejoins_through_breaker_probe():
    """Process-restart rejoin: a peer whose port goes dead is evicted
    (breaker OPEN); a new gateway process on the SAME port does NOT
    rejoin by answering probes — the router hands it one probation
    probe, and only the proxied success closes the breaker."""
    async def run():
        gw_a = Gateway(_engine(), name="t-rj-a")
        await gw_a.start()
        port_a = gw_a.port
        gw_b = Gateway(_engine(), name="t-rj-b")
        await gw_b.start()
        reps = [RemoteReplica("pA", "127.0.0.1", port_a,
                              probe_interval_s=0.05,
                              fail_threshold=2),
                RemoteReplica("pB", "127.0.0.1", gw_b.port,
                              probe_interval_s=0.05)]
        fe = FleetFrontend(reps, chunk_tokens=8, name="t-rj",
                           breaker_backoff_s=0.15)
        await fe.start()
        await _poll(lambda: all(r.healthy() for r in reps), 5)
        # kill peer A's process (listener gone, probes fail)
        await gw_a.drain()
        await _poll(lambda: not reps[0].healthy(), 5)
        assert reps[0].breaker.state == BREAKER_OPEN
        payload = {"prompt": PROMPT, "max_new_tokens": 4,
                   "temperature": 0.0}
        st, _, toks, fin = await _sse(fe.port, payload)
        assert st == 200 and fin["finish_reason"] == "stop"
        assert not reps[0].healthy()     # still out: probes dead
        # "restart the process" on the same port
        gw_a2 = Gateway(_engine(), name="t-rj-a2", port=port_a)
        await gw_a2.start()
        await _poll(lambda: reps[0].probe_failures_total > 0
                    and reps[0]._fails == 0, 5)
        assert not reps[0].healthy()     # probes back != rejoined
        # after backoff the next request is peer A's probation probe
        await asyncio.sleep(0.2)
        ok = False
        for _ in range(6):
            st, _, toks, fin = await _sse(fe.port, payload)
            assert st == 200 and fin["finish_reason"] == "stop"
            if reps[0].breaker.state == BREAKER_CLOSED:
                ok = True
                break
            await asyncio.sleep(0.15)   # a doubled backoff may still
        assert ok and reps[0].healthy()  # be running; don't burn all
        # attempts inside one window
        await fe.drain()
        await gw_b.drain()
        await gw_a2.drain()
    asyncio.run(run())


# ============================================================= autoscaler
class _FakeManager:
    def __init__(self, n=1):
        self.reps = [_FakeSignals() for _ in range(n)]
        self._pending = 0
        self.ups = 0
        self.downs = 0

    def replicas(self):
        return list(self.reps)

    def pending(self):
        return self._pending

    def scale_up(self):
        self.ups += 1
        self.reps.append(_FakeSignals())

    def scale_down(self):
        self.downs += 1
        self.reps.pop()


class _FakeSignals:
    def __init__(self):
        self.queue_depth = 0
        self.free_slots = 4
        self.total_slots = 4
        self.up = True        # a SIGKILLed peer: unhealthy AND stale

    def signals(self):
        return {"healthy": self.up, "stale": not self.up,
                "load": self.total_slots - self.free_slots,
                "queue_depth": self.queue_depth,
                "free_slots": self.free_slots,
                "total_slots": self.total_slots,
                "block_pool_free_frac": 1.0, "goodput_frac": 1.0}


def test_autoscaler_hysteresis_cooldown_up_and_down():
    """Sustained pressure scales up ONCE per cooldown window; a
    one-poll blip scales nothing; sustained idleness scales down,
    never below min; flapping signals produce no flapping actions."""
    t = [0.0]
    m = _FakeManager(1)
    # signal_mode="instant": this test pins the hold/cooldown state
    # machine against single-sample transitions; the windowed default
    # smooths those (pinned against the JAX autoscaler below)
    sc = FleetAutoscaler(m, min_replicas=1, max_replicas=3,
                         up_queue_depth=2.0, hold_s=1.0,
                         hold_down_s=2.0, cooldown_s=5.0,
                         signal_mode="instant",
                         clock=lambda: t[0])
    # a blip: pressure seen once, gone before the hold elapses
    m.reps[0].queue_depth = 10
    assert sc.step()["action"] is None
    m.reps[0].queue_depth = 0
    t[0] = 2.0
    assert sc.step()["action"] is None and m.ups == 0
    # sustained pressure: up exactly once at hold_s
    m.reps[0].queue_depth = 10
    assert sc.step()["action"] is None        # hold starts
    t[0] = 2.5
    assert sc.step()["action"] is None
    t[0] = 3.1
    assert sc.step()["action"] == "up" and m.ups == 1
    assert len(m.reps) == 2
    # still under pressure, but the cooldown gates the second up
    t[0] = 4.0
    assert sc.step()["action"] is None        # hold restarts at 4.0
    t[0] = 8.2           # cooldown (5s) passed, hold long satisfied
    assert sc.step()["action"] == "up" and m.ups == 2
    assert len(m.reps) == 3
    t[0] = 14.3          # at max: pressure can't scale further
    assert sc.step()["action"] is None and m.ups == 2
    # idle: down after hold_down_s + cooldown, stopping at min
    for r in m.reps:
        r.queue_depth = 0
    t[0] = 15.0
    assert sc.step()["action"] is None        # down-hold starts
    t[0] = 17.1
    assert sc.step()["action"] == "down" and m.downs == 1
    t[0] = 22.2
    sc.step()
    t[0] = 24.3
    assert sc.step()["action"] == "down" and m.downs == 2
    assert len(m.reps) == 1
    t[0] = 40.0
    sc.step()
    t[0] = 43.0
    assert sc.step()["action"] is None        # never below min
    assert len(sc.events) == 4


def test_autoscaler_pending_spawns_and_replica_seconds():
    """A spawn in flight counts toward the target (no double-fire)
    and replica-seconds integrate live + pending replicas — the
    goodput-per-replica denominator."""
    t = [0.0]
    m = _FakeManager(1)
    m.reps[0].queue_depth = 10
    sc = FleetAutoscaler(m, max_replicas=5, up_queue_depth=2.0,
                         hold_s=0.5, cooldown_s=0.0,
                         clock=lambda: t[0])
    sc.step()
    m._pending = 3       # as if three spawns were already in flight
    t[0] = 1.0
    agg = sc.step()
    assert agg["action"] == "up" and m.ups == 1   # 1+3 < max of 5
    m._pending = 4
    t[0] = 2.0
    assert sc.step()["action"] is None    # 2 live + 4 pending >= max
    # replica-seconds integrate (live + pending) at step boundaries
    assert sc.replica_seconds == pytest.approx(
        (1.0 - 0.0) * (1 + 3) + (2.0 - 1.0) * (2 + 4), abs=1e-6)


def test_autoscaler_mass_outage_freeze_and_thaw():
    """A correlated outage takes most peers stale at once —
    the survivors' aggregate (stale peers excluded) reads idle, and
    the classic failure is scaling DOWN during the incident. The loop
    must FREEZE instead (no action either way, one freeze event),
    then thaw and resume normal decisions when peers return."""
    t = [0.0]
    m = _FakeManager(4)
    sc = FleetAutoscaler(m, min_replicas=1, max_replicas=8,
                         hold_s=0.5, hold_down_s=0.5, cooldown_s=0.0,
                         signal_mode="instant",
                         outage_freeze_frac=0.5,
                         clock=lambda: t[0])
    assert sc.step()["action"] is None
    # 3 of 4 peers go dark: live (1) <= replicas (4) * (1 - 0.5)
    for r in m.reps[1:]:
        r.up = False
    t[0] = 1.0
    agg = sc.step()
    assert agg["frozen"] and agg["action"] is None
    assert sc.events[-1]["action"] == "freeze"
    assert sc.events[-1]["stale"] == 3
    # idle survivors held across the whole incident: never a down
    for dt in (1.5, 2.0, 2.5, 3.0):
        t[0] = dt
        assert sc.step()["action"] is None
    assert m.downs == 0 and m.ups == 0
    # recovery thaws the loop; hold windows restart from the thaw
    for r in m.reps:
        r.up = True
    t[0] = 4.0
    agg = sc.step()
    assert not agg.get("frozen") and agg["action"] is None
    assert sc.events[-1]["action"] == "thaw"
    # post-thaw the normal idle scale-down path works again
    t[0] = 5.0
    assert sc.step()["action"] == "down" and m.downs == 1
    assert sc.snapshot()["freezes"] == 1


# ========================================================== tie rotation
def test_router_least_loaded_rotates_ties():
    """Probe-quantized load ties at fleet scale: first-minimum herds
    every miss onto the lowest-index replica. The router must rotate
    among tied minima (the 1000-replica sim measured ~6% of a light
    clean load shed off the herd target before this)."""
    class _R:
        def __init__(self, name):
            self.name = name

        def healthy(self):
            return True

        def has_prefix(self, d):
            return False

        def load(self):
            return 0.0

    reps = [_R(f"r{i}") for i in range(3)]
    router = PrefixAffinityRouter(reps)
    picks = [router.route() for _ in range(6)]
    assert set(p.name for p in picks) == {"r0", "r1", "r2"}
    # a strict minimum still wins outright
    reps[0].load = lambda: 1.0
    reps[1].load = lambda: 1.0
    assert all(router.route() is reps[2] for _ in range(3))


# ====================================================== burn bootstrap
def test_burn_engine_min_window_events_gates_bootstrap():
    """A burn ratio over single-digit samples is noise: with
    ``min_window_events`` set, a hot ratio in an almost-empty
    bootstrap window does NOT page; the same ratio over a populated
    window does. Resolves are never gated."""
    from paddle_tpu_torch.serving import BurnRateEngine
    eng = BurnRateEngine(window_scale=0.2, min_window_events=10,
                         labels={"fleet": "t-minwin"}, clock=lambda: 0)
    # 3 outcomes, all bad: burn is sky-high but the window is empty
    assert eng.observe_many("interactive",
                            [(1.0, False), (1.5, False),
                             (2.0, False)], now=2.0) == []
    assert eng.fires_total == 0
    # the ungated twin pages on exactly that noise
    loose = BurnRateEngine(window_scale=0.2, min_window_events=0,
                           labels={"fleet": "t-minwin0"},
                           clock=lambda: 0)
    evs = loose.observe_many("interactive",
                             [(1.0, False), (1.5, False),
                              (2.0, False)], now=2.0)
    assert any(e["kind"] == "fire" for e in evs)
    # populate past the floor: the gated engine now fires too
    outcomes = [(3.0 + 0.1 * i, False) for i in range(12)]
    evs = eng.observe_many("interactive", outcomes, now=4.2)
    assert any(e["kind"] == "fire" and e["rule"] == "page"
               for e in evs)


# ======================================================= frontend gossip
def test_frontend_gossip_link_merges_digests_and_sticky():
    """One FrontendLink round moves sibling state the right way:
    digest sets adopt only FORWARD by the peer's own generation,
    sticky entries fill only local gaps (resolved through the local
    adapter objects), and a partitioned round changes nothing."""
    from paddle_tpu_torch.serving.fleet import FrontendLink

    def make(name):
        fe = FleetFrontend([], chunk_tokens=None, name=name,
                           trace=False)
        rep = RemoteReplica("p0", "127.0.0.1", 1)
        fe.add_peer(rep)
        return fe, rep

    fe_a, rep_a = make("t-gsp-a")
    fe_b, rep_b = make("t-gsp-b")
    assert rep_b.adopt_digests(["d1", "d2"], 5)
    assert fe_b._router.merge_sticky({"d1": "p0"}, {"p0": rep_b}) == 1
    link = FrontendLink(fe_a, fe_b, seed=3)
    # partition first: the armed fault site severs the round cleanly
    with faults.scoped("gossip_partition"):
        assert not link.exchange()
    assert link.partitioned_total == 1
    assert rep_a.gossip_view()["generation"] == -1   # untouched
    # clean round: digests + sticky cross; generation follows the peer
    assert link.exchange()
    assert link.snapshot()["adopted_digest_sets"] == 1
    assert link.snapshot()["adopted_sticky"] == 1
    view = rep_a.gossip_view()
    assert view["digests"] == ["d1", "d2"] and view["generation"] == 5
    assert fe_a._router.export_sticky() == {"d1": "p0"}
    # idempotent: an unchanged sibling adopts nothing more
    assert link.exchange()
    assert link.snapshot()["adopted_digest_sets"] == 1
    assert link.snapshot()["adopted_sticky"] == 1
    # a STALER sibling view can never roll the local one back
    assert not rep_a.adopt_digests(["old"], 4)
    assert rep_a.gossip_view()["digests"] == ["d1", "d2"]


# ================================================================ diurnal
def test_diurnal_rate_trace_deterministic_and_bounded():
    slg = _load_loadgen()
    vals = [slg.diurnal_rate(i, 100, 10.0, amp=0.8, cycles=1.0,
                             phase=0.3) for i in range(100)]
    vals2 = [slg.diurnal_rate(i, 100, 10.0, amp=0.8, cycles=1.0,
                              phase=0.3) for i in range(100)]
    assert vals == vals2                     # deterministic
    assert max(vals) > 15.0 and min(vals) < 5.0   # actually diurnal
    assert all(v >= 0.5 for v in vals)       # floored at 5% of base
    # amplitude over 1 cannot push the rate negative
    assert all(slg.diurnal_rate(i, 50, 10.0, amp=2.0) > 0
               for i in range(50))


# ============================================================ fleet merge
def test_trace_report_fleet_merge_joins_hops_by_request_id():
    """Synthetic three-process view: the frontend ring + two peer
    rings share one failed-over request id; the merge names the chain
    in accept order and counts the peer failover."""
    import importlib.util
    import os
    from paddle_tpu_torch.serving.reqtrace import (RequestTrace,
                                                   RequestTraceRing)
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "tools", "trace_report.py")
    spec = importlib.util.spec_from_file_location("trace_report", path)
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)

    def ring(gateway, replica):
        return RequestTraceRing(
            capacity=16, labels={"gateway": gateway,
                                 "replica": replica})

    rings = {"fe": ring("flt", "frontend"),
             "a": ring("gwA", "r0"), "b": ring("gwB", "r0")}
    t_fe = RequestTrace("req-x")
    t_fe.ev("accept")
    t_fe.ev("proxy_to", replica="pA", attempt=0)
    t_fe.ev("peer_fail", replica="pA", reason="peer_conn_drop")
    t_fe.ev("resubmit", to_replica="", attempt=1)
    t_fe.ev("resume_offset", offset=3, committed=3)
    t_fe.ev("proxy_to", replica="pB", attempt=1)
    t_a = RequestTrace("req-x")
    t_a.ev("queue_enter", slo="interactive")
    t_b = RequestTrace("req-x")
    t_b.ev("queue_enter", slo="interactive")
    t_b.ev("finish", reason="stop")
    # order the accept walls: frontend first, then A, then B
    t_fe.wall0, t_a.wall0, t_b.wall0 = 100.0, 100.001, 100.05
    rings["fe"].finish(t_fe, "stop", tokens=9)
    rings["a"].finish(t_a, "error")
    rings["b"].finish(t_b, "stop", tokens=9)
    solo = RequestTrace("req-solo")
    solo.ev("queue_enter", slo="interactive")
    rings["a"].finish(solo, "stop")
    docs = [dict(r.to_doc(), _file=f"reqtrace_{k}.json")
            for k, r in rings.items()]
    s = tr.summarize(docs)
    fl = s["fleet"]
    assert fl["cross_process_requests"] == 1
    assert fl["with_peer_failover"] == 1
    chain = fl["chains"][0]
    assert chain["request_id"] == "req-x"
    assert chain["chain"] == ["flt/frontend", "gwA/r0", "gwB/r0"]
    assert chain["peer_failovers"] == 1
    assert chain["outcomes"]["gwA/r0"] == "error"
    # merged on one wall-clock axis: the frontend's hop events come
    # before the failed peer's retained timeline (peer B finished
    # clean and fast — retention correctly kept only its summary)
    kinds = [k for _, _, k, _f in chain["events"]]
    assert kinds.index("peer_fail") < kinds.index("queue_enter")
    assert "resubmit" in kinds
    text = tr.render(s)
    assert "flt/frontend -> gwA/r0 -> gwB/r0" in text
    # a single-process view stays in the classic shape
    assert "fleet" not in tr.summarize([docs[1]])


# ============================================================ membership
def test_router_add_remove_replica_drops_sticky():
    class _R:
        def __init__(self, name):
            self.name = name

        def healthy(self):
            return True

        def has_prefix(self, d):
            return False

        def load(self):
            return 0.0

    a, b = _R("a"), _R("b")
    router = PrefixAffinityRouter([a])
    assert router.route(["d1"]) is a          # miss remembered sticky
    router.add_replica(b)
    router.add_replica(b)                     # idempotent
    assert len(router.replicas) == 2
    router.remove_replica(a)
    assert router.replicas == [b]
    assert router.snapshot()["sticky_entries"] == 0
    assert router.route(["d1"]) is b


def test_frontend_healthz_debugz_metrics_endpoints():
    async def run():
        gw = Gateway(_engine(), name="t-fz")
        await gw.start()
        rep = RemoteReplica("p0", "127.0.0.1", gw.port,
                            probe_interval_s=0.05)
        fe = FleetFrontend([rep], chunk_tokens=8, name="t-fz-fe")
        await fe.start()
        await _poll(rep.healthy, 5)
        await _sse(fe.port, {"prompt": PROMPT, "max_new_tokens": 4,
                             "temperature": 0.0})
        st, _, hz = await _http(fe.port, "GET", "/healthz")
        hz = json.loads(hz)
        st2, _, dz = await _http(fe.port, "GET", "/debugz")
        dz = json.loads(dz)
        st3, _, mx = await _http(fe.port, "GET", "/metrics")
        await fe.drain()
        await gw.drain()
        return st, hz, st2, dz, st3, mx.decode()
    st, hz, st2, dz, st3, mx = asyncio.run(run())
    assert st == st2 == st3 == 200
    assert hz["requests"] == 1 and hz["proxied_tokens"] == 4
    assert hz["peers"]["p0"]["healthy"]
    assert hz["router"]["replicas_up"] == 1
    assert dz["autoscaler"] is None
    snap = dz["peers"]["p0"]
    assert snap["gossip"]["generation"] >= 0
    assert snap["probes"] > 0 and snap["breaker"]["state"] == "closed"
    assert dz["trace_ring"]["traced"] == 1
    # the scrape carries the fleet series (same registry objects)
    assert "fleet_requests_total" in mx
    assert "fleet_proxied_tokens_total" in mx


# ===================================================== multi-process e2e
@pytest.mark.slow
def test_fleet_multiproc_loadgen_kill():
    """The fleet acceptance harness, small: separate gateway
    PROCESSES behind the frontend, one SIGKILLed mid-run — zero
    corrupted greedy streams (bitwise replay), errors within the
    budget bound, goodput floor cleared."""
    slg = _load_loadgen()
    ns = _loadgen_ns(requests=16, rate=15.0, max_new=8, seed=7,
                     fleet=2, fleet_kill=1, failover_budget=2,
                     goodput_floor=0.95, autoscale=False, diurnal=False)
    rung = asyncio.run(slg.run_loadgen(ns))
    gate = rung["fleet_gate"]
    assert gate["ok"], gate
    assert gate["kills"] == 1 and gate["corrupted_streams"] == 0
    assert rung["completed"] == 16
    assert rung["fleet_tokens_per_sec"] > 0


@pytest.mark.slow
def test_fleet_multiproc_autoscale_diurnal():
    """The closed loop rides a compressed diurnal trace up AND back
    down, with goodput-per-replica in the rung."""
    slg = _load_loadgen()
    ns = _loadgen_ns(requests=150, rate=18.0, max_new=24, seed=5,
                     fleet=1, fleet_kill=0, autoscale=True,
                     autoscale_min=1, autoscale_max=3,
                     autoscale_cooldown_s=2.0, diurnal=True,
                     diurnal_amp=0.8, diurnal_cycles=1.0,
                     failover_budget=2, goodput_floor=0.9)
    rung = asyncio.run(slg.run_loadgen(ns))
    assert rung["fleet_gate"]["ok"], rung["fleet_gate"]
    auto = rung["autoscale"]
    assert auto["scale_ups"] >= 1, auto
    assert auto["scale_downs"] >= 1, auto
    assert rung["goodput_per_replica"] > 0
    assert rung["replica_seconds"] > 0
    assert rung["mean_replicas"] >= 1.0


@pytest.mark.slow
def test_fleet_multiproc_frontend_ha_kill():
    """The frontend-HA live acceptance, small: TWO gossip-linked
    frontends over one replica-process fleet, one frontend SIGKILLed
    mid-run — every in-flight client retries against the surviving
    sibling carrying its committed prefix (resume seam, one tier up),
    zero corrupted streams, zero client/server resume mismatches, all
    requests complete."""
    slg = _load_loadgen()
    ns = _loadgen_ns(requests=16, rate=15.0, max_new=8, seed=7,
                     fleet=2, frontends=2, frontend_kill=1,
                     fleet_kill=0, failover_budget=2,
                     goodput_floor=0.95, autoscale=False,
                     diurnal=False)
    rung = asyncio.run(slg.run_loadgen(ns))
    gate = rung["fleet_gate"]
    assert gate["ok"], gate
    assert gate["frontend_kills"] == 1
    assert gate["corrupted_streams"] == 0
    assert gate["resume_mismatches"] == 0
    assert rung["completed"] == 16
    ha = rung["frontend_ha"]
    assert ha["frontends"] == 2 and len(ha["frontend_kills"]) == 1
    assert ha["resumed_failed"] == 0
    # the mesh actually gossiped before (and after) the kill
    assert sum(g["rounds"] for g in ha["gossip"]) > 0


# ============================================ against the JAX package
@pytest.mark.parametrize("chunk", [1, 8, 16, 128])
def test_prefix_digest_chain_matches_jax_byte_for_byte(chunk):
    """The routing keys of one prompt are the JAX function's, whatever
    the id container: a list, int32 or int64 arrays."""
    rs = np.random.RandomState(chunk)
    for n in (0, 1, chunk, chunk + 1, 3 * chunk + 5, 700):
        ids = rs.randint(0, 128256, n).tolist()
        for cap in (None, n, n // 2):
            assert prefix_digest_chain(ids, chunk, cap) \
                == jax_chain(ids, chunk, cap)
    ids = rs.randint(0, 128256, 300)
    want = jax_chain(ids.tolist(), chunk)
    assert len(want) == 299 // chunk
    assert prefix_digest_chain(ids.astype(np.int32), chunk) == want
    assert prefix_digest_chain(ids.astype(np.int64), chunk) == want


@pytest.mark.parametrize("chunk", [8, 16])
def test_prefix_digest_chain_is_the_port_engines_cache_key(chunk):
    eng = _engine(chunk_prefill_tokens=chunk)
    rs = np.random.RandomState(chunk)
    for n in (chunk, chunk + 1, 63):
        ids = rs.randint(0, 128, n).tolist()
        assert prefix_digest_chain(ids, chunk) == eng.prefix_digests(ids)
    # what the engine files after a run, the chain names
    ids = list(range(1, 40))
    eng.submit("a", [ids], max_new_tokens=2)
    eng.run()
    for d in prefix_digest_chain(ids, chunk):
        assert bytes.fromhex(d) in eng.prefix_cache


LLAMA_GEO = dict(max_slots=2, num_blocks=32, block_size=8,
                 max_blocks_per_seq=8, prefill_buckets=(16,),
                 chunk_prefill_tokens=8, enable_prefix_cache=True)
LLAMA_REQS = [dict(prompt=list(range(1, 12)), max_new_tokens=8),
              dict(prompt=[7, 3, 9, 2, 5, 11, 4, 8, 1, 6, 2],
                   max_new_tokens=10),
              dict(prompt=list(range(30, 50)), max_new_tokens=6)]


async def _fleet_run(gateways, frontend, remote, reqs, drop_at, fault_mod,
                     tag):
    """Serve ``reqs`` one after another through a frontend over the
    given gateways (each a started-on-demand package Gateway); request
    ``drop_at`` runs with ``peer_conn_drop@4`` armed in ``fault_mod``.
    Returns the SSE results, the frontend's /healthz and its router."""
    for gw in gateways:
        await gw.start()
    reps = [remote(f"p{i}", "127.0.0.1", gw.port, probe_interval_s=0.05)
            for i, gw in enumerate(gateways)]
    fe = frontend(reps, chunk_tokens=8, name=f"{tag}-fe",
                  breaker_backoff_s=60.0)
    await fe.start()
    assert await _poll(lambda: all(r.healthy() for r in reps), 10)
    out = []
    try:
        for i, r in enumerate(reqs):
            spec = dict(r, temperature=0.0, request_id=f"{tag}-{i}")
            if i:
                # two whole probe rounds after the last request carry
                # its prefix digests and load to the frontend: both
                # packages then route on the same view (routing raced
                # the probes, and lost under load, before)
                seen = [r.probes_total for r in reps]
                assert await _poll(lambda: all(
                    r.probes_total >= n + 2
                    for r, n in zip(reps, seen)), 10)
            if i == drop_at:
                with fault_mod.scoped("peer_conn_drop@4"):
                    out.append(await _sse(fe.port, spec))
            else:
                out.append(await _sse(fe.port, spec))
        return out, fe.healthz()
    finally:
        await fe.drain()
        for gw in gateways:
            await gw.drain()


def test_llama_fleet_streams_match_jax_generate():
    """The port fleet over two in-process port gateways serving
    llama_tiny with the JAX model's weights: every greedy stream, the
    one that lost its peer mid-stream included, is the JAX
    ``generate()``'s tokens; logprobs within ATOL_LP of the JAX
    engine's."""
    import jax.numpy as jnp
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    out, hz = asyncio.run(_fleet_run(
        [Gateway([PagedEngine(tm, **LLAMA_GEO)], name=f"tf-llama{i}")
         for i in range(2)],
        FleetFrontend, RemoteReplica, LLAMA_REQS, 1, faults, "tf-llama"))
    assert hz["peer_failovers"] == 1
    je = JaxEngine(jm, **LLAMA_GEO)
    for i, r in enumerate(LLAMA_REQS):
        je.submit(i, np.asarray([r["prompt"]], np.int32),
                  max_new_tokens=r["max_new_tokens"])
    jres = je.run()
    for i, (r, (st, _, toks, fin)) in enumerate(zip(LLAMA_REQS, out)):
        n = len(r["prompt"])
        ref = np.asarray(jax_generate(
            jm, jnp.asarray([r["prompt"]]),
            JaxGenConfig(max_new_tokens=r["max_new_tokens"])))[0, n:]
        assert st == 200 and fin["finish_reason"] == "stop", i
        assert toks == fin["tokens"] == ref.tolist() \
            == list(jres[i]), i
        np.testing.assert_allclose(fin["logprobs"], je.logprobs[i],
                                   atol=ATOL_LP, rtol=0, err_msg=str(i))


def test_stub_fleet_streams_match_the_jax_fleet():
    """The same greedy requests, the third across a mid-stream peer
    drop, through the JAX fleet (JAX gateways and frontend) and the
    port's: the same tokens bit for bit, logprobs within ATOL_LP, the
    same failover count and the same routing decisions."""
    reqs = [dict(prompt=PROMPT, max_new_tokens=12),
            dict(prompt=PROMPT[:12] + [40, 41, 42], max_new_tokens=9),
            dict(prompt=list(range(50, 80)), max_new_tokens=14),
            dict(prompt=PROMPT + [5, 6], max_new_tokens=7)]

    def jax_engine():
        return JaxEngine(JaxStub(), max_slots=4, num_blocks=64,
                         block_size=8, max_blocks_per_seq=8,
                         prefill_buckets=(16,), chunk_prefill_tokens=8,
                         enable_prefix_cache=True)
    ref, jhz = asyncio.run(_fleet_run(
        [JaxGateway(jax_engine(), name=f"tf-jx{i}") for i in range(2)],
        JaxFrontend, JaxRemote, reqs, 2, jax_faults, "tf-jx"))
    got, hz = asyncio.run(_fleet_run(
        [Gateway(_engine(), name=f"tf-pt{i}") for i in range(2)],
        FleetFrontend, RemoteReplica, reqs, 2, faults, "tf-pt"))
    for i, ((st, _, toks, fin), (jst, _, jtoks, jfin)) in enumerate(
            zip(got, ref)):
        assert st == jst == 200, i
        assert toks == jtoks == fin["tokens"] == jfin["tokens"], i
        assert len(toks) == reqs[i]["max_new_tokens"]
        np.testing.assert_allclose(fin["logprobs"], jfin["logprobs"],
                                   atol=ATOL_LP, rtol=0, err_msg=str(i))
    assert hz["peer_failovers"] == jhz["peer_failovers"] == 1
    for k in ("prefix_route_hits", "prefix_route_misses"):
        assert hz["router"][k] == jhz["router"][k], k


def _drive_autoscaler(cls, mode):
    """One scripted signal trace (a ramp, a noisy plateau, idleness, a
    correlated outage) against a fake manager; the decisions and the
    event log."""
    t = [0.0]
    m = _FakeManager(2)
    sc = cls(m, min_replicas=1, max_replicas=5, up_queue_depth=2.0,
             hold_s=1.0, hold_down_s=2.0, cooldown_s=3.0,
             signal_mode=mode, signal_window_s=1.5,
             outage_freeze_frac=0.5, clock=lambda: t[0])
    rs = np.random.RandomState(11)
    actions = []
    for k in range(260):
        t[0] = 0.25 * k
        base = 6.0 if 40 <= k < 120 else (0.0 if k >= 150 else 1.0)
        for j, r in enumerate(m.reps):
            r.queue_depth = 0 if k >= 150 \
                else int(max(base + rs.randint(-3, 4), 0))
            r.free_slots = 4 if k >= 150 else int(rs.randint(0, 5))
            r.up = not (125 <= k < 140 and j > 0)
        actions.append(sc.step()["action"])
    return actions, sc.events, sc.replica_seconds


@pytest.mark.parametrize("mode", ["instant", "windowed"])
def test_autoscaler_decisions_match_jax(mode):
    got = _drive_autoscaler(FleetAutoscaler, mode)
    ref = _drive_autoscaler(JaxAutoscaler, mode)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    kinds = {e["action"] for e in got[1]}
    assert {"up", "down", "freeze"} <= kinds, kinds


# ======================================================= load generator
def _top_files():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {n for n in os.listdir(root)
            if os.path.isfile(os.path.join(root, n))}


LOADGEN_FLAGS = ["--model", "stub", "--device", "cpu", "--requests", "8",
                 "--sys-tokens", "8", "--tail-tokens", "4", "--max-new",
                 "6", "--rate", "100"]
# the keys the JAX tool's LOADGEN_JSON carries for LOADGEN_FLAGS with
# --fleet 2 --fleet-kill 1 (``tools/serve_loadgen.py``; the slow
# ``test_loadgen_fleet_keys_match_the_jax_tool_live`` re-derives them)
JAX_FLEET_KEYS = {
    "alerts", "alerts_fired", "churn", "completed", "conn_errors",
    "delta", "diurnal", "fleet_gate", "fleet_kills",
    "fleet_peer_failovers", "fleet_replicas",
    "fleet_retry_budget_exhausted", "fleet_tokens_per_sec",
    "gateway_p50_tpot_ms", "gateway_p50_ttft_ms", "gateway_p99_tpot_ms",
    "gateway_p99_ttft_ms", "gateway_tokens_per_sec", "goodput_frac",
    "goodput_per_replica", "goodput_tokens_per_sec", "mean_replicas",
    "metric", "model", "patch_fuse", "peak_burn_by_class",
    "peak_burn_rate", "policy", "rate_rps", "replica_seconds",
    "replicas", "requests", "ring", "router", "share_frac", "shed",
    "slo_windows", "targets", "telemetry", "tick_profile", "timeouts",
    "tok_s_trajectory", "wall_s"}


def _loadgen_json(capsys, argv):
    before = _top_files()
    assert loadgen.main(argv) == 0
    assert _top_files() == before            # nothing written
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("LOADGEN_JSON ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("LOADGEN_JSON "):])


def _jax_tool():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "serve_loadgen.py")
    spec = importlib.util.spec_from_file_location("serve_loadgen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loadgen_in_process_keys_match_the_jax_tool(capsys):
    from paddle_tpu.utils import observability as jax_obs

    from paddle_tpu_torch.utils import observability as obs
    # each registry afresh: the samplers track at most ``max_metrics``
    # series, and the gateways of earlier tests fill the process's
    # registry
    obs.reset()
    jax_obs.reset()
    rung = _loadgen_json(capsys, LOADGEN_FLAGS)
    assert rung["completed"] == 8 and rung["shed"] == 0
    ns = _loadgen_ns(requests=8, sys_tokens=8, tail_tokens=4, max_new=6,
                     rate=100.0, share_frac=0.5, interactive_frac=0.7,
                     ttft_slo_ms=1000.0, timeout_s=60.0, tenants=4)
    del ns.device
    ref = asyncio.run(_jax_tool().run_loadgen(ns))
    assert set(rung) == set(ref)


def test_loadgen_fleet_kill_replays_bitwise(capsys):
    """Two stub replica processes on the CPU behind the loadgen's
    frontend, one SIGKILLed mid-run: every completed greedy stream
    replays bit for bit on a reference engine, and the rung carries the
    JAX tool's keys."""
    rung = _loadgen_json(capsys, LOADGEN_FLAGS + ["--fleet", "2",
                                                  "--fleet-kill", "1"])
    gate = rung["fleet_gate"]
    assert gate["ok"], gate
    assert gate["kills"] == 1 and gate["corrupted_streams"] == 0
    assert gate["replays_checked"] == 8 and rung["completed"] == 8
    assert set(rung) == JAX_FLEET_KEYS


@pytest.mark.slow
def test_loadgen_fleet_keys_match_the_jax_tool_live():
    ns = _loadgen_ns(requests=8, sys_tokens=8, tail_tokens=4, max_new=6,
                     rate=100.0, ttft_slo_ms=1000.0, tenants=4, fleet=2,
                     fleet_kill=1, failover_budget=2, goodput_floor=0.95)
    rung = asyncio.run(loadgen.run_loadgen(ns))
    del ns.device
    ref = asyncio.run(_jax_tool().run_loadgen(ns))
    assert set(rung) == set(ref) == JAX_FLEET_KEYS


def test_replica_asked_for_the_card_without_one_never_gets_ready():
    """No fallback: a replica process asked for the card (the default)
    on a machine without one exits before its readiness line, and the
    manager raises."""
    import torch

    from paddle_tpu_torch.serving.fleet import LocalProcessManager
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    fe = FleetFrontend([], chunk_tokens=8, name="tf-nocard")
    mgr = LocalProcessManager(fe, model="stub", spawn_timeout_s=60)
    with pytest.raises(RuntimeError, match="never reported ready"):
        mgr.spawn()
    assert fe.peers == [] and mgr.procs == {}


# =========================================== cases that waited for the fleet
def test_fleet_drain_migrates_stream_without_failover():
    """(``test_kvxfer.py``) Mid-stream ``drain(migrate=True)`` on the
    origin: the frontend intercepts the terminal ``migrated`` event (no
    failover charged, no breaker), fetches the span over ``/kvz`` inside
    the drain grace, and resumes on the survivor via ``resume_kv`` — the
    client sees one uninterrupted greedy stream and the survivor's
    engine counts a spill restore, not a re-prefill."""
    from paddle_tpu_torch.serving import KVSpillArena, kvxfer
    prompt = list(range(1, 20))
    max_new = 24
    eng = _engine()
    eng.submit("ref", [prompt], max_new_tokens=max_new, temperature=0.0)
    eng.run()
    ref_toks = eng.results["ref"]
    ref_lps = eng.logprobs["ref"]

    async def run():
        gws = [Gateway(_engine(), name=f"tf-xmg{j}",
                       spill_arena=KVSpillArena(64 << 20,
                                                name=f"tf-xmg{j}"),
                       migrate_on_drain=True)
               for j in range(2)]
        for gw in gws:
            await gw.start()
        reps = [RemoteReplica(gw.name, "127.0.0.1", gw.port,
                              probe_interval_s=0.05) for gw in gws]
        fe = FleetFrontend(reps, chunk_tokens=8, name="tf-xmg-fe",
                           migrate=True, breaker_backoff_s=60.0)
        await fe.start()
        assert await _poll(lambda: all(r.healthy() for r in reps), 10)
        drain = {}

        async def on_first():
            target = next(g for g in gws
                          if any(w._live for w in g._workers))
            drain["gw"] = target
            drain["t"] = asyncio.ensure_future(
                target.drain(migrate=True))

        status, _hdr, toks, fin = await _sse(
            fe.port, {"prompt": prompt, "max_new_tokens": max_new,
                      "temperature": 0.0}, on_first=on_first)
        assert status == 200 and drain, "drain never triggered"
        await drain["t"]
        hz = fe.healthz()
        survivor = next(g for g in gws if g is not drain["gw"])
        restores = survivor._workers[0].engine.stats.get(
            "spill_restores", 0)
        xfer = kvxfer.counters_snapshot(drain["gw"].name)
        await fe.drain()
        for gw in gws:
            await gw.drain()
        return toks, fin, hz, restores, xfer

    toks, fin, hz, restores, xfer = asyncio.run(run())
    assert toks == ref_toks
    assert fin["finish_reason"] == "stop"
    assert fin["tokens"] == ref_toks
    assert np.allclose(fin["logprobs"], ref_lps, rtol=1e-5, atol=1e-6)
    assert hz.get("migrated_requests", 0) >= 1
    assert hz["peer_failovers"] == 0, "migration must not count failover"
    assert restores >= 1, "survivor re-prefilled instead of restoring"
    assert xfer["kv_xfer_spans_total"] >= 1
    assert xfer["kv_xfer_checksum_failures_total"] == 0


def test_loadgen_jsonl_joins_server_rings(tmp_path):
    """(``test_reqtrace.py``) client JSONL + the port gateway's rings,
    through the JAX package's trace report: every completed request
    matched and its TTFT decomposed."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "trace_report.py")
    spec = importlib.util.spec_from_file_location("trace_report", path)
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    jsonl = str(tmp_path / "lg.jsonl")
    rings = str(tmp_path / "rings")
    rung = asyncio.run(loadgen.run_loadgen(_loadgen_ns(
        requests=5, interactive_frac=0.6, jsonl=jsonl, trace_dir=rings)))
    assert rung["completed"] == 5 and rung["jsonl"] == jsonl
    recs = [json.loads(ln) for ln in open(jsonl)]
    assert len(recs) == 5
    assert all(r["request_id"].startswith("lg0-") for r in recs)
    assert sum(r["outcome"] == "stop" for r in recs) == 5
    docs = tr.load_rings([rings])
    assert docs, "loadgen wrote no trace rings"
    s = tr.summarize(docs, client=tr.load_client_jsonl(jsonl))
    assert s["client_join"]["matched"] == 5
    for cls in s["classes"].values():
        c = cls["components"]
        assert c["ttft_ms"]["n"] == cls["requests"]
        assert c["queue_wait_ms"]["n"] == cls["requests"]
        assert c["prefill_ms"]["n"] == cls["requests"]
        assert c["first_tick_ms"]["n"] == cls["requests"]


def test_frontend_federates_profilez_to_a_named_peer(tmp_path):
    """(``test_tick_profile.py``, the fleet half) the frontend's
    ``/profilez?replica=`` runs the capture on that peer and returns its
    report; an unknown peer is a 404."""
    from paddle_tpu_torch.utils import observability as obs
    obs.reset()
    obs.configure(str(tmp_path))

    async def run():
        gw = Gateway(_engine(tick_profile=True), name="tf-pz")
        await gw.start()
        rep = RemoteReplica("p0", "127.0.0.1", gw.port,
                            probe_interval_s=0.05)
        fe = FleetFrontend([rep], chunk_tokens=8, name="tf-pz-fe")
        await fe.start()
        assert await _poll(rep.healthy, 5)
        await _sse(fe.port, {"prompt": list(range(1, 10)),
                             "max_new_tokens": 6, "temperature": 0.0})
        fed = await _http(fe.port, "GET",
                          "/profilez?duration_s=0.1&replica=p0")
        miss = await _http(fe.port, "GET",
                           "/profilez?duration_s=0.1&replica=nope")
        await fe.drain()
        await gw.drain()
        return fed, miss

    try:
        fed, miss = asyncio.run(run())
    finally:
        obs.reset()
    st, _, fb = fed
    assert st == 200
    fdoc = json.loads(fb)
    assert fdoc["fleet"] == "tf-pz-fe" and fdoc["replica"] == "p0"
    assert fdoc["report"]["gateway"] == "tf-pz"
    assert fdoc["report"]["replicas"]["r0"]["enabled"]
    assert miss[0] == 404


def _chaos_ns(**kw):
    base = dict(requests=24, rate=60.0, share_frac=0.5, sys_tokens=8,
                tail_tokens=4, max_new=8, interactive_frac=0.7,
                ttft_slo_ms=5000.0, timeout_s=60.0, tenants=2,
                replicas=3, policy="prefix", max_queue=256,
                model="stub", seed=0, url=None, out="", device="cpu",
                chaos=True, chaos_kills=2, chaos_mode="mix",
                failover_budget=2, watchdog_timeout_s=0.5,
                goodput_floor=0.95)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _chaos_spill_ns(**kw):
    base = dict(requests=400, rate=50.0, share_frac=0.9, sys_tokens=16,
                tail_tokens=24, max_new=16, chaos_kills=3,
                chaos_mode="kill", failover_budget=3, spill="on",
                spill_mb=64)
    base.update(kw)
    return _chaos_ns(**base)


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_loadgen_zero_corruption():
    """(``test_failover.py``) a 3-replica gateway under open-loop load
    with 2 seeded mid-run replica kills (crash + hung dispatch): every
    finished greedy stream replays bitwise, zero 5xx within the budget,
    the goodput floor cleared — across seeds."""
    for seed in (0, 3):
        rung = asyncio.run(loadgen.run_loadgen(_chaos_ns(seed=seed)))
        ch = rung["chaos"]
        assert ch["kills"] == 2
        assert ch["corrupted_streams"] == 0, ch
        assert ch["errors_5xx"] == 0, ch
        assert ch["failovers"] >= 1
        assert ch["completed_frac"] >= 0.95
        assert ch["ok"], ch


@pytest.mark.slow
@pytest.mark.chaos
def test_spill_chaos_kill_replay_clean():
    """(``test_kvspill.py``) 3 replicas, 3 seeded mid-run crashes, the
    shared arena: spans spilled and restored, every completed greedy
    stream bitwise, no checksum failure."""
    rung = asyncio.run(loadgen.run_loadgen(_chaos_spill_ns()))
    ch = rung["chaos"]
    assert ch["corrupted_streams"] == 0, ch
    assert ch["errors_5xx"] == 0, ch
    assert ch["ok"], ch
    arena = rung["kv_spill_arena"]
    assert arena["spans"] > 0 and arena["checksum_failures"] == 0, arena
    assert rung["kv_spill_restores"] >= 1, rung
    assert rung["kv_spill_restored_tokens"] > 0, rung


@pytest.mark.slow
@pytest.mark.chaos
def test_migrate_chaos_kill_and_probe_replay_clean():
    """(``test_kvxfer.py``) the spill chaos run with ``--migrate on`` and
    its two-gateway drain-migration A/B probe: replay clean, the probe's
    modes bitwise in tokens, a real migration, and re-prefill burning at
    least 10x the prefill tokens migration does."""
    rung = asyncio.run(loadgen.run_loadgen(
        _chaos_spill_ns(migrate="on", migrate_requests=6)))
    ch = rung["chaos"]
    assert ch["corrupted_streams"] == 0 and ch["ok"], ch
    assert rung["kv_xfer"]["kv_xfer_checksum_failures_total"] == 0
    mp = rung["migrate_probe"]
    assert mp["ok"] and mp["parity_ok"], mp
    assert mp["lps_max_abs_diff"] < 1e-5, mp
    on, off = mp["modes"]["on"], mp["modes"]["off"]
    assert on["migrated"] >= 1, on
    assert on["restored_tokens"] > 0, on
    assert rung["recompute_amplification"] >= 10.0, rung


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_alert_loadgen_e2e():
    """(``test_telemetry.py``) a seeded chaos run whose replica hang
    spikes TTFT fires a burn-rate alert naming the interactive class, in
    the rung and in the flight recorder; the replay gate still passes;
    with the plane off the same run has no alert machinery."""
    from paddle_tpu_torch.utils import observability as obs
    kw = dict(requests=24, rate=40.0, replicas=3, max_new=6,
              chaos_mode="hang")
    obs.reset()
    rung = asyncio.run(loadgen.run_loadgen(_chaos_ns(slo_windows=0.02,
                                                     **kw)))
    assert rung["chaos"]["ok"], rung["chaos"]
    fired = [a for a in rung["alerts"] if a["kind"] == "fire"]
    assert fired and any(a["slo"] == "interactive" for a in fired)
    assert rung["peak_burn_rate"] > 1.0
    flight = [e for e in obs.recorder().snapshot()
              if e["kind"] == "alert_fire"]
    assert flight and flight[0]["slo"] == "interactive"
    obs.reset()
    off = asyncio.run(loadgen.run_loadgen(_chaos_ns(telemetry="off",
                                                    **kw)))
    assert off["chaos"]["ok"] and "alerts" not in off
    obs.reset()
