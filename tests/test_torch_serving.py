"""The port's copies of the serving and fault modules against the JAX
package's, on the CPU: one scripted scenario each runs through the JAX
module and through the port's, and their outputs must be equal (wall
clock stamps aside; every other clock is injected or pinned). This
guards the copies against drift.

- ``serving/scheduler.py``: SLO classes, priority, fair share, queue-age
  promotion, shedding on depth and engine backpressure, reaping;
- ``serving/router.py``: prefix affinity over digest chains, sticky
  misses, warm spill, health eviction, breaker probes, round robin;
- ``serving/slo.py``: burn rates, fire and resolve under an injected
  clock, the snapshot;
- ``serving/supervisor.py``: the circuit breaker's state machine and
  backoff;
- ``serving/reqtrace.py``: attribution, retention, phase shares, the ring
  documents (each package's validator accepts both);
- ``utils/faults.py``: spec parsing, occurrence addressing, seeded
  probabilistic fires, the backoff schedule; the port's registry is the
  JAX one's serving, spill and wire sites, each wired in the port;
- ``serving/kvxfer.py``: the wire bytes and every rung of the decode
  ladder, both directions;
- ``serving/kvspill.py``: one arena script.

And the kernel wrappers' launch counters, which the gateway's replica
threads update concurrently: exact under a stressed thread switch, with
one thread capturing into its own record meanwhile.
"""
import os
import time
import types

import numpy as np
import pytest

import paddle_tpu.serving.kvspill as jax_kvspill
import paddle_tpu.serving.kvxfer as jax_kvxfer
import paddle_tpu.serving.reqtrace as jax_reqtrace
import paddle_tpu.serving.router as jax_router
import paddle_tpu.serving.scheduler as jax_scheduler
import paddle_tpu.serving.slo as jax_slo
import paddle_tpu.serving.supervisor as jax_supervisor
import paddle_tpu.utils.faults as jax_faults
import paddle_tpu_torch.serving.kvspill as kvspill
import paddle_tpu_torch.serving.kvxfer as kvxfer
import paddle_tpu_torch.serving.reqtrace as reqtrace
import paddle_tpu_torch.serving.router as router
import paddle_tpu_torch.serving.scheduler as scheduler
import paddle_tpu_torch.serving.slo as slo
import paddle_tpu_torch.serving.supervisor as supervisor
import paddle_tpu_torch.utils.faults as faults

JAX = types.SimpleNamespace(
    kvspill=jax_kvspill, kvxfer=jax_kvxfer, reqtrace=jax_reqtrace,
    router=jax_router, scheduler=jax_scheduler, slo=jax_slo,
    supervisor=jax_supervisor, faults=jax_faults, tag="jax")
PORT = types.SimpleNamespace(
    kvspill=kvspill, kvxfer=kvxfer, reqtrace=reqtrace, router=router,
    scheduler=scheduler, slo=slo, supervisor=supervisor, faults=faults,
    tag="port")
WALL_KEYS = {"wall", "wall_accept", "dumped_wall", "wall0"}


def strip(obj):
    """``obj`` without its wall-clock stamps."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in WALL_KEYS}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


# ------------------------------------------------------------- scenarios
def scheduler_scenario(m):
    S, R = m.scheduler.SLOScheduler, m.scheduler.ServeRequest
    out = []

    def req(rid, slo="interactive", tenant="t", priority=0, deadline=None):
        return R(rid, [1, 2, 3], {"max_new_tokens": 4}, slo=slo,
                 tenant=tenant, priority=priority, deadline=deadline)

    s = S(max_queue=16, promote_after_ms=60_000,
          labels={"gateway": f"{m.tag}-slo"})
    for r in (req("b1", "batch", "A"), req("b2", "batch", "A"),
              req("b3", "batch", "B"), req("i1", "interactive", "A"),
              req("hi", "interactive", "A", priority=5)):
        s.enqueue(r)
    out.append([s.pop().request_id for _ in range(5)] + [s.pop()])
    s = S(max_queue=16, promote_after_ms=30.0, interactive_ttft_ms=500.0,
          labels={"gateway": f"{m.tag}-promote"})
    s.enqueue(req("old-batch", "batch"))
    later = time.monotonic() + 0.05
    s.enqueue(req("fresh", "interactive"))
    pick = s.pop(now=later)
    out.append((pick.request_id, pick.promoted,
                s.snapshot()["promotions"], s.pop(now=later).request_id))
    s = S(max_queue=1, labels={"gateway": f"{m.tag}-shed"})
    s.enqueue(req("a"))
    try:
        s.enqueue(req("b"))
        out.append("no shed")
    except m.scheduler.ShedError as e:
        out.append(("shed", e.retry_after_s > 0))
    s2 = S(max_queue=16, labels={"gateway": f"{m.tag}-shed2"})
    try:
        s2.enqueue(req("c"), engine_health={"queued": 8,
                                            "queue_capacity": 8})
        out.append("no shed")
    except m.scheduler.ShedError:
        out.append("shed on engine")
    s3 = S(max_queue=16, labels={"gateway": f"{m.tag}-exp"})
    s3.enqueue(req("dead", deadline=time.monotonic() - 0.1))
    s3.enqueue(req("live", deadline=time.monotonic() + 60.0))
    out.append([r.request_id for r in s3.reap()])
    out.append(s3.cancel("live"))
    out.append({k: v for k, v in s3.snapshot().items()
                if k != "queue_wait_ms"})
    return out


class _FakeReplica:
    def __init__(self, name, warm=(), load=0.0, healthy=True):
        self.name, self._warm = name, set(warm)
        self._load, self._healthy = load, healthy
        self.engine = None
        self.breaker = None

    def healthy(self):
        return self._healthy

    def mark(self, h):
        self._healthy = h

    def has_prefix(self, d):
        return d in self._warm

    def load(self):
        return self._load


def router_scenario(m):
    P = m.router.PrefixAffinityRouter
    out = []
    a = _FakeReplica("a", warm={"d1", "shared"}, load=1)
    b = _FakeReplica("b", warm={"longer", "shared"}, load=0)
    c = _FakeReplica("c", load=2)
    r = P([a, b, c], spill_margin=4, labels={"gateway": f"{m.tag}-r"})
    for digests in ("d1", None, "d2", ["uniq", "shared"],
                    ["longer", "shared"], ["x2", "x1"], ["y2", "x1"]):
        out.append(r.route(digests).name)
    a._load = 99
    out.append(r.route("d1").name)
    a.mark(False)
    out.append(r.route("d1").name)
    r.evict_unhealthy()
    out.append(r.snapshot())
    t = [0.0]
    a.mark(True)
    a.breaker = m.supervisor.CircuitBreaker(
        backoff_s=1.0, clock=lambda: t[0],
        on_state=lambda s: a.mark(s == m.supervisor.BREAKER_CLOSED))
    a._load = 0
    a.breaker.record_failure()
    out.append(r.route(None).name)
    t[0] = 1.5
    out.append([r.route(None).name, r.route(None).name,
                r.route(None, allow_probe=False).name])
    a.breaker.probe_done(True)
    out.append((r.route(None).name, r.snapshot()))
    rr = P([a, b], policy="round_robin", labels={"gateway": f"{m.tag}-rr"})
    out.append([rr.route("d").name for _ in range(4)])
    for rep in (a, b, c):
        rep.mark(False)
    try:
        r.route(None)
        out.append("routed")
    except m.router.NoReplicaError:
        out.append("no replica")
    return out


def slo_scenario(m):
    t = [0.0]
    eng = m.slo.BurnRateEngine(
        targets={"interactive": 0.9}, window_scale=0.01,
        labels={"gateway": f"{m.tag}-burn"}, clock=lambda: t[0])
    out = []
    for i in range(40):
        t[0] = i * 0.05
        out.append(eng.observe("interactive", ok=(i % 3 != 0)))
        out.append(eng.evaluate())
    for i in range(40, 200):
        t[0] = i * 0.05
        eng.observe("interactive", ok=True)
        out.append(eng.evaluate())
    out.append(eng.burn_rate("interactive", 0.6))
    out.append(eng.snapshot())
    return out


def breaker_scenario(m):
    t = [0.0]
    states = []
    b = m.supervisor.CircuitBreaker(
        probes_to_close=2, backoff_s=1.0, backoff_factor=2.0,
        on_state=states.append, clock=lambda: t[0])
    out = [b.state]
    b.record_failure()
    out += [b.state, b.try_probe()]
    t[0] = 1.1
    out += [b.try_probe(), b.state, b.try_probe()]
    b.probe_done(True)
    out += [b.state, b.try_probe()]
    b.probe_done(False)
    out.append(b.snapshot())
    t[0] = 2.5
    out.append(b.try_probe())
    t[0] = 3.2
    out.append(b.try_probe())
    b.probe_done(None)
    out += [b.state, b.try_probe()]
    b.probe_done(True)
    out.append(b.try_probe())
    b.probe_done(True)
    out += [b.snapshot(), states]
    b2 = m.supervisor.CircuitBreaker(backoff_s=0.1, clock=lambda: t[0])
    b2.record_failure()
    t[0] = 3.7
    b2.rearm()
    out.append(b2.try_probe())
    t[0] = 3.85
    out.append(b2.try_probe())
    return out


def reqtrace_scenario(m):
    ring = m.reqtrace.RequestTraceRing(
        capacity=3, slow_ttft_ms=50.0,
        labels={"gateway": f"{m.tag}-trace"})
    out = []
    for i, (ttft, outcome, failover) in enumerate(
            [(10.0, "stop", False), (80.0, "stop", False),
             (20.0, "timeout", False), (15.0, "stop", True)]):
        t = m.reqtrace.RequestTrace(f"r{i}", tenant="A")
        t.ev("queue_enter", t_ms=0.0, slo="interactive")
        t.ev("route", t_ms=0.5, replica="r0", verdict="warm")
        t.ev("slot_take", t_ms=2.0, slot=0)
        t.ev("prefill_done", t_ms=ttft - 1.0, tokens=9)
        t.ev("first_token", t_ms=ttft)
        if failover:
            t.ev("resubmit", t_ms=ttft + 1.0, target="r1")
        t.ev("tick", t_ms=ttft + 2.0, n=1, phase={
            "wall_ms": 4.0, "host_ms": 1.0, "h2d_ms": 0.0,
            "dispatch_ms": 2.0, "device_ms": 0.5, "drain_ms": 0.5})
        out.append(ring.finish(t, outcome, tokens=4, tpot_ms=1.5))
        out.append(ring.finish(t, outcome))         # idempotent
        out.append(m.reqtrace.attribution(t))
        out.append(m.reqtrace.decode_phase_share(t))
    doc = ring.to_doc()
    out.append(doc)
    out.append(ring.summary(recent=2))
    return out


def faults_scenario(m):
    sites = sorted(faults.SITES)
    out = []
    plan = m.faults.parse_spec(
        f"{sites[0]}@2,{sites[1]}@1-3,{sites[2]}x2,{sites[3]}~0.4,"
        f"{sites[4]}@5+", seed=11)
    for site in sites[:5]:
        out.append([plan.should_fire(site)[0] for _ in range(10)])
    try:
        m.faults.parse_spec("no_such_site")
        out.append("parsed")
    except ValueError:
        out.append("refused")
    delays = []
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 4:
            raise RuntimeError("transient")
        return calls[0]
    out.append(m.faults.retry_with_backoff(
        flaky, max_attempts=5, base_delay=0.05, seed=3,
        sleep=delays.append))
    out.append(delays)
    with m.faults.scoped(f"{sites[0]}@1"):
        out.append([m.faults.inject(sites[0]) for _ in range(3)])
    out.append(m.faults.inject(sites[0]))
    return out


XGEO = (2, 8, 1, 4, "float32", 16)


def kvxfer_scenario(m):
    rs = np.random.RandomState(4)
    payload = rs.standard_normal((4, 2, 8, 1, 4)).astype(
        np.float32).tobytes()
    digest = "ab" * 32
    out = []
    blob = m.kvxfer.encode_span(digest, 16, XGEO, payload,
                                gateway=f"{m.tag}-x")
    out.append(blob)
    out.append(m.kvxfer.decode_span(blob, XGEO, gateway=f"{m.tag}-x"))
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    for name, b, geo in (("checksum", bytes(bad), XGEO),
                         ("truncated", blob[:len(blob) // 2], XGEO),
                         ("geometry", blob, (3,) + XGEO[1:]),
                         ("magic", b"XXXX" + blob[4:], XGEO)):
        try:
            m.kvxfer.decode_span(b, geo, gateway=f"{m.tag}-x")
            out.append((name, "decoded"))
        except m.kvxfer.XferError as e:
            out.append((name, e.rung))
    arena = m.kvspill.KVSpillArena(1 << 20, name=f"{m.tag}-xa")
    out.append(m.kvxfer.inject_span(arena, blob, XGEO,
                                    gateway=f"{m.tag}-x"))
    out.append(m.kvxfer.export_span(arena, digest, XGEO,
                                    gateway=f"{m.tag}-x"))
    out.append(m.kvxfer.counters_snapshot(f"{m.tag}-x"))
    return out


def kvspill_scenario(m):
    arena = m.kvspill.KVSpillArena(4096, name=f"{m.tag}-arena")
    L, B, kvh, d = XGEO[:4]

    def pay(n, fill):
        return np.full((2 * L, n, B, kvh, d), fill, np.float32).tobytes()
    out = []
    out.append(arena.spill([(b"k4", (1, 2, 3, 4)), (b"k2", (1, 2))],
                           lambda e: pay(len(e), 1.0), XGEO, 7))
    out.append(arena.spill([(b"k8", tuple(range(8)))],
                           lambda e: pay(len(e), 2.0), XGEO))
    for i in range(3):
        out.append(arena.spill([(bytes([i]) * 2, (5, 6))],
                               lambda e: pay(2, float(i)), XGEO))
    out.append([arena.probe(k) for k in (b"k4", b"k2", b"\x00\x00",
                                         b"\x02\x02")])
    out.append(arena.take(b"\x02\x02", XGEO))
    out.append(arena.take(b"\x01\x01", (1,) + XGEO[1:]))
    out.append(arena.snapshot())
    return out


SCENARIOS = {"scheduler": scheduler_scenario, "router": router_scenario,
             "slo": slo_scenario, "breaker": breaker_scenario,
             "reqtrace": reqtrace_scenario, "faults": faults_scenario,
             "kvxfer": kvxfer_scenario, "kvspill": kvspill_scenario}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_module_matches_the_jax_module(name):
    fn = SCENARIOS[name]
    got, ref = fn(PORT), fn(JAX)

    def norm(x):
        # labels carry the package tag; everything else must agree
        s = repr(strip(x))
        return s.replace("port-", "TAG-").replace("jax-", "TAG-")
    assert norm(got) == norm(ref)


def test_ring_docs_validate_across_packages():
    port_doc = reqtrace_scenario(PORT)[-2]
    jax_doc = reqtrace_scenario(JAX)[-2]
    for doc in (port_doc, jax_doc):
        assert reqtrace.validate_ring_doc(doc) == []
        assert jax_reqtrace.validate_ring_doc(doc) == []


def test_port_sites_are_jax_sites_wired_in_the_port():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert set(faults.SITES) <= set(jax_faults.SITES)
    assert {"step_nan", "ckpt_corrupt", "worker_crash", "hang", "preempt",
            "prefetch_stall", "collective_fail",
            "tick_crash", "dispatch_hang", "replica_drop", "stream_stall",
            "slow_replica", "spill_corrupt", "spill_slow", "spill_drop",
            "xfer_corrupt", "xfer_trunc", "xfer_slow"} == set(faults.SITES)
    for site, (where, what) in faults.SITES.items():
        path = where.split(":")[0]
        assert path.startswith("paddle_tpu_torch/"), site
        src = open(os.path.join(root, path)).read()
        assert f'inject("{site}"' in src, (site, path)
        jwhere, _ = jax_faults.SITES[site]
        assert jwhere.split(":")[1] == where.split(":")[1], site
    assert faults.main(["--list"]) == 0


def test_launch_counts_exact_across_threads():
    """Replica threads count kernel launches concurrently and one of
    them may capture meanwhile: every uncaptured launch lands in the
    wrapper's counters exactly once, and a capturing thread's launches
    land only in its own record."""
    import sys
    import threading

    from paddle_tpu_torch.ops.kernels import (capturing_launches,
                                              count_launch)

    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.launches_by_route = {"mma": 0, "simt": 0}
    records = []

    def launch(n, capture):
        if capture:
            with capturing_launches() as rec:
                for _ in range(n):
                    count_launch(wrapper, "simt")
            records.append(rec)
        else:
            for _ in range(n):
                count_launch(wrapper, "mma")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(3000, i == 0))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert wrapper.launches == 7 * 3000
    assert wrapper.launches_by_route == {"mma": 7 * 3000, "simt": 0}
    assert records == [{wrapper: (3000, {"simt": 3000})}]


def test_card_lock_captures_alone():
    """The card lock under stressed thread switching: steps of several
    threads overlap (a step's nested share never waits), a capture
    (taken from inside a step, as ``_capture`` does) never overlaps
    another thread's running step (a step waiting to capture has
    launched nothing since it gave up its share), and every thread
    finishes."""
    import sys
    import threading
    import time

    from paddle_tpu_torch.device import CardLock

    lock = CardLock()
    state = {"in_step": 0, "waiting": 0, "capturing": 0, "overlapped": 0,
             "bad": 0}
    guard = threading.Lock()

    def worker(k):
        for i in range(300):
            with lock.shared(), lock.shared():
                with guard:
                    state["in_step"] += 1
                    if state["in_step"] > 1:
                        state["overlapped"] += 1
                # yield inside the step, so other threads' steps start
                # within it whatever the host's load
                time.sleep(0)
                if i % 50 == k:
                    with guard:
                        state["waiting"] += 1
                    with lock.exclusive():
                        with guard:
                            state["waiting"] -= 1
                            state["capturing"] += 1
                            # only this thread runs: other steps are out
                            # or waiting to capture
                            if state["capturing"] != 1 or \
                                    state["in_step"] - state["waiting"] != 1:
                                state["bad"] += 1
                        with guard:
                            state["capturing"] -= 1
                with guard:
                    state["in_step"] -= 1

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert state["bad"] == 0 and state["in_step"] == 0
    assert state["overlapped"] > 0           # steps did run together
