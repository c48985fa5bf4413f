"""The port's fault-tolerant serving on the CPU: replica supervision,
in-flight failover, circuit-breaker rejoin (mirrors the tier-1 cases of
``tests/test_failover.py``), on the port's stub carrying the JAX stub's
weights.

- the breaker's closed -> open -> half-open -> closed state machine with
  doubling backoff and at most one probe in flight; re-arming defers
  probation;
- the router's evict -> probe -> rejoin ladder;
- ``export_resumable`` refuses a resume that is not the prompt's tail;
  ``hard_reset`` leaves an engine that serves like a fresh one;
- a replica killed mid-stream (tick crash, silent drop, hung dispatch
  caught by the watchdog) hands its request to the survivor and the SSE
  stream's tokens stay bit for bit the uninterrupted one's (logprobs to
  a relative 1e-6: the survivor prefills what the dead replica had
  decoded);
- the crashed replica rejoins; ``failover_budget=0`` errors cleanly; a
  draining replica takes no failover; the failover's trace events are
  retained; ``/debugz`` shows breakers and the supervisor; an expired
  probe releases its breaker slot."""
import asyncio
import json
import time

import pytest

from paddle_tpu_torch.serving import (CircuitBreaker, Gateway,
                                      PrefixAffinityRouter, ServeRequest)
from paddle_tpu_torch.serving.supervisor import (BREAKER_CLOSED,
                                                 BREAKER_HALF_OPEN,
                                                 BREAKER_OPEN)
from test_torch_gateway import _engine
from test_torch_gateway_gpu import http, poll, sse

PROMPT = list(range(1, 13))


def _direct(prompt=PROMPT, max_new=24, **kw):
    eng = _engine()
    eng.submit("ref", [prompt], max_new_tokens=max_new, **kw)
    eng.run()
    return eng.results["ref"], eng.logprobs["ref"]


def test_breaker_state_machine():
    t = [0.0]
    states = []
    b = CircuitBreaker(probes_to_close=2, backoff_s=1.0,
                       backoff_factor=2.0, on_state=states.append,
                       clock=lambda: t[0])
    assert b.state == BREAKER_CLOSED
    b.record_failure()
    assert b.state == BREAKER_OPEN and not b.try_probe()
    t[0] = 1.1
    assert b.try_probe() and b.state == BREAKER_HALF_OPEN
    assert not b.try_probe()
    b.probe_done(True)
    assert b.state == BREAKER_HALF_OPEN and b.try_probe()
    b.probe_done(False)
    assert b.state == BREAKER_OPEN
    t[0] = 2.5
    assert not b.try_probe()
    t[0] = 3.2
    assert b.try_probe()
    b.probe_done(None)
    assert b.state == BREAKER_HALF_OPEN and b.try_probe()
    b.probe_done(True)
    assert b.try_probe()
    b.probe_done(True)
    assert b.state == BREAKER_CLOSED and b.snapshot()["opens"] == 0
    assert states == [BREAKER_OPEN, BREAKER_HALF_OPEN, BREAKER_OPEN,
                      BREAKER_HALF_OPEN, BREAKER_CLOSED]


def test_breaker_rearm_defers_probation():
    t = [0.0]
    b = CircuitBreaker(backoff_s=0.1, clock=lambda: t[0])
    b.record_failure()
    t[0] = 0.5
    b.rearm()
    assert not b.try_probe()
    t[0] = 0.65
    assert b.try_probe()


class _FakeReplica:
    def __init__(self, name, load=0.0):
        self.name, self._load, self._healthy = name, load, True
        self.breaker = None

    def healthy(self):
        return self._healthy

    def mark(self, h):
        self._healthy = h

    def has_prefix(self, d):
        return False

    def load(self):
        return self._load


def test_router_evict_probe_rejoin():
    t = [0.0]
    a, b = _FakeReplica("a"), _FakeReplica("b", load=5)
    a.breaker = CircuitBreaker(backoff_s=1.0, clock=lambda: t[0],
                               on_state=lambda s:
                               a.mark(s == BREAKER_CLOSED))
    r = PrefixAffinityRouter([a, b], labels={"gateway": "tt-rejoin"})
    assert r.route(None) is a
    a.breaker.record_failure()
    assert not a.healthy() and r.route(None) is b
    t[0] = 1.5
    assert r.route(None) is a
    assert r.route(None) is b
    assert r.route(None, allow_probe=False) is b
    a.breaker.probe_done(True)
    assert a.healthy() and r.route(None) is a
    assert r.snapshot()["breakers"] == {"a": BREAKER_CLOSED}


def test_export_resumable_rejects_non_tail_resume():
    with pytest.raises(ValueError, match="tail of input_ids"):
        _engine().submit("x", [PROMPT], max_new_tokens=4,
                         resume_tokens=[999])


def test_hard_reset_engine_reusable():
    eng = _engine()
    eng.submit("a", [PROMPT], max_new_tokens=6)
    ref = dict(eng.run())["a"]
    eng.submit("b", [list(range(20, 29))], max_new_tokens=50)
    for _ in range(4):
        eng.step()
    gen = eng.prefix_generation
    eng.hard_reset()
    h = eng.health()
    assert h["active_slots"] == 0 and h["queued"] == 0
    assert h["free_blocks"] == eng.P - 1
    assert eng.results == {} and not eng.prefix_cache
    assert eng.prefix_generation > gen       # the cache set changed
    eng.submit("c", [PROMPT], max_new_tokens=6)
    assert eng.run()["c"] == ref


def _warm_engine():
    e = _engine()
    e.submit("warmup", [list(range(1, 5))], max_new_tokens=4)
    e.run()
    e.results.pop("warmup", None)
    e.logprobs.pop("warmup", None)
    return e


def _fleet_gw(n=2, name="tt-fo", **kw):
    # a 2 s watchdog: far above a warmed stub step even on a CPU shared
    # with the rest of the suite, below the injected 4 s hang
    base = dict(watchdog_timeout_s=2.0, watchdog_interval_s=0.02,
                breaker_backoff_s=0.05, name=name)
    base.update(kw)
    return Gateway([_warm_engine() for _ in range(n)], **base)


async def _kill_serving(gw, kind):
    w = next(w for w in gw._workers if w._live)
    w.inject_fault(kind)
    return w.replica.name


@pytest.mark.parametrize("kind", ["crash", "drop", "hang"])
def test_failover_stream_bitwise_vs_uninterrupted(kind, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_DISPATCH_HANG_S", "4.0")
    killed = {}

    async def run():
        gw = _fleet_gw(name=f"tt-fo-{kind}")
        await gw.start()
        try:
            async def kill():
                killed["replica"] = await _kill_serving(gw, kind)

            st, _, toks, fin = await sse(
                gw.port, dict(prompt=PROMPT, max_new_tokens=24),
                on_first=kill)
        finally:
            await gw.drain()
        return st, toks, fin, gw.health(), gw.debugz()

    st, toks, fin, health, dbz = asyncio.run(run())
    direct, direct_lps = _direct()
    assert st == 200 and fin["finish_reason"] == "stop"
    assert toks == direct == fin["tokens"], kind
    # the survivor prefills prompt + committed, so the continuation's
    # logprobs come from a prefill, not a decode tick: the JAX test's
    # pytest.approx (relative 1e-6)
    assert fin["logprobs"] == pytest.approx(direct_lps)
    assert health["failovers"] >= 1
    assert health["retry_budget_exhausted"] == 0
    assert "replica" in killed
    if kind == "hang":
        assert dbz["supervisor"]["watchdog_fires"] >= 1


def test_breaker_rejoins_replica_after_crash():
    async def run():
        gw = _fleet_gw(name="tt-rejoin-e2e")
        await gw.start()
        try:
            st, _, _, fin = await sse(
                gw.port, dict(prompt=PROMPT, max_new_tokens=16),
                on_first=lambda: _kill_serving(gw, "crash"))
            assert st == 200 and fin["finish_reason"] == "stop"

            async def recovered():
                st2, _, _, fin2 = await sse(
                    gw.port, dict(prompt=PROMPT, max_new_tokens=2))
                if st2 != 200 or (fin2 or {}).get(
                        "finish_reason") != "stop":
                    return False
                snap = gw.health()["router"]
                return snap["replicas_up"] == 2 and all(
                    s == BREAKER_CLOSED
                    for s in snap.get("breakers", {}).values())

            ok = False
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not ok:
                ok = await recovered()
                await asyncio.sleep(0.05)
            return ok, gw.health()
        finally:
            await gw.drain()

    ok, health = asyncio.run(run())
    assert ok, "crashed replica never rejoined rotation"
    assert health["router"]["replicas_up"] == 2


def test_retry_budget_exhaustion_errors_cleanly():
    async def run():
        gw = _fleet_gw(name="tt-budget", failover_budget=0)
        await gw.start()
        try:
            st, _, _, fin = await sse(
                gw.port, dict(prompt=PROMPT, max_new_tokens=24),
                on_first=lambda: _kill_serving(gw, "crash"))
        finally:
            await gw.drain()
        return st, fin, gw.health()

    st, fin, health = asyncio.run(run())
    assert st == 200 and "budget" in fin.get("error", "")
    assert health["retry_budget_exhausted"] == 1
    assert health["failovers"] == 0


def test_draining_replica_never_accepts_failover():
    gw = Gateway([_engine(), _engine()], name="tt-drainfo")
    w1, w2 = gw._workers
    for w in (w1, w2):
        w.is_alive = lambda: True
    req = ServeRequest("r1", PROMPT, {"max_new_tokens": 4})
    req.owner = w1
    w2.draining = True
    gw._resubmit(req, None, w1)
    assert w2.sched.depth() == 0
    assert int(gw._c_failovers.value) == 0
    req2 = ServeRequest("r2", PROMPT, {"max_new_tokens": 4})
    req2.owner = w1
    w2.draining = False
    gw._resubmit(req2, None, w1)
    assert w2.sched.depth() == 1
    assert int(gw._c_failovers.value) == 1


def test_failover_trace_events_and_retention():
    async def run():
        gw = _fleet_gw(name="tt-fo-trace")
        await gw.start()
        try:
            st, _, _, fin = await sse(
                gw.port, dict(prompt=PROMPT, max_new_tokens=16,
                              request_id="fo-req"),
                on_first=lambda: _kill_serving(gw, "crash"))
            assert st == 200 and fin["finish_reason"] == "stop"
            await poll(lambda: any(
                e["request_id"] == "fo-req"
                for w in gw._workers if w.ring is not None
                for e in w.ring.snapshot()))
            return [e for w in gw._workers if w.ring is not None
                    for e in w.ring.snapshot()
                    if e["request_id"] == "fo-req"]
        finally:
            await gw.drain()

    entries = asyncio.run(run())
    assert len(entries) == 1
    e = entries[0]
    assert e["outcome"] == "stop" and e["failovers"] == 1
    assert e["retained"] and e["events"]
    kinds = [k for _, k, _ in e["events"]]
    for k in ("replica_fail", "breaker_open", "resubmit", "resume_offset"):
        assert k in kinds, f"missing {k} in {kinds}"
    ro = next(f for _, k, f in e["events"] if k == "resume_offset")
    assert ro["committed"] >= ro["offset"] >= 0


def test_debugz_exposes_breaker_and_supervisor():
    async def run():
        gw = _fleet_gw(name="tt-fo-dbz")
        await gw.start()
        try:
            st, _, _, fin = await sse(
                gw.port, dict(prompt=PROMPT, max_new_tokens=16),
                on_first=lambda: _kill_serving(gw, "crash"))
            assert st == 200 and fin["finish_reason"] == "stop"
            st2, _, payload = await http(gw.port, "GET", "/debugz")
            return st2, json.loads(payload)
        finally:
            await gw.drain()

    st, dbz = asyncio.run(run())
    assert st == 200
    assert dbz["failover_budget"] == 2 and dbz["failovers"] >= 1
    assert dbz["supervisor"]["alive"]
    states = {r["breaker"]["state"] for r in dbz["replicas"].values()
              if r["breaker"] is not None}
    assert states & {BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN}


def test_expired_probe_releases_breaker_slot():
    gw = Gateway([_engine()], name="tt-probeleak", supervise=True)
    w = gw._workers[0]
    b = CircuitBreaker(backoff_s=0.0)
    w.replica.breaker = b
    b.record_failure()
    assert b.try_probe()
    req = ServeRequest("p1", PROMPT, {"max_new_tokens": 2},
                       deadline=time.monotonic() - 1.0)
    req.probe = True
    w.sched.enqueue(req)
    w.flush_queue(503, "dead worker")
    assert not b.snapshot()["probe_inflight"]
    assert b.try_probe()
