"""The port's serving gateway (``paddle_tpu_torch/serving/gateway.py``)
on the CPU, over the port's ``TickStubModel`` carrying the JAX stub's
weights (as numpy).

Mirrors the default-tier cases of ``tests/test_gateway.py``:

- the router key is the prefix-cache key, and the port's digests are
  the JAX package's for the same prompt;
- SSE streams equal the direct engine's bit for bit (greedy, seeded
  sampled, stop-trimmed), concurrently;
- a JSON completion, ``/healthz`` and ``/metrics`` pinned equal (they
  read the same registry objects);
- 429 with Retry-After when the queue sheds;
- a dropped SSE stream cancels its request and frees its slot; a
  half-closed client still gets its whole stream;
- SIGTERM drain (``GracefulShutdown``): in-flight finishes, new work gets
  503, metrics flush;
- prefix affinity beats round-robin on ``prefix_hit_tokens``;
- a request expiring in the queue gets 504 and never takes a slot.

And against the JAX gateway: the port gateway over the port's
llama_tiny and the JAX gateway over the JAX llama_tiny (the same
weights) serve the same greedy requests with identical tokens and
logprobs within 1e-4, and the port gateway's streams equal its direct
engine's bit for bit."""
import asyncio
import json
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import Gateway as JaxGateway
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.generation.stub import TickStubModel
from paddle_tpu_torch.serving import Gateway
from paddle_tpu_torch.utils import observability as obs
from paddle_tpu_torch.utils.shutdown import GracefulShutdown
from test_torch_gateway_gpu import http, poll, sse
from test_torch_tick_profile import jax_stub_weights

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
STUB_W = jax_stub_weights()


def _engine(**kw):
    base = dict(max_slots=4, num_blocks=64, block_size=8,
                max_blocks_per_seq=8, prefill_buckets=(16,),
                chunk_prefill_tokens=8, enable_prefix_cache=True)
    base.update(kw)
    return PagedEngine(TickStubModel(*STUB_W), **base)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_prefix_digest_matches_cache_key_and_jax():
    eng = _engine()
    prompt = list(range(1, 25))          # 24 tokens, chunk grid 8
    d = eng.prefix_digest(prompt)
    assert isinstance(d, str) and len(d) == 64
    assert bytes.fromhex(d) == eng._chunk_digests(prompt, 23)[-1]
    assert not eng.has_prefix(d)
    eng.submit("a", np.asarray([prompt], np.int32), max_new_tokens=2)
    eng.run()
    assert eng.has_prefix(d) and bytes.fromhex(d) in eng.prefix_cache
    assert _engine().prefix_digest(prompt[:16] + [99, 98, 97]) == d
    assert eng.prefix_digest([1, 2, 3]) == ""
    chain = eng.prefix_digests(prompt, max_tokens=len(prompt))
    assert len(chain) == 3 and chain[-1] != d
    for hx in chain:
        assert bytes.fromhex(hx) in eng.prefix_cache
    # the JAX engine files the same prompt under the same keys
    from paddle_tpu.generation.stub import TickStubModel as JaxStub
    je = JaxEngine(JaxStub(), max_slots=4, num_blocks=64, block_size=8,
                   max_blocks_per_seq=8, prefill_buckets=(16,),
                   chunk_prefill_tokens=8, enable_prefix_cache=True)
    assert je.prefix_digests(prompt, max_tokens=len(prompt)) == chain


def test_prefix_digest_requires_chunk():
    eng = PagedEngine(TickStubModel(*STUB_W), max_slots=2, num_blocks=16,
                      block_size=8, max_blocks_per_seq=4,
                      prefill_buckets=(16,))
    with pytest.raises(ValueError, match="chunk_prefill_tokens"):
        eng.prefix_digest(list(range(20)))


def _direct(reqs, **kw):
    eng = _engine(**kw)
    for i, r in enumerate(reqs):
        gen = {k: v for k, v in r.items()
               if k not in ("prompt", "stop", "stream")}
        if "stop" in r:
            gen["stop_sequences"] = r["stop"]
        eng.submit(i, np.asarray([r["prompt"]], np.int32), **gen)
    return eng.run(), eng


def test_gateway_sse_streams_match_direct_engine():
    reqs = [
        dict(prompt=list(range(1, 13)), max_new_tokens=8),
        dict(prompt=[5, 9, 2, 7, 7, 1, 3, 8, 4], max_new_tokens=10,
             temperature=0.9, top_k=20, seed=7),
        dict(prompt=list(range(40, 52)), max_new_tokens=12, stop=[[0]]),
        dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_new_tokens=5),
    ]

    async def gateway_run():
        gw = Gateway(_engine(), name="tt-parity")
        await gw.start()
        try:
            return await asyncio.gather(
                *[sse(gw.port, dict(r, stream=True)) for r in reqs])
        finally:
            await gw.drain()

    outs = asyncio.run(gateway_run())
    direct, eng = _direct(reqs)
    for i, (status, _, toks, fin) in enumerate(outs):
        assert status == 200 and fin["finish_reason"] == "stop"
        assert toks == direct[i] == fin["tokens"], i
        assert fin["logprobs"] == eng.logprobs[i]


def test_gateway_nonstream_healthz_metrics_pinned():
    async def run():
        gw = Gateway(_engine(), name="tt-pin")
        await gw.start()
        try:
            body = json.dumps(dict(prompt=list(range(1, 10)),
                                   max_new_tokens=6,
                                   stream=False)).encode()
            st, _, payload = await http(gw.port, "POST", "/v1/generate",
                                        body)
            st2, _, hz = await http(gw.port, "GET", "/healthz")
            st3, _, prom = await http(gw.port, "GET", "/metrics")
            st4, _, dbz = await http(gw.port, "GET", "/debugz")
        finally:
            await gw.drain()
        return (st, json.loads(payload), st2, json.loads(hz), st3,
                prom.decode(), st4, json.loads(dbz))

    st, resp, st2, health, st3, prom, st4, dbz = asyncio.run(run())
    assert st == st2 == st3 == st4 == 200
    assert len(resp["tokens"]) == 6 and resp["finish_reason"] == "stop"
    assert health["completed"] == 1 and health["tokens"] == 6
    line = next(ln for ln in prom.splitlines()
                if ln.startswith('gateway_tokens_total{')
                and 'gateway="tt-pin"' in ln)
    assert float(line.split()[-1]) == health["tokens"]
    assert health["replicas"]["r0"]["engine"]["prefills"] == 1
    assert "gateway_ttft_ms_bucket" in prom
    snap = dbz["replicas"]["r0"]["engine"]
    assert snap["spill"]["attached"] is False
    assert snap["block_pool"]["total"] == 63


def test_gateway_sheds_429_with_retry_after():
    async def run():
        gw = Gateway(_engine(), name="tt-429", max_queue=0)
        await gw.start()
        try:
            return await sse(gw.port, dict(prompt=list(range(1, 10)),
                                           max_new_tokens=4))
        finally:
            await gw.drain()

    status, headers, _, body = asyncio.run(run())
    assert status == 429
    assert int(headers["retry-after"]) >= 1
    assert body["retry_after_s"] > 0


def test_cancel_on_disconnect_frees_slot():
    async def run():
        eng = _engine(max_slots=2)
        gw = Gateway(eng, name="tt-disc")
        await gw.start()
        try:
            st, _, toks, _ = await sse(
                gw.port, dict(prompt=list(range(1, 10)),
                              max_new_tokens=50), break_after=2)
            assert st == 200 and len(toks) == 2
            freed = await poll(
                lambda: eng.health()["active_slots"] == 0
                and eng.stats["cancellations"] == 1)
            assert freed, "dropped stream stranded its slot"
            st2, _, toks2, fin2 = await sse(
                gw.port, dict(prompt=list(range(1, 10)),
                              max_new_tokens=4))
            assert st2 == 200 and fin2["finish_reason"] == "stop"
            assert len(toks2) == 4
            return gw.health()
        finally:
            await gw.drain()

    assert asyncio.run(run())["disconnects"] == 1


def test_half_close_client_still_gets_full_stream():
    async def run():
        eng = _engine()
        gw = Gateway(eng, name="tt-halfclose")
        await gw.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           gw.port)
            body = json.dumps(dict(prompt=list(range(1, 10)),
                                   max_new_tokens=6)).encode()
            writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n"
                          ).encode() + body)
            await writer.drain()
            writer.write_eof()
            status = int((await reader.readline()).split()[1])
            toks, fin = [], None
            while True:
                ln = (await reader.readline()).strip()
                if not ln.startswith(b"data: "):
                    continue
                ev = json.loads(ln[6:])
                if ev.get("done"):
                    fin = ev
                    break
                toks.append(ev["token"])
            writer.close()
            return status, toks, fin, gw.health(), eng.stats
        finally:
            await gw.drain()

    status, toks, fin, health, stats = asyncio.run(run())
    assert status == 200 and fin["finish_reason"] == "stop"
    assert len(toks) == 6 and toks == fin["tokens"]
    assert health["disconnects"] == 0 and stats["cancellations"] == 0


def test_sigterm_drain_finishes_inflight_rejects_new(tmp_path):
    obs.configure(str(tmp_path))

    async def run():
        gw = Gateway(_engine(), name="tt-drain",
                     shutdown=GracefulShutdown(signals=(signal.SIGTERM,)))
        await gw.start()
        runner = asyncio.ensure_future(gw.run_until_shutdown())
        rejected = {}

        async def fire_sigterm():
            os.kill(os.getpid(), signal.SIGTERM)
            st2, h2, _, _ = await sse(gw.port, dict(prompt=[1, 2, 3],
                                                    max_new_tokens=2))
            rejected.update(status=st2, headers=h2)

        st, _, toks, fin = await sse(
            gw.port, dict(prompt=list(range(1, 10)), max_new_tokens=40),
            on_first=fire_sigterm)
        assert st == 200 and fin["finish_reason"] == "stop"
        assert len(toks) == 40
        assert rejected["status"] == 503
        assert "retry-after" in rejected["headers"]
        await asyncio.wait_for(runner, timeout=30)
        return gw.health()

    try:
        health = asyncio.run(run())
    finally:
        obs.reset()
    assert health["draining"] and health["completed"] == 1
    assert os.path.exists(os.path.join(str(tmp_path), "metrics.prom"))


def test_drain_with_requests_in_flight():
    """``drain()`` called directly (the card smoke's drain): in-flight
    requests finish, a new one gets 503, no slot stays held."""
    async def run():
        eng = _engine()
        gw = Gateway(eng, name="tt-drain-direct")
        await gw.start()
        port = gw.port
        flights = [asyncio.ensure_future(sse(
            port, dict(prompt=list(range(1 + i, 12 + i)),
                       max_new_tokens=30))) for i in range(3)]
        await poll(lambda: eng.health()["active_slots"] == 3)
        drain = asyncio.ensure_future(gw.drain())
        await poll(lambda: gw.draining)
        late = await sse(port, dict(prompt=[1, 2, 3], max_new_tokens=2))
        outs = await asyncio.gather(*flights)
        await drain
        return outs, late, eng.health()

    outs, late, health = asyncio.run(run())
    assert all(st == 200 and fin["finish_reason"] == "stop"
               and len(toks) == 30 for st, _, toks, fin in outs)
    assert late[0] == 503
    assert health["active_slots"] == 0 and health["queued"] == 0


def test_prefix_affinity_raises_hit_tokens_vs_round_robin():
    sysp = list(range(1, 17))

    async def serve(policy):
        engines = [_engine(), _engine()]
        gw = Gateway(engines, name=f"tt-aff-{policy}", routing=policy)
        await gw.start()
        try:
            for i in range(8):
                st, _, _, fin = await sse(
                    gw.port, dict(prompt=sysp + [100 + i, 50 + i],
                                  max_new_tokens=2))
                assert st == 200 and fin["finish_reason"] == "stop"
        finally:
            await gw.drain()
        return (sum(e.stats["prefix_hit_tokens"] for e in engines),
                gw.health()["router"])

    hits_aff, router_aff = asyncio.run(serve("prefix"))
    hits_rr, _ = asyncio.run(serve("round_robin"))
    assert hits_aff == 7 * 16 and hits_rr == 6 * 16
    assert router_aff["prefix_route_hits"] == 7
    assert router_aff["prefix_route_misses"] == 1


def test_gateway_queue_timeout_never_takes_engine_slot():
    async def run():
        eng = _engine(max_slots=1)
        gw = Gateway(eng, name="tt-qto")
        await gw.start()
        try:
            long = asyncio.ensure_future(sse(
                gw.port, dict(prompt=list(range(1, 10)),
                              max_new_tokens=50)))
            await poll(lambda: eng.health()["active_slots"] == 1)
            body = json.dumps(dict(prompt=[4, 5, 6], max_new_tokens=4,
                                   timeout_s=0.05,
                                   stream=False)).encode()
            st, _, payload = await http(gw.port, "POST", "/v1/generate",
                                        body)
            st1, _, toks, _ = await long
            return st, json.loads(payload), st1, len(toks), gw.health()
        finally:
            await gw.drain()

    st, resp, st_long, n_long, health = asyncio.run(run())
    assert st == 504 and resp["finish_reason"] == "timeout"
    assert st_long == 200 and n_long == 50
    rep = health["replicas"]["r0"]
    assert rep["scheduler"]["timeouts"] == 1
    assert rep["engine"]["prefills"] == 1 and rep["engine"]["timeouts"] == 0


def test_profilez_traces_and_reports_phases(tmp_path):
    """``/profilez`` on ``torch.profiler``: with a run dir the capture
    traces (a non-empty Chrome trace file), reports each replica's phase
    totals in the window and dumps tick-phase files the validator
    accepts; a concurrent capture gets 409."""
    obs.reset()
    obs.configure(str(tmp_path))

    async def run():
        gw = Gateway(_engine(tick_profile=True), name="tt-pz")
        await gw.start()
        try:
            load = asyncio.ensure_future(sse(
                gw.port, dict(prompt=list(range(1, 10)),
                              max_new_tokens=40)))
            cap, c409 = await asyncio.gather(
                http(gw.port, "GET", "/profilez?duration_s=0.3"),
                http(gw.port, "GET", "/profilez?duration_s=0.3"))
            await load
            return cap, c409
        finally:
            await gw.drain()

    try:
        cap, c409 = asyncio.run(run())
    finally:
        obs.reset()
    assert sorted((cap[0], c409[0])) == [200, 409]
    body = json.loads(cap[2] if cap[0] == 200 else c409[2])
    assert body["traced"] and body["trace_error"] is None
    assert os.path.getsize(body["trace"]) > 0
    rep0 = body["replicas"]["r0"]
    assert rep0["enabled"]
    assert set(rep0["phase_ms_in_window"]) == set(obs.TICK_PHASES)
    assert body["tickphase_files"]
    for path in body["tickphase_files"]:
        with open(path) as f:
            assert obs.validate_tickphase_doc(json.load(f)) == []


# ------------------------------------------------- against the JAX gateway
LLAMA_GEO = dict(max_slots=2, num_blocks=32, block_size=8,
                 max_blocks_per_seq=8, prefill_buckets=(16,),
                 chunk_prefill_tokens=8, enable_prefix_cache=True)


def test_llama_gateway_against_the_jax_gateway():
    """Two replicas on ONE model (the tick_lock case) in each package,
    the same greedy requests: identical tokens, logprobs within
    ATOL_LP; the port's streams equal its direct engine's bit for
    bit."""
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    reqs = [dict(prompt=list(range(1, 12)), max_new_tokens=8),
            dict(prompt=[7, 3, 9, 2, 5], max_new_tokens=8),
            dict(prompt=list(range(30, 50)), max_new_tokens=6,
                 stop=[[5, 5]])]

    def serve(gw_cls, eng_cls, model, name):
        async def run():
            gw = gw_cls([eng_cls(model, **LLAMA_GEO) for _ in range(2)],
                        name=name)
            await gw.start()
            try:
                return await asyncio.gather(
                    *[sse(gw.port, dict(r, stream=True)) for r in reqs])
            finally:
                await gw.drain()
        return asyncio.run(run())

    ref = serve(JaxGateway, JaxEngine, jm, "tt-llama-jax")
    got = serve(Gateway, PagedEngine, tm, "tt-llama-port")
    direct = PagedEngine(tm, **LLAMA_GEO)
    for i, r in enumerate(reqs):
        gen = {k: v for k, v in r.items() if k not in ("prompt", "stop")}
        if "stop" in r:
            gen["stop_sequences"] = r["stop"]
        direct.submit(i, np.asarray([r["prompt"]], np.int32), **gen)
    res = direct.run()
    for i, ((st, _, toks, fin), (jst, _, jtoks, jfin)) in enumerate(
            zip(got, ref)):
        assert st == jst == 200
        assert toks == jtoks == fin["tokens"] == res[i], i
        np.testing.assert_allclose(fin["logprobs"], jfin["logprobs"],
                                   atol=ATOL_LP, rtol=0)
        assert fin["logprobs"] == direct.logprobs[i]
