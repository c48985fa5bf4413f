"""The port's serving gateway on the card. Every test here is marked
``gpu`` and skips, from its fixture, on a machine without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_gateway_gpu.py -m gpu --noconftest

- Two replicas on two distinct small bf16 Llamas (head_dim 128, so each
  tick runs the ragged kernel on its mma route) tick on their own
  threads: greedy requests start first, and the sampled ones arrive once
  a stream is running, so a sampled tick graph is captured on one thread
  while the other replica replays; every SSE stream equals, bit for bit,
  the stream a direct engine on the same model gives for the requests
  that replica served.
- A span restored from the host spill arena under a live tick graph is
  scattered into the pools in place: the pools keep their addresses, no
  graph is captured again, and the restored request's stream equals the
  warm one's.

The asyncio HTTP/SSE client helpers (``http``, ``sse``, ``poll``) live
here, with no JAX in them, so that the CPU gateway tests and
``chip_smoke.py`` share them."""
import asyncio
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving import Gateway, KVSpillArena

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             dtype=torch.bfloat16)
GEO = dict(max_slots=4, num_blocks=64, block_size=16, max_blocks_per_seq=8,
           prefill_buckets=(32, 64))


# ------------------------------------------------------------- HTTP client
async def http(port, method, path, body=b""):
    """One HTTP/1.1 request; returns (status, headers, payload)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            ln = await reader.readline()
            if ln in (b"\r\n", b"\n", b""):
                break
            k, _, v = ln.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        payload = await reader.readexactly(n) if n else b""
        return status, headers, payload
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


async def sse(port, payload, break_after=None, on_first=None):
    """SSE request; returns (status, headers, tokens, final_event).
    ``break_after=N``: abruptly close the connection after N tokens.
    ``on_first``: awaited callback after the first token arrives."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            ln = await reader.readline()
            if ln in (b"\r\n", b"\n", b""):
                break
            k, _, v = ln.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 200:
            n = int(headers.get("content-length", "0") or 0)
            extra = await reader.readexactly(n) if n else b""
            return status, headers, [], (json.loads(extra)
                                         if extra else None)
        toks, final = [], None
        while True:
            ln = await reader.readline()
            if not ln:
                break
            ln = ln.strip()
            if not ln.startswith(b"data: "):
                continue
            ev = json.loads(ln[6:])
            if ev.get("done"):
                final = ev
                break
            toks.append(ev["token"])
            if len(toks) == 1 and on_first is not None:
                await on_first()
            if break_after is not None and len(toks) >= break_after:
                break
        return status, headers, toks, final
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


async def poll(cond, timeout=10.0, every=0.01):
    """Wait until ``cond()`` is true; False on timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(every)
    return False


def served_by(gw):
    """{request_id: replica name} from the gateway's request-trace
    rings."""
    return {e["request_id"]: w.replica.name for w in gw._workers
            if w.ring is not None for e in w.ring.snapshot()}


# ------------------------------------------------------------------ tests
@pytest.fixture
def cuda_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    return torch.device("cuda")


def _model(dev, seed):
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**SMALL), device=dev,
                                generator=ptt.make_generator(seed, dev))


def _requests(seed=0, n=12):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        r = dict(prompt=[int(t) for t in rs.randint(1, 1000,
                                                   rs.randint(5, 60))],
                 max_new_tokens=int(rs.randint(8, 40)),
                 request_id=f"q{i}")
        if i % 3 == 2:
            r.update(temperature=0.8, top_p=0.9, seed=100 + i)
        out.append(r)
    return out


@pytest.mark.gpu
def test_distinct_models_capture_and_replay_concurrently(cuda_card):
    models = [_model(cuda_card, 0), _model(cuda_card, 1)]
    engines = [PagedEngine(m, **GEO) for m in models]
    reqs = _requests()

    greedy = [r for r in reqs if "temperature" not in r]
    sampled = [r for r in reqs if "temperature" in r]

    async def run():
        gw = Gateway(engines, name="gpu-two-models")
        await gw.start()
        try:
            running = asyncio.Event()

            async def first():
                running.set()
            early = [asyncio.ensure_future(sse(gw.port, r, on_first=first))
                     for r in greedy]
            await running.wait()
            late = [asyncio.ensure_future(sse(gw.port, r)) for r in sampled]
            outs = await asyncio.gather(*early, *late)
            return dict(zip([r["request_id"] for r in greedy + sampled],
                            outs)), served_by(gw)
        finally:
            await gw.drain()

    by_id, where = asyncio.run(run())
    outs = [by_id[r["request_id"]] for r in reqs]
    assert {where[r["request_id"]] for r in reqs} == {"r0", "r1"}
    # each replica captured its greedy graph, and a sampled graph was
    # captured after the streams had started
    for eng in engines:
        assert (True, 1, "ragged") in eng._graphs
    assert any((False, 1, "ragged") in eng._graphs for eng in engines)
    for rep, model in zip(("r0", "r1"), models):
        mine = [(r, o) for r, o in zip(reqs, outs)
                if where[r["request_id"]] == rep]
        direct = PagedEngine(model, **GEO)
        for r, _ in mine:
            kw = {k: v for k, v in r.items()
                  if k not in ("prompt", "request_id")}
            direct.submit(r["request_id"], np.asarray([r["prompt"]]), **kw)
        res = direct.run()
        for r, (st, _, toks, fin) in mine:
            rid = r["request_id"]
            assert st == 200 and fin["finish_reason"] == "stop", rid
            assert toks == res[rid] == fin["tokens"], rid
            assert fin["logprobs"] == direct.logprobs[rid], rid


@pytest.mark.gpu
def test_restore_writes_pools_in_place_without_recapture(cuda_card):
    model = _model(cuda_card, 0)
    geo = dict(GEO, num_blocks=16, chunk_prefill_tokens=32,
               enable_prefix_cache=True, prefill_buckets=(32,))
    arena = KVSpillArena(256 << 20, name="gpu-restore")
    eng = PagedEngine(model, **geo)
    eng.attach_spill(arena)
    rs = np.random.RandomState(3)
    first = np.asarray([rs.randint(1, 1000, 70)])
    eng.submit("a", first, max_new_tokens=8)
    warm = eng.run()["a"]
    warm_lps = list(eng.logprobs["a"])
    for i in range(6):                     # flood the 15-block pool
        eng.submit(f"f{i}", np.asarray([rs.randint(1, 1000, 70)]),
                   max_new_tokens=8)
    eng.run()
    digest = eng.prefix_digest(first)
    assert bytes.fromhex(digest) not in eng.prefix_cache
    assert eng.has_prefix(digest)          # the spilled tier advertises
    graphs = dict(eng._graphs)
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in eng.pools]
    eng.submit("a2", first, max_new_tokens=8)
    out = eng.run()
    assert eng.stats["spill_restores"] >= 1, eng.stats
    assert eng.stats["spill_restore_failures"] == 0
    assert [(k.data_ptr(), v.data_ptr()) for k, v in eng.pools] == ptrs
    assert eng._graphs.keys() == graphs.keys()
    assert all(eng._graphs[k] is g for k, g in graphs.items())
    assert out["a2"] == warm
    assert eng.logprobs["a2"] == warm_lps
