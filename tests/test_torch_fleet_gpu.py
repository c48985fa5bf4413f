"""The port's serving fleet on the card. Every test here is marked ``gpu``
and skips, from its fixture, on a machine without a CUDA card. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_fleet_gpu.py -m gpu --noconftest

- Two ``replica_main --model tiny`` processes on the card (the tiny
  Llama drawn from seed 0 on the card) behind a ``FleetFrontend`` in this
  process: every greedy stream through the fleet equals, bit for bit
  (tokens and logprobs), a direct engine's on the same model built in
  this process from the same seed.
- The same fleet across a SIGKILL of the replica that serves a stream
  mid-flight: the stream finishes on the survivor with every token once.
"""
import asyncio

import pytest
import torch

from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving.fleet import FleetFrontend, LocalProcessManager
from paddle_tpu_torch.serving.fleet.replica_main import (build_model,
                                                         tiny_engine_kw)
from test_torch_gateway_gpu import sse

CHUNK = 16


@pytest.fixture
def cuda_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    return torch.device("cuda")


def _requests(n=8):
    return [dict(prompt=[(7 * i + 3 * k) % 250 + 1
                         for k in range(20 + 6 * i)],
                 max_new_tokens=12 + 2 * i, request_id=f"f{i}")
            for i in range(n)]


def _fleet(tmp_path):
    fe = FleetFrontend([], chunk_tokens=CHUNK, name="gpu-fleet")
    mgr = LocalProcessManager(fe, model="tiny", chunk_tokens=CHUNK,
                              spawn_timeout_s=300, probe_interval_s=0.1,
                              stale_after_s=5.0, log_dir=str(tmp_path))
    return fe, mgr


def _direct(dev, reqs):
    eng = PagedEngine(build_model("tiny", dev, 0), **tiny_engine_kw(CHUNK))
    for r in reqs:
        eng.submit(r["request_id"], r["prompt"],
                   max_new_tokens=r["max_new_tokens"])
    return eng.run(), eng.logprobs


@pytest.mark.gpu
def test_tiny_replicas_on_the_card_match_a_direct_engine(cuda_card,
                                                         tmp_path):
    reqs = _requests()
    fe, mgr = _fleet(tmp_path)
    try:
        for _ in range(2):
            mgr.spawn()

        async def run():
            await fe.start()
            try:
                return await asyncio.gather(
                    *[sse(fe.port, dict(r, stream=True)) for r in reqs])
            finally:
                await fe.drain()
        got = asyncio.run(run())
    finally:
        mgr.stop_all()
    ref, lps = _direct(cuda_card, reqs)
    for r, (st, _, toks, fin) in zip(reqs, got):
        rid = r["request_id"]
        assert st == 200 and fin["finish_reason"] == "stop", rid
        assert toks == fin["tokens"] == ref[rid], rid
        assert fin["logprobs"] == lps[rid], rid


@pytest.mark.gpu
def test_tiny_replica_killed_mid_stream_fails_over(cuda_card, tmp_path):
    r = dict(prompt=list(range(1, 41)), max_new_tokens=120,
             request_id="kill", stream=True)
    fe, mgr = _fleet(tmp_path)
    try:
        for _ in range(2):
            mgr.spawn()

        async def run():
            await fe.start()
            killed = []

            async def kill_its_replica():
                # the first token reached the client: SIGKILL the
                # replica whose engine holds the request
                for p in fe.peers:
                    doc = p._get_json("/debugz")
                    for rep in doc["replicas"].values():
                        if any(s and s["request_id"] == "kill"
                               for s in rep["engine"]["slots"]):
                            killed.append(mgr.kill(p.name))
                            return
            try:
                out = await sse(fe.port, r, on_first=kill_its_replica)
                assert killed and killed[0] is not None
                return out
            finally:
                await fe.drain()
        st, _, toks, fin = asyncio.run(run())
        hz = fe.healthz()
    finally:
        mgr.stop_all()
    ref, _ = _direct(cuda_card, [r])
    assert st == 200 and fin["finish_reason"] == "stop"
    assert toks == fin["tokens"] and len(toks) == 120
    assert hz["peer_failovers"] >= 1
    # the tiny model is fp32: the survivor's prefill of the committed
    # prefix gives the uninterrupted run's greedy tokens
    assert toks == ref["kill"]
