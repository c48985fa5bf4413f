"""A tp replica's KV transfer: spans cross replicas as records of the whole
model's heads, whatever tp degree served them.

A sequenced replica (``serving/tp_replica.py``) keeps each span as its
ranks' parts, each rank's arena its own kv heads. ``/kvz`` gathers the
parts to rank 0, which joins them in tp order into one ``kvxfer`` record;
an imported record is cut back into the ranks' parts, and every rank puts
its own at one point of the sequence.

- A tp 1 replica in this process (the port's ``Gateway`` over a plain
  ``PagedEngine``) serves three prompts and exports their spans over
  ``/kvz``.
- In gloo worlds on {"tp": 2} and on {"tp": 2, "ep": 2} (the dense tiny
  Llama: each ep rank holds the same heads), rank 0's ``Gateway`` over a
  ``SequencedEngine``: a stream migrated from the tp 1 replica (its
  prompt, 3 committed tokens and the record inline as ``resume_kv``)
  continues with the uninterrupted stream's greedy tokens, the import
  and restore counters move and the re-prefill counter
  (``kv_xfer_fallbacks_total``) does not; a span it served comes out of
  ``/kvz``; a corrupt and a truncated record are counted re-prefills and
  the streams' tokens are still the uninterrupted ones.
- Back in this process, the tp 2 replica's record resumes a stream on a
  fresh tp 1 replica the same way; it decodes to the K/V the tp 1 replica
  exports for the same prompt, and to the JAX ``Gateway``'s ``/kvz``
  record over the JAX ``PagedEngine``, within ``ATOL_KV`` (fp32: the
  second layer's input is a tp reduce, summed in another order).

MoE replicas keep no prefix cache in either package (whole-prompt
prefill), so they hold no spans to move."""
import asyncio

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import Gateway as JaxGateway
from paddle_tpu.serving import KVSpillArena as JaxArena
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving import Gateway, KVSpillArena, kvxfer
from test_torch_gateway_gpu import http, sse
from torch_dist_workers import (TP_GEO, kvx_resume, longest_resident,
                                start_world)

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4)
# fp32 K/V of one projection, the second layer's input a tp reduce
ATOL_KV = 1e-5
NEW = 12
MESHES = {"tp2": {"tp": 2}, "tp2ep2": {"tp": 2, "ep": 2}}


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_model():
    pt.seed(0)
    return JaxLlama(jax_llama_tiny(**CFG))


def _prompts():
    rs = np.random.RandomState(21)
    return {k: rs.randint(1, 256, 24).tolist() for k in ("q1", "q2", "q3")}


def _port_model(params):
    m = ptt.LlamaForCausalLM(ptt.llama_tiny(**CFG), device="cpu")
    ptt.load_jax_state_dict(m, params)
    return m


async def _tp1(model, name, prompts, resume=None):
    """A tp 1 replica: each prompt's greedy stream, its span's ``/kvz``
    record after the parked prefixes are banked; or, with ``resume``, one
    resumed request; and its counters."""
    eng = PagedEngine(model, **TP_GEO)
    gw = Gateway(eng, name=name, spill_arena=KVSpillArena(1 << 22,
                                                          name=name))
    await gw.start()
    out = {}
    try:
        if resume is not None:
            st, _, toks, fin = await sse(gw.port, resume)
            out["resume"] = (st, toks, fin["finish_reason"])
        for key, q in prompts.items():
            st, _, toks, _ = await sse(gw.port, dict(
                request_id=key, prompt=q, max_new_tokens=NEW,
                temperature=0.0))
            assert st == 200
            out[key] = toks
        eng.spill_parked()
        for key, q in prompts.items():
            digest = longest_resident(eng, gw._spill_arena,
                                      q + out[key][:3])
            st, _, blob = await http(gw.port, "GET",
                                     f"/kvz?digest={digest}")
            assert st == 200
            out[f"{key}_kvz"] = (digest, blob)
        out["counters"] = (kvxfer.counters_snapshot(name), dict(eng.stats))
    finally:
        await gw.drain()
    return out


def _jax_kvz(prompt):
    """The JAX Gateway's ``/kvz`` record of ``prompt``'s span."""
    eng = JaxEngine(_jax_model(), **TP_GEO)

    async def run():
        gw = JaxGateway(eng, name="jax-kvx",
                        spill_arena=JaxArena(1 << 22, name="jax-kvx"))
        await gw.start()
        try:
            st, _, toks, _ = await sse(gw.port, dict(
                request_id="q2", prompt=prompt, max_new_tokens=NEW,
                temperature=0.0))
            assert st == 200
            eng.spill_parked()
            digest = longest_resident(eng, gw._spill_arena,
                                      prompt + toks[:3])
            st, _, blob = await http(gw.port, "GET",
                                     f"/kvz?digest={digest}")
            assert st == 200
            return blob
        finally:
            await gw.drain()
    return asyncio.run(run())


def _corrupt(blob):
    pos = len(blob) - 7
    return blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_kvxfer")
    params = {k: np.asarray(v) for k, v in _jax_model().state_dict().items()}
    prompts = _prompts()
    tp1 = asyncio.run(_tp1(_port_model(params), "kvx-tp1", prompts))
    r3 = tp1["q3_kvz"][1]
    p = dict(cfg=CFG, params=params, new=NEW, r1=tp1["q1_kvz"][1],
             r3_corrupt=_corrupt(r3), r3_trunc=r3[:len(r3) // 2],
             streams={k: (q, tp1[k]) for k, q in prompts.items()})
    handles = {k: start_world("tp_kvxfer", int(np.prod(list(m.values()))),
                              tmp / k, dict(p, mesh=m), timeout_s=300)
               for k, m in MESHES.items()}
    jax_r2 = _jax_kvz(prompts["q2"])
    worlds = {k: h.result() for k, h in handles.items()}
    # the tp 2 replica's record resumes a stream on a fresh tp 1 replica
    q2 = prompts["q2"]
    back = asyncio.run(_tp1(
        _port_model(params), "kvx-tp1-back", {},
        resume=kvx_resume(q2, tp1["q2"], 3,
                          worlds["tp2"][0]["leader"]["kvz"][2])))
    return dict(tp1=tp1, worlds=worlds, jax_r2=jax_r2, back=back,
                prompts=prompts)


def _payload(blob, geometry):
    _, _, payload = kvxfer.decode_span(blob, geometry)
    return np.frombuffer(payload, np.float32)


def _geometry(blob):
    import json
    import struct
    (n,) = struct.unpack_from("<I", blob, 4)
    return tuple(json.loads(blob[8:8 + n])["geometry"])


@pytest.mark.parametrize("key", tuple(MESHES))
def test_a_migrated_stream_resumes_from_the_imported_record(served, key):
    """From the tp 1 replica onto the sequenced one: the uninterrupted
    greedy tokens; one import and one restore; no re-prefill."""
    lead = served["worlds"][key][0]["leader"]
    st, toks, fin = lead["resume"]
    assert st == 200 and fin == "stop"
    # the stream replays its committed tokens, then continues
    assert toks == served["tp1"]["q1"]
    ctr, stats = lead["after_resume"]
    assert ctr["kv_xfer_hits_total"] == 1
    assert ctr["kv_xfer_fallbacks_total"] == 0
    assert stats["spill_restores"] == 1
    # every rank restored the span: the followers' counters are rank 0's
    for r in served["worlds"][key][1:]:
        assert r["stats"]["spill_restores"] == \
            served["worlds"][key][0]["stats"]["spill_restores"]


@pytest.mark.parametrize("key", tuple(MESHES))
def test_kvz_serves_the_whole_models_record(served, key):
    """``/kvz`` on the sequenced replica: a record of all kv heads, the
    same K/V as the tp 1 replica's record of the same prompt and the JAX
    gateway's."""
    lead = served["worlds"][key][0]["leader"]
    st, digest, blob = lead["kvz"]
    assert st == 200
    assert lead["q2"][1] == served["tp1"]["q2"]
    want_digest, want = served["tp1"]["q2_kvz"]
    assert digest == want_digest
    geo = _geometry(want)
    assert _geometry(blob) == geo and geo[2] == CFG["num_key_value_heads"]
    got = _payload(blob, geo)
    np.testing.assert_allclose(got, _payload(want, geo), atol=ATOL_KV,
                               rtol=0)
    np.testing.assert_allclose(got, _payload(served["jax_r2"], geo),
                               atol=ATOL_KV, rtol=0)


def test_the_tp2_record_resumes_on_a_tp1_replica(served):
    st, toks, fin = served["back"]["resume"]
    assert st == 200 and fin == "stop"
    assert toks == served["tp1"]["q2"]
    ctr, stats = served["back"]["counters"]
    assert ctr["kv_xfer_hits_total"] == 1
    assert ctr["kv_xfer_fallbacks_total"] == 0
    assert stats["spill_restores"] == 1


@pytest.mark.parametrize("key", tuple(MESHES))
def test_a_damaged_record_is_a_counted_reprefill(served, key):
    """A flipped payload byte (the crc rung) and a record cut in half
    (the truncation rung): each a counted fallback, never a token; the
    streams re-prefill to the uninterrupted tokens."""
    lead = served["worlds"][key][0]["leader"]
    want = served["tp1"]["q3"]
    for kind in ("corrupt", "trunc"):
        st, toks = lead[kind]
        assert st == 200 and toks == want
    ctr0, _ = lead["after_resume"]
    ctr, _ = lead["end"]
    assert ctr["kv_xfer_fallbacks_total"] - \
        ctr0["kv_xfer_fallbacks_total"] == 2
    assert ctr["kv_xfer_checksum_failures_total"] == 1
    assert ctr["kv_xfer_hits_total"] == ctr0["kv_xfer_hits_total"]
