"""The port's host-RAM KV spill tier (``serving/kvspill.py`` and the
engine's ``attach_spill`` / ``spill_parked`` / ``spill_live`` / restore)
against the JAX package's, on the CPU.

Mirrors ``tests/test_kvspill.py``:

- the arena's take-side ladder (crc32 mismatch, truncation, geometry
  skew, capacity refusal) drops and counts, never returns bytes; a
  chain's spans share one payload record;
- under eviction pressure the port's engine (llama_tiny, fp32, the JAX
  model's weights through ``load_jax_state_dict``) gives the JAX
  engine's greedy tokens, logprobs within 1e-4, and equal spill
  counters, dispatches, uploads and upload bytes; spill on and off give
  the same streams bit for bit inside the port;
- an evicted span restores from the arena (one upload, one dispatch)
  and the stream equals the warm one bit for bit; a corrupted span is
  caught by the checksum and the request prefills;
- warm restart: a fresh engine attached to the arena restores a span
  another engine banked with ``spill_parked``; a skewed geometry
  prefills instead.

Across the packages: a span the JAX engine spilled, lifted onto the wire
by the JAX ``kvxfer.export_span`` and landed in the port's arena by the
port's ``kvxfer.inject_span``, restores in the port's engine, whose
stream then equals the JAX engine's (the bytes are laid out alike:
``(2L, n, B, kvh, d)`` in the pool dtype, geometry dtype "float32")."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import kvxfer as jax_kvxfer
from paddle_tpu.serving.kvspill import KVSpillArena as JaxArena
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.serving import kvxfer
from paddle_tpu_torch.serving.kvspill import KVSpillArena
from paddle_tpu_torch.utils import faults

# fp32 logprobs: the same math summed in another order by XLA and torch
ATOL_LP = 1e-4
BASE = dict(max_slots=2, num_blocks=16, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16, 32), chunk_prefill_tokens=16,
            enable_prefix_cache=True)
SPILL_STATS = ("spill_spans", "spill_restores", "spill_restored_tokens",
               "spill_restore_failures", "prefix_hit_tokens", "prefills",
               "prefill_chunks")
COUNTERS = ("dispatch_count", "h2d_uploads", "h2d_upload_bytes")


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _engine(model, arena=None, jax=False, **kw):
    eng = (JaxEngine if jax else PagedEngine)(model, **dict(BASE, **kw))
    if arena is not None:
        eng.attach_spill(arena)
    return eng


# ================================================================== arena
GEO = (2, 8, 1, 4, "float32", 16)   # (L, B, kvh, d, dtype, chunk)


def _payload(n_blocks, fill=7.0):
    L, B, kvh, d = GEO[0], GEO[1], GEO[2], GEO[3]
    return np.full((2 * L, n_blocks, B, kvh, d), fill,
                   np.float32).tobytes()


class TestArena:
    def test_spill_take_roundtrip(self):
        arena = KVSpillArena(1 << 20, name="t_rt")
        pay = _payload(2)
        assert arena.spill([(b"d2", (1, 2))], lambda e: pay, GEO, 5) == 1
        assert len(arena) == 1
        assert arena.probe(b"d2") == 16
        assert arena.take(b"d2", GEO) == (pay, 16)
        snap = arena.snapshot()
        assert snap["hits"] == 1 and snap["records"] == 1
        assert snap["occupancy_bytes"] == len(pay)

    def test_chain_dedup_one_gather_aliases_full_payload(self):
        arena = KVSpillArena(1 << 20, name="t_alias")
        pay = _payload(4)
        gathers = []

        def fetch(entry):
            gathers.append(entry)
            return pay
        assert arena.spill([(b"d4", (1, 2, 3, 4)), (b"d2", (1, 2))],
                           fetch, GEO) == 1
        assert gathers == [(1, 2, 3, 4)]
        assert arena.probe(b"d2") == 16
        assert arena.take(b"d2", GEO) == (pay, 32)
        assert arena.snapshot()["digests"] == 2

    def test_capacity_refusal_and_lru_eviction(self):
        one = len(_payload(2))
        arena = KVSpillArena(2 * one, name="t_cap")
        assert arena.spill([(b"big", tuple(range(1, 9)))],
                           lambda e: _payload(8), GEO) == 0
        assert arena.snapshot()["drops"] == 1 and len(arena) == 0
        for i in range(3):
            arena.spill([(bytes([i]) * 4, (1, 2))],
                        lambda e: _payload(2, fill=float(i)), GEO)
        assert len(arena) == 2 and arena.lru_evictions == 1
        assert arena.probe(b"\x00" * 4) is None
        assert arena.probe(b"\x02" * 4) == 16

    def test_geometry_skew_drops_record(self):
        arena = KVSpillArena(1 << 20, name="t_geo")
        arena.spill([(b"dg", (1, 2))], lambda e: _payload(2), GEO)
        assert arena.take(b"dg", (4,) + GEO[1:]) is None
        assert arena.snapshot()["drops"] == 1
        assert arena.probe(b"dg") is None

    def test_truncated_record_drops(self):
        arena = KVSpillArena(1 << 20, name="t_trunc")
        arena.spill([(b"dt", (1, 2))], lambda e: _payload(2), GEO)
        rec = arena._records[b"dt"]
        rec.payload = rec.payload[:-4]
        assert arena.take(b"dt", GEO) is None
        assert arena.snapshot()["drops"] == 1
        assert arena.probe(b"dt") is None

    def test_corrupt_fault_caught_by_checksum(self):
        arena = KVSpillArena(1 << 20, name="t_crc")
        with faults.scoped("spill_corrupt"):
            arena.spill([(b"dc", (1, 2))], lambda e: _payload(2), GEO)
        assert arena.probe(b"dc") == 16
        assert arena.take(b"dc", GEO) is None
        snap = arena.snapshot()
        assert snap["checksum_failures"] == 1 and snap["drops"] == 0
        assert arena.probe(b"dc") is None

    def test_drop_fault_refuses_store(self):
        arena = KVSpillArena(1 << 20, name="t_drop")
        with faults.scoped("spill_drop"):
            assert arena.spill([(b"dd", (1, 2))],
                               lambda e: _payload(2), GEO) == 0
        assert arena.snapshot()["drops"] == 1
        assert arena.probe(b"dd") is None

    def test_generation_advances_on_mutation(self):
        arena = KVSpillArena(1 << 20, name="t_gen")
        g0 = arena.generation
        arena.spill([(b"dgn", (1, 2))], lambda e: _payload(2), GEO)
        assert arena.generation > g0
        g1 = arena.generation
        arena.take(b"dgn", (9,) + GEO[1:])
        assert arena.generation > g1


# ================================================================= engine
def _pressure(model, arena, jax=False):
    """Five distinct 33-token prompts through a 15-block pool."""
    rs = np.random.RandomState(50)
    prompts = {f"r{i}": np.asarray([rs.randint(1, 256, 33)])
               for i in range(5)}
    eng = _engine(model, arena, jax=jax)
    for rid, ids in prompts.items():
        eng.submit(rid, ids, max_new_tokens=4)
    return eng, eng.run()


def _same_as_jax(te, je, ref, got):
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0, err_msg=str(rid))
    for k in SPILL_STATS:
        assert te.stats[k] == je.stats[k], k
    assert {c: getattr(te, c) for c in COUNTERS} == \
        {c: getattr(je, c) for c in COUNTERS}


class TestSpillParity:
    def test_eviction_pressure_against_jax_and_spill_off(self, pair):
        jm, tm = pair
        je, ref = _pressure(jm, JaxArena(64 << 20, name="jparity"),
                            jax=True)
        te, got = _pressure(tm, KVSpillArena(64 << 20, name="tparity"))
        _same_as_jax(te, je, ref, got)
        assert te.stats["spill_spans"] > 0
        off, got_off = _pressure(tm, None)
        assert got_off == got and off.logprobs == te.logprobs
        assert off.stats["spill_spans"] == 0

    def _evict_then_resubmit(self, model, arena, jax=False, corrupt=False):
        eng = _engine(model, arena, jax=jax)
        rs = np.random.RandomState(51)
        first = np.asarray([rs.randint(1, 256, 33)])
        eng.submit("a", first, max_new_tokens=4)
        eng.run()
        plan = faults.scoped("spill_corrupt") if corrupt else None
        if plan is not None:
            plan.__enter__()
        try:
            for i in range(6):
                eng.submit(f"f{i}", np.asarray([rs.randint(1, 256, 33)]),
                           max_new_tokens=4)
            eng.run()
        finally:
            if plan is not None:
                plan.__exit__(None, None, None)
        digest = eng.prefix_digest(first)
        assert bytes.fromhex(digest) not in eng.prefix_cache
        assert eng.has_prefix(digest)       # the spilled tier advertises
        hit0 = eng.stats["prefix_hit_tokens"]
        eng.submit("a2", first, max_new_tokens=4)
        out = eng.run()
        return eng, out, hit0

    def test_evicted_span_restores_and_stays_exact(self, pair):
        jm, tm = pair
        je, ref, _ = self._evict_then_resubmit(
            jm, JaxArena(64 << 20, name="jrestore"), jax=True)
        te, got, hit0 = self._evict_then_resubmit(
            tm, KVSpillArena(64 << 20, name="trestore"))
        assert te.stats["spill_restores"] >= 1, te.stats
        assert te.stats["spill_restore_failures"] == 0
        assert te.stats["prefix_hit_tokens"] > hit0
        # the restored stream is the warm one, bit for bit
        assert got["a2"] == got["a"]
        assert te.logprobs["a2"] == te.logprobs["a"]
        _same_as_jax(te, je, ref, got)

    def test_corrupted_span_never_emits_a_token(self, pair):
        _, tm = pair
        arena = KVSpillArena(64 << 20, name="tcorrupt")
        te, got, _ = self._evict_then_resubmit(tm, arena, corrupt=True)
        assert got["a2"] == got["a"]
        assert te.logprobs["a2"] == te.logprobs["a"]
        assert te.stats["spill_restores"] == 0
        assert te.stats["spill_restore_failures"] >= 1, te.stats
        assert arena.snapshot()["checksum_failures"] >= 1


class TestWarmRestart:
    def test_rebuild_recovers_warm_from_arena(self, pair):
        _, tm = pair
        arena = KVSpillArena(64 << 20, name="twarm")
        e0 = _engine(tm, arena, num_blocks=32)
        rs = np.random.RandomState(53)
        prompt = np.asarray([rs.randint(1, 256, 33)])
        e0.submit("a", prompt, max_new_tokens=4)
        ref = e0.run()["a"]
        lp_ref = e0.logprobs["a"]
        assert e0.spill_parked() > 0
        e1 = _engine(tm, arena, num_blocks=32)
        assert e1.has_prefix(e1.prefix_digest(prompt))
        e1.submit("b", prompt, max_new_tokens=4)
        out = e1.run()
        assert e1.stats["spill_restores"] >= 1, e1.stats
        assert e1.stats["prefix_hit_tokens"] >= 16, e1.stats
        assert out["b"] == ref and e1.logprobs["b"] == lp_ref

    def test_geometry_skew_falls_back_to_prefill(self, pair):
        _, tm = pair
        arena = KVSpillArena(64 << 20, name="tskew")
        e0 = _engine(tm, arena, num_blocks=32)
        rs = np.random.RandomState(54)
        prompt = np.asarray([rs.randint(1, 256, 33)])
        e0.submit("a", prompt, max_new_tokens=4)
        ref = e0.run()["a"]
        assert e0.spill_parked() > 0
        e1 = _engine(tm, arena, num_blocks=32, block_size=4,
                     max_blocks_per_seq=16)
        e1.submit("b", prompt, max_new_tokens=4)
        assert e1.run()["b"] == ref
        assert e1.stats["spill_restores"] == 0
        assert arena.snapshot()["drops"] >= 1

    def test_spill_live_banks_active_spans(self, pair):
        """A live request's computed chunk-grid span banks into the arena
        and restores into another engine, whose continuation of the
        resubmitted stream equals the uninterrupted one."""
        _, tm = pair
        arena = KVSpillArena(64 << 20, name="tlive")
        rs = np.random.RandomState(55)
        prompt = np.asarray([rs.randint(1, 256, 30)])
        full = _engine(tm, num_blocks=32)
        full.submit("a", prompt, max_new_tokens=12)
        ref = full.run()["a"]
        e0 = _engine(tm, arena, num_blocks=32)
        e0.submit("a", prompt, max_new_tokens=12)
        for _ in range(8):
            e0.step()
        assert e0.spill_live() > 0
        desc = e0.export_resumable()["a"]
        e1 = _engine(tm, arena, num_blocks=32)
        e1.submit("a", [desc["prompt"]], max_new_tokens=desc["remaining"],
                  resume_tokens=desc["committed"],
                  resume_lps=desc["committed_lps"])
        out = e1.run()
        assert e1.stats["spill_restores"] >= 1, e1.stats
        assert out["a"] == ref


def test_jax_spilled_span_restores_in_the_port(pair):
    """A span the JAX engine banked crosses to the port's arena on the
    kvxfer wire and restores in the port's engine: the stream equals the
    JAX engine's warm one (tokens; logprobs within ATOL_LP)."""
    jm, tm = pair
    jarena = JaxArena(64 << 20, name="jx-src")
    je = _engine(jm, jarena, jax=True, num_blocks=32)
    rs = np.random.RandomState(56)
    prompt = np.asarray([rs.randint(1, 256, 33)])
    je.submit("a", prompt, max_new_tokens=6)
    ref = je.run()["a"]
    assert je.spill_parked() > 0
    te = _engine(tm, num_blocks=32)
    geo = te._spill_geometry()
    assert tuple(je._spill_geometry()) == geo
    parena = KVSpillArena(64 << 20, name="jx-dst")
    te.attach_spill(parena)
    digest = te.prefix_digest(prompt)
    blob = jax_kvxfer.export_span(jarena, digest, geo)
    assert blob is not None
    assert kvxfer.inject_span(parena, blob, geo) == (digest, 32)
    te.submit("b", prompt, max_new_tokens=6)
    out = te.run()
    assert te.stats["spill_restores"] == 1, te.stats
    assert te.stats["prefix_hit_tokens"] == 32
    assert out["b"] == ref
    np.testing.assert_allclose(te.logprobs["b"], je.logprobs["a"],
                               atol=ATOL_LP, rtol=0)
