"""The MoE families and MLA served on a tp mesh and a tp x ep mesh, the
port against the JAX package on the same mesh, in spawned gloo worlds on
the CPU (fp32).

Models (tiny configs, the JAX weights crossing as numpy, each port model
built inside ``sharded_build`` and loaded a rank's slices at a time by
``load_jax_state_dict``): Qwen2-MoE (capacity factor 0.5: tokens are
dropped), DeepSeek-MoE, ERNIE-4.5 (8 query heads over 4 kv heads, so tp 4
holds one kv head a rank), DeepSeek-V2 and a V3 variant (sigmoid scores,
group-limited routing, one MTP module). Meshes: ``{"tp": 2}``,
``{"tp": 4}`` and ``{"tp": 2, "ep": 2}``; the JAX references run in this
process on ``jax.devices()[:n]`` while the worlds run.

- Prefill logits within ``ATOL``; every MoE layer's routing decisions
  (experts in choice order, bucket slots, drops) equal the JAX layer's.
- Greedy ``generate()``, beam search, the ``PagedEngine`` and MTP-as-draft
  streams equal the JAX package's; the sampled streams and every other
  stream are the same on every rank.
- ``Predictor`` int8 (and int4, on Qwen2-MoE and ERNIE-4.5-MoE at hidden
  256) logits within ``ATOL_INT8`` of the JAX quantized
  model's, greedy equal; bf16 logits within ``ATOL_BF16`` of the fp32 ones.
- HF checkpoints of the four MoE families loaded inside ``sharded_build``
  give this rank's tensors of the whole load bit for bit, reading only
  this rank's experts.
- At tp x ep, a ``SequencedEngine`` behind the port's ``Gateway`` serves
  the streams of the JAX ``Gateway`` over the JAX engine; a ``replica_main
  --tp 2 --ep 2 --model ernie-tiny`` replica behind a ``FleetFrontend``
  serves a plain engine's streams and drains with exit 0.
"""
import asyncio
import contextlib
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.generation import mtp_speculative_generate as jax_mtp
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import deepseek_v2 as jds
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import qwen2_moe as jqwen
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.quant import quantize_model as jax_quantize_model
from paddle_tpu.serving import Gateway as JaxGateway
from test_torch_gateway_gpu import sse
from test_torch_hf_interop import (MOE_CONFIGS, _hf_config, _moe_weights,
                                   _write_experts_split)
from torch_dist_workers import MOE_GEO, start_world

# fp32 logits (lm_head x 10) of sums whose tp and ep partial sums add in
# another order than the JAX program's
ATOL = 2e-4
# int8 codes of the same weights: the dequantized products in another
# order, the row layers' partial sums over tp
ATOL_INT8 = 2e-3
# bf16 weights and activations against the fp32 model: logits of
# magnitude up to ~20 (lm_head x 10), a bf16 step 2^-8 relative
ATOL_BF16 = 0.5
V3 = dict(num_experts=8, n_group=4, topk_group=2, scoring="sigmoid",
          group_score_mode="top2_sum", norm_topk_prob=True,
          routed_scaling_factor=2.5, num_nextn_predict_layers=1)
CFGS = {"qwen": dict(capacity_factor=0.5), "dsmoe": {},
        "ernie": dict(hidden_size=256, intermediate_size=512,
                      num_attention_heads=8, num_key_value_heads=4),
        "ds2": {}, "ds3": V3,
        # Qwen2-MoE at hidden 256: every attention projection quantizes
        "qwenq": dict(hidden_size=256, intermediate_size=512,
                      num_attention_heads=8, num_key_value_heads=4,
                      capacity_factor=0.5)}
JAX_MODELS = {"qwen": (jqwen.Qwen2MoeForCausalLM, jqwen.qwen2_moe_tiny),
              "dsmoe": (jqwen.Qwen2MoeForCausalLM, jqwen.deepseek_moe_tiny),
              "ernie": (jernie.Ernie45MoeForCausalLM,
                        jernie.ernie45_moe_tiny),
              "ds2": (jds.DeepseekV2ForCausalLM, jds.deepseek_v2_tiny),
              "ds3": (jds.DeepseekV2ForCausalLM, jds.deepseek_v2_tiny),
              "qwenq": (jqwen.Qwen2MoeForCausalLM, jqwen.qwen2_moe_tiny)}
SEEDS = {"qwen": 0, "dsmoe": 1, "ernie": 2, "ds2": 3, "ds3": 4, "qwenq": 9}
EXPERTS = {"qwen": 4, "dsmoe": 8, "ernie": 4, "ds2": 4, "ds3": 8,
           "qwenq": 4}
# tuples, not sets: the parametrized cases must come out in one order in
# every process that collects them
WORLDS = {
    "tp2": dict(mesh={"tp": 2}, models=("qwen", "ernie", "ds2", "ds3"),
                beam=("qwen", "ds2"), sampled=("qwen",), engine=("qwen",),
                int8=("ernie",), int4=("qwenq", "ernie"), bf16=("ernie",),
                ckpts=True),
    "tp4": dict(mesh={"tp": 4}, models=("ernie", "ds2"), beam=("ernie",),
                sampled=(), engine=("ernie",), int8=(), int4=(), bf16=(),
                ckpts=False),
    "tp2ep2": dict(mesh={"tp": 2, "ep": 2}, models=("dsmoe", "ds3", "ernie"),
                   beam=("dsmoe",), sampled=("dsmoe",), engine=(),
                   gateway="dsmoe", int8=("ernie",), int4=("qwenq", "ernie"),
                   bf16=(), ckpts=True)}
# the replica process: replica_main --model ernie-tiny from this seed
FLEET_SEED = 7


@contextlib.contextmanager
def _no_cache_writes():
    """Compile the JAX references without writing the persistent cache
    (workers reading an entry another writes can get a torn one)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


@contextlib.contextmanager
def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    jenv.init_parallel_env(shape, devices=jax.devices()[:n])
    try:
        yield
    finally:
        jenv.init_parallel_env({})


def _jax_model(kind):
    """The JAX model of ``kind`` from its seed, its lm_head x 10 (decisive
    logits: a greedy stream does not hang on a near tie)."""
    cls, tiny = JAX_MODELS[kind]
    pt.seed(SEEDS[kind])
    m = cls(tiny(**CFGS[kind]))
    m.eval()
    m.lm_head.weight = m.lm_head.weight * 10.0
    return m


def _jax_logits_and_routes(m, ids):
    """The prefill logits of one jitted forward, and every MoE layer's
    decisions in it: (experts in choice order [T, k], dispatch [T, E,
    C]), taken from the traced routing as outputs of the program."""
    fn, params = m.functional()
    got, sel, route = [], jmoe._select_topk, jmoe.top_k_routing

    def select(*a, **kw):
        probs, e = sel(*a, **kw)
        got.append(e)
        return probs, e

    def routing(*a, **kw):
        out = route(*a, **kw)
        got.append(out[0])
        return out

    def forward(params, ids):
        got.clear()
        return fn(params, ids), list(got)
    jmoe._select_topk, jmoe.top_k_routing = select, routing
    try:
        logits, seq = jax.jit(forward)(params, jnp.asarray(ids))
    finally:
        jmoe._select_topk, jmoe.top_k_routing = sel, route
    return np.asarray(logits), [(np.asarray(seq[i]), np.asarray(seq[i + 1]))
                                for i in range(0, len(seq), 2)]


def _requests():
    rs = np.random.RandomState(5)
    ids = lambda n: rs.randint(1, 256, n).tolist()   # noqa: E731
    a = dict(request_id="a", prompt=ids(11), max_new_tokens=8)
    b = dict(request_id="b", prompt=ids(14), max_new_tokens=8)
    s = dict(request_id="s", prompt=ids(7), max_new_tokens=8,
             temperature=0.8, top_p=0.9, seed=5)
    return [[a], [b, s]]


def _script(reqs):
    return [[(r["request_id"], r["prompt"],
              {k: v for k, v in r.items()
               if k not in ("request_id", "prompt")}) for r in batch]
            for batch in reqs]


def _checkpoints(tmp):
    """An HF checkpoint of each MoE family, its experts split over two
    safetensors shards."""
    out = {}
    for i, family in enumerate(MOE_CONFIGS):
        cfg = _hf_config(**MOE_CONFIGS[family])
        out[family] = _write_experts_split(
            tmp / f"ckpt_{family}", cfg, _moe_weights(cfg, seed=30 + i))
    return out


def _payload(world, tmp):
    w = WORLDS[world]
    params = {}
    for kind in dict.fromkeys(w["models"] + w["int4"]):
        params[kind] = {k: np.asarray(v)
                        for k, v in _jax_model(kind).state_dict().items()}
    reqs = _requests()
    return dict(mesh=w["mesh"], models=w["models"], beam=w["beam"],
                sampled=w["sampled"], engine=w["engine"],
                gateway=w.get("gateway"), int8=w["int8"], int4=w["int4"],
                bf16=w["bf16"],
                cfgs=CFGS, params=params,
                ids=np.random.RandomState(6).randint(1, 256, (2, 9)),
                script=_script(reqs), gw_reqs=reqs,
                ckpts=_checkpoints(tmp) if w["ckpts"] else {})


def _jax_engine(m, script):
    """The script's greedy requests through the JAX engine (a tick's
    two rows route dropless, so the port's sampled row beside them
    changes no other row; JAX keys have no torch counterpart)."""
    eng = JaxEngine(m, **MOE_GEO)
    out = {}
    for batch in script:
        batch = [b for b in batch if not b[2].get("temperature")]
        for rid, prompt, kw in batch:
            eng.submit(rid, np.asarray([prompt]), **kw)
        eng.run()
        for rid, _, _ in batch:
            out[rid] = ([int(t) for t in eng.results.pop(rid)],
                        [float(x) for x in eng.logprobs.pop(rid)])
    return out


def _jax_gateway(m, reqs):
    """The greedy requests over HTTP SSE through the JAX Gateway over the
    JAX engine."""
    eng = JaxEngine(m, **MOE_GEO)
    reqs = [[r for r in batch if not r.get("temperature")]
            for batch in reqs]

    async def run():
        gw = JaxGateway(eng, name="jax-tp-moe")
        await gw.start()
        got = {}
        try:
            for batch in reqs:
                res = await asyncio.gather(*[sse(gw.port, r) for r in batch])
                for r, (st, _, toks, fin) in zip(batch, res):
                    got[r["request_id"]] = (st, toks, fin)
        finally:
            await gw.drain()
        return got
    return asyncio.run(run())


def _jax_forward(m, ids):
    fn, params = m.functional()
    return np.asarray(jax.jit(fn)(params, jnp.asarray(ids)))


def _jax_refs(world, p):
    """The JAX package's results on the world's mesh."""
    w = WORLDS[world]
    ids = jnp.asarray(p["ids"])
    ref = {}
    with _mesh(w["mesh"]):
        for kind in w["models"]:
            m = _jax_model(kind)
            jax_shard_layer(m, fsdp_min_size=1 << 30)
            ref[f"{kind}_logits"], ref[f"{kind}_routes"] = \
                _jax_logits_and_routes(m, p["ids"])
            ref[f"{kind}_greedy"] = np.asarray(
                m.generate(ids, max_new_tokens=8, temperature=0.0))
            if kind in w["beam"]:
                ref[f"{kind}_beam"] = np.asarray(
                    m.generate(ids, max_new_tokens=6, num_beams=3))
            if kind == "ds3":
                out, stats = jax_mtp(m, ids, max_new_tokens=8,
                                     num_draft_tokens=3, return_stats=True)
                ref["ds3_mtp"] = np.asarray(out)
                ref["ds3_mtp_forwards"] = stats["target_forwards"]
            if kind in w["engine"]:
                ref[f"{kind}_engine"] = _jax_engine(m, p["script"])
            if kind == w.get("gateway"):
                ref["gateway"] = _jax_gateway(m, p["gw_reqs"])
            if kind in w["int8"]:
                q = _jax_model(kind)
                jax_quantize_model(q, bits=8, skip=["lm_head", "embed"])
                jax_shard_layer(q, fsdp_min_size=1 << 30)
                ref[f"{kind}_int8_logits"] = _jax_forward(q, p["ids"])
                ref[f"{kind}_int8_greedy"] = np.asarray(
                    q.generate(ids, max_new_tokens=6, temperature=0.0))
        for kind in w["int4"]:
            q = _jax_model(kind)
            jax_quantize_model(q, bits=4, skip=["lm_head", "embed"])
            jax_shard_layer(q, fsdp_min_size=1 << 30)
            ref[f"{kind}_int4_logits"] = _jax_forward(q, p["ids"])
            ref[f"{kind}_int4_greedy"] = np.asarray(
                q.generate(ids, max_new_tokens=6, temperature=0.0))
    return ref


def _replica_traffic(tmp):
    """``replica_main --tp 2 --ep 2 --model ernie-tiny`` through
    ``LocalProcessManager`` behind a ``FleetFrontend``: three greedy and
    one sampled request at once, then a SIGTERM drain."""
    from paddle_tpu_torch.serving.fleet import (FleetFrontend,
                                                LocalProcessManager)
    rs = np.random.RandomState(8)
    reqs = [dict(request_id=f"r{i}", prompt=rs.randint(1, 256, n).tolist(),
                 max_new_tokens=10) for i, n in enumerate((12, 20, 27))]
    reqs.append(dict(request_id="rs", prompt=rs.randint(1, 256, 9).tolist(),
                     max_new_tokens=10, temperature=0.7, seed=3))
    fe = FleetFrontend([], chunk_tokens=32, name="tp-moe-fleet")
    mgr = LocalProcessManager(fe, model="ernie-tiny", chunk_tokens=32,
                              device="cpu", seed=FLEET_SEED, tp=2, ep=2,
                              spawn_timeout_s=240, drain_grace_s=20,
                              log_dir=str(tmp / "replica_logs"))
    out = {"reqs": reqs}
    try:
        peer = mgr.spawn()
        proc = mgr.procs[peer.name]
        doc = peer._get_json("/debugz")["replicas"]["r0"]["engine"]
        out["seq"] = doc["tp_sequencer"]

        async def traffic():
            await fe.start()
            try:
                res = await asyncio.gather(*[sse(fe.port, r) for r in reqs])
            finally:
                await fe.drain()
            return {r["request_id"]: (st, toks, fin)
                    for r, (st, _, toks, fin) in zip(reqs, res)}
        out["streams"] = asyncio.run(traffic())
        mgr.stop_all(grace_s=30)
        out["rc"] = proc.wait(10)
    finally:
        mgr.stop_all(grace_s=5)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The worlds, the replica process and the JAX references of tp 4 and
    tp 2 x ep 2 (each in a process of its own) start together; tp 2's
    references run here meanwhile."""
    import multiprocessing as mp

    import jax_tp_moe_child
    tmp = tmp_path_factory.mktemp("tp_moe")
    payloads = {w: _payload(w, tmp) for w in WORLDS}
    worlds = {w: start_world("tp_moe", int(np.prod(list(
        WORLDS[w]["mesh"].values()))), tmp / w, payloads[w], timeout_s=420)
        for w in WORLDS}
    children = {}
    for w in ("tp4", "tp2ep2"):
        path = str(tmp / f"jax_{w}.pkl")
        proc = mp.get_context("spawn").Process(
            target=jax_tp_moe_child.run, args=(w, payloads[w], path),
            daemon=True)
        proc.start()
        children[w] = (proc, path)
    fleet = {}

    def replica():
        try:
            fleet.update(_replica_traffic(tmp))
        except Exception as e:       # raised where the test reads it
            fleet["error"] = repr(e)
    t = threading.Thread(target=replica)
    t.start()
    try:
        with _no_cache_writes():
            refs = {"tp2": _jax_refs("tp2", payloads["tp2"])}
        for w, (proc, path) in children.items():
            proc.join(300)
            assert proc.exitcode == 0, f"JAX references of {w}: exit " \
                f"{proc.exitcode}"
            with open(path, "rb") as f:
                refs[w] = pickle.load(f)
        t.join(300)
        ranks = {w: worlds[w].result() for w in WORLDS}
    finally:
        for proc, _ in children.values():
            if proc.is_alive():
                proc.kill()
    return payloads, ranks, refs, fleet


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


def _cases(key):
    return [(w, k) for w in WORLDS for k in WORLDS[w][key]]


def _margins(logits, k):
    """The top-k margin of each token's router scores: the k-th score
    less the (k+1)-th."""
    s = np.sort(logits, axis=-1)[:, ::-1]
    return s[:, k - 1] - s[:, k]


# ---------------------------------------------------- weights and layout
@pytest.mark.parametrize("world,kind", _cases("models"))
def test_sharded_build_loads_the_whole_models_shards(served, world, kind):
    """Built inside sharded_build and loaded a rank's slices at a time:
    every rank's tensors are shard_layer of the whole model loaded
    whole, each bound as the local shard itself (ep shards too); a rank
    holds E / ep experts and its kv heads (MLA: the whole latent
    cache)."""
    _, ranks, _, _ = served
    mesh = WORLDS[world]["mesh"]
    tp, ep = mesh["tp"], mesh.get("ep", 1)
    for r in ranks[world]:
        assert r[f"{kind}_same"] == (True, True), (world, kind)
        assert r[f"{kind}_experts"][0] == EXPERTS[kind] // ep
        cache = r[f"{kind}_cache"]
        if kind in ("ds2", "ds3"):
            assert cache == (1, 4, 32)        # kv_lora_rank, every head
        else:
            assert cache[2] == CFGS[kind].get("num_key_value_heads", 2) // tp


# ------------------------------------------------------- logits, routing
@pytest.mark.parametrize("world,kind", _cases("models"))
def test_prefill_logits_match_jax(served, world, kind):
    _, ranks, refs, _ = served
    for r in ranks[world]:
        np.testing.assert_allclose(r[f"{kind}_logits"],
                                   refs[world][f"{kind}_logits"],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("world,kind", _cases("models"))
def test_routing_decisions_equal_jax(served, world, kind):
    """Experts in choice order, bucket slots and drops, layer by layer,
    on every rank; a difference reports its tokens' top-k margins."""
    _, ranks, refs, _ = served
    want = refs[world][f"{kind}_routes"]
    for r in ranks[world]:
        got = r[f"{kind}_routes"]
        assert len(got) == len(want) > 0
        for layer, ((logits, ids, slot, keep), (jids, jdisp)) in \
                enumerate(zip(got, want)):
            T, k = ids.shape
            disp = np.zeros_like(jdisp)
            for t in range(T):
                for j in range(k):
                    disp[t, ids[t, j], slot[t, j]] = keep[t, j]
            bad = np.nonzero((ids != jids).any(-1)
                             | (disp != jdisp).any((1, 2)))[0]
            assert not len(bad), (
                f"{world} {kind} layer {layer}: tokens {bad.tolist()} "
                f"routed otherwise, top-{k} margins "
                f"{_margins(logits, k)[bad].tolist()}")
        assert any(not keep.all() for _, _, _, keep in got) == any(
            d.sum() < i.size for i, d in want)
    if kind == "qwen":
        # the tight capacity dropped tokens, so drops were compared
        assert any(not keep.all() for _, _, _, keep in
                   ranks[world][0][f"{kind}_routes"])


# ------------------------------------------------------------- streams
@pytest.mark.parametrize("world,kind", _cases("models"))
def test_greedy_generate_matches_jax(served, world, kind):
    _, ranks, refs, _ = served
    np.testing.assert_array_equal(ranks[world][0][f"{kind}_greedy"],
                                  refs[world][f"{kind}_greedy"])
    _same_on_every_rank(ranks[world], f"{kind}_greedy")


@pytest.mark.parametrize("world,kind", _cases("beam"))
def test_beam_search_matches_jax(served, world, kind):
    _, ranks, refs, _ = served
    np.testing.assert_array_equal(ranks[world][0][f"{kind}_beam"],
                                  refs[world][f"{kind}_beam"])
    _same_on_every_rank(ranks[world], f"{kind}_beam")


@pytest.mark.parametrize("world,kind", _cases("sampled"))
def test_sampled_generate_is_the_same_on_every_rank(served, world, kind):
    _, ranks, _, _ = served
    out = ranks[world][0][f"{kind}_sampled"]
    assert out.shape == (2, 17) and ((out >= 0) & (out < 256)).all()
    _same_on_every_rank(ranks[world], f"{kind}_sampled")


@pytest.mark.parametrize("world,kind", _cases("engine"))
def test_paged_engine_matches_jax_engine(served, world, kind):
    _, ranks, refs, _ = served
    want = refs[world][f"{kind}_engine"]
    got = ranks[world][0][f"{kind}_engine"]
    for rid in ("a", "b"):
        assert got[rid][0] == want[rid][0], rid
        np.testing.assert_allclose(got[rid][1], want[rid][1], atol=ATOL,
                                   rtol=0)
    assert len(got["s"][0]) == 8
    _same_on_every_rank(ranks[world], f"{kind}_engine")


@pytest.mark.parametrize("world", ["tp2", "tp2ep2"])
def test_mtp_draft_streams_equal_greedy_and_jax(served, world):
    _, ranks, refs, _ = served
    for r in ranks[world]:
        np.testing.assert_array_equal(r["ds3_mtp"], r["ds3_greedy"])
        np.testing.assert_array_equal(r["ds3_mtp"], refs[world]["ds3_mtp"])
        assert r["ds3_mtp_forwards"] == refs[world]["ds3_mtp_forwards"]


# ----------------------------------------------------------- Predictor
@pytest.mark.parametrize("world,kind", _cases("int8"))
def test_predictor_int8_matches_jax(served, world, kind):
    _, ranks, refs, _ = served
    h = CFGS[kind]["hidden_size"]
    tp = WORLDS[world]["mesh"]["tp"]
    for r in ranks[world]:
        np.testing.assert_allclose(r[f"{kind}_int8_logits"],
                                   refs[world][f"{kind}_int8_logits"],
                                   atol=ATOL_INT8, rtol=0)
        # a rank's codes of its q columns and o rows
        assert r[f"{kind}_int8_codes"] == ((h, h // tp), (h // tp, h))
    np.testing.assert_array_equal(ranks[world][0][f"{kind}_int8_greedy"],
                                  refs[world][f"{kind}_int8_greedy"])
    _same_on_every_rank(ranks[world], f"{kind}_int8_greedy")


@pytest.mark.parametrize("world,kind", _cases("int4"))
def test_predictor_int4_matches_jax(served, world, kind):
    """The weight-only ``Predictor`` at int4 on Qwen2-MoE and
    ERNIE-4.5-MoE at hidden 256 (every attention projection quantizes;
    the experts are stacked parameters, not linears, in both packages):
    logits within ``ATOL_INT8`` of the JAX quantized model on the same
    mesh, greedy tokens equal, the same on every rank."""
    _, ranks, refs, _ = served
    h = CFGS[kind]["hidden_size"]
    tp = WORLDS[world]["mesh"]["tp"]
    for r in ranks[world]:
        np.testing.assert_allclose(r[f"{kind}_int4_logits"],
                                   refs[world][f"{kind}_int4_logits"],
                                   atol=ATOL_INT8, rtol=0)
        # a rank's int4 codes of its q columns and o rows (two a byte)
        assert r[f"{kind}_int4_codes"][0][1] == h // tp
    np.testing.assert_array_equal(ranks[world][0][f"{kind}_int4_greedy"],
                                  refs[world][f"{kind}_int4_greedy"])
    _same_on_every_rank(ranks[world], f"{kind}_int4_greedy")


@pytest.mark.parametrize("world,kind", _cases("bf16"))
def test_predictor_bf16_near_fp32_and_the_same_on_every_rank(
        served, world, kind):
    _, ranks, refs, _ = served
    for r in ranks[world]:
        np.testing.assert_allclose(r[f"{kind}_bf16_logits"],
                                   refs[world][f"{kind}_logits"],
                                   atol=ATOL_BF16, rtol=0)
    _same_on_every_rank(ranks[world], f"{kind}_bf16_greedy")
    _same_on_every_rank(ranks[world], f"{kind}_bf16_logits")


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("world", ["tp2", "tp2ep2"])
@pytest.mark.parametrize("family", list(MOE_CONFIGS))
def test_from_pretrained_in_sharded_build_is_the_whole_load(
        served, world, family):
    """Bit for bit the whole load's shards; a rank reads only its own
    experts, whole (E / ep of the 4 of each MoE layer, 3 projections
    each; the families' first layer is dense but Qwen2-MoE's)."""
    _, ranks, _, _ = served
    cfg = MOE_CONFIGS[family]
    moe_layers = 2 - cfg.get("first_k_dense_replace",
                             cfg.get("moe_layer_start_index", 0))
    m = cfg["moe_intermediate_size"]
    ep = WORLDS[world]["mesh"].get("ep", 1)
    for r in ranks[world]:
        same, reads = r[f"ckpt_{family}"]
        assert same, (world, family)
        assert sorted(set(reads)) == [(m, 64), (64, m)], reads
        assert len(reads) == moe_layers * 3 * 4 // ep


# ------------------------------------------------------------- serving
def test_tp_ep_gateway_matches_the_jax_gateway(served):
    """A SequencedEngine over the tp x ep ranks behind the port's Gateway:
    greedy streams the JAX Gateway's over the JAX engine (logprobs within
    ATOL), every stream the port's direct tp x ep engine's, and every
    follower computed the same streams and counters."""
    _, ranks, refs, _ = served
    ranks = ranks["tp2ep2"]
    want = refs["tp2ep2"]["gateway"]
    got = ranks[0]["gateway"]["leader"]
    direct = ranks[0]["gateway_direct"]
    for rid in ("a", "b", "s"):
        st, toks, fin = got[rid]
        assert st == 200 and fin["finish_reason"] == "stop", rid
        assert (toks, fin["logprobs"]) == tuple(direct[rid]), rid
        if rid == "s":
            continue
        jst, jtoks, jfin = want[rid]
        assert jst == 200 and toks == jtoks, rid
        np.testing.assert_allclose(fin["logprobs"], jfin["logprobs"],
                                   atol=ATOL, rtol=0)
    lead = ranks[0]["gateway"]
    assert lead["seq"]["tp"] == 4 and len(lead["seq"]["pids"]) == 4
    for r in ranks[1:]:
        for rid in ("a", "b", "s"):
            assert r["gateway"]["keep"][rid] == got[rid][1], rid
        assert r["gateway"]["stats"] == lead["stats"]
        assert r["gateway"]["follow"]["stopped"]
        assert r["gateway_direct"] == direct


def test_replica_main_tp_ep_serves_a_plain_engines_streams(served):
    """Four rank processes under the launcher (tp 2 x ep 2), behind a
    FleetFrontend: the greedy streams are a plain ERNIE engine's from the
    same seed (logprobs within ATOL), the sampled one completes, and a
    SIGTERM drains the replica with every rank exiting 0."""
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.serving.fleet import replica_main as rm
    _, _, _, fleet = served
    assert "error" not in fleet, fleet.get("error")
    model = rm.build_model("ernie-tiny", "cpu", FLEET_SEED)
    eng = PagedEngine(model, **rm.engine_kw("ernie-tiny", 32))
    for r in fleet["reqs"]:
        eng.submit(r["request_id"], np.asarray(r["prompt"]),
                   **{k: v for k, v in r.items()
                      if k not in ("request_id", "prompt")})
    want = eng.run()
    assert len(fleet["seq"]["pids"]) == 4
    for r in fleet["reqs"]:
        rid = r["request_id"]
        st, toks, fin = fleet["streams"][rid]
        assert st == 200 and fin["finish_reason"] == "stop", rid
        assert len(toks) == 10
        if "temperature" in r:
            continue
        assert toks == want[rid], rid
        np.testing.assert_allclose(fin["logprobs"], eng.logprobs[rid],
                                   atol=ATOL, rtol=0)
    assert fleet["rc"] == 0


# ------------------------------------------------ in this process (no mesh)
def test_replica_main_takes_ep_and_the_moe_models(monkeypatch):
    from paddle_tpu_torch.serving.fleet import replica_main as rm
    assert {"ernie-tiny", "ernie45-21b-a3b"} <= set(rm.MODELS)
    kw = rm.engine_kw("ernie45-21b-a3b", 128)
    # whole-prompt prefill: the JAX engine cannot chunk an MoE model
    assert "chunk_prefill_tokens" not in kw and not kw.get(
        "enable_prefix_cache")
    with pytest.raises(SystemExit, match="--ep needs --tp"):
        rm.main(["--ep", "2", "--device", "cpu", "--model", "ernie-tiny"])


def test_process_manager_launches_tp_times_ep_ranks(monkeypatch):
    """``LocalProcessManager(tp=2, ep=2)`` starts the launcher with
    ``--nproc 4`` over ``--tp 2 --ep 2``; ep without tp is refused."""
    import subprocess
    from paddle_tpu_torch.serving.fleet import (FleetFrontend,
                                                LocalProcessManager)
    seen = {}

    class Stop(Exception):
        pass

    def popen(cmd, **kw):
        seen["cmd"] = cmd
        raise Stop
    monkeypatch.setattr(subprocess, "Popen", popen)
    fe = FleetFrontend([], name="tp-moe-cmd")
    mgr = LocalProcessManager(fe, model="ernie-tiny", device="cpu", tp=2,
                              ep=2)
    with pytest.raises(Stop):
        mgr.spawn()
    cmd = seen["cmd"]
    assert cmd[cmd.index("--nproc") + 1] == "4"
    assert cmd[cmd.index("--tp") + 1] == "2"
    assert cmd[cmd.index("--ep") + 1] == "2"
    with pytest.raises(ValueError, match="ep needs tp"):
        LocalProcessManager(fe, ep=2)


def test_loadgen_refuses_ep_in_process():
    from paddle_tpu_torch.serving import loadgen
    with pytest.raises(ValueError, match="in-process gateway"):
        loadgen.main(["--tp", "1", "--ep", "2", "--device", "cpu",
                      "--requests", "1", "--model", "ernie-tiny"])


def test_predictor_cast_model_generates_as_one_built_in_the_dtype():
    """``Predictor(Config().set_dtype("bfloat16"))`` on an fp32-built
    model: its caches take bf16, and generate() gives the tokens of the
    model built in bf16 with the same weights (an fp32 cache under bf16
    activations raised a dtype error)."""
    m = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    b = ptt.LlamaForCausalLM(ptt.llama_tiny(dtype=torch.bfloat16),
                             device="cpu")
    b.load_state_dict({k: v.to(torch.bfloat16) if v.is_floating_point()
                       else v for k, v in m.state_dict().items()})
    pred = ptt.Predictor(m, ptt.Config().set_dtype("bfloat16"),
                         device="cpu")
    ids = torch.from_numpy(np.random.RandomState(9).randint(1, 256, (2, 9)))
    assert pred.model.init_kv_caches(1, 4)[0][0].dtype == torch.bfloat16
    torch.testing.assert_close(pred.generate(ids, max_new_tokens=6),
                               ptt.generate(b, ids, max_new_tokens=6),
                               atol=0, rtol=0)
