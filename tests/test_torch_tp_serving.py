"""The port's tensor-parallel serving against the JAX package's on the same
mesh, in spawned gloo worlds on the CPU (fp32).

A world of 2 ranks runs the JAX package's ``_dryrun_paged_tp`` scenario
(``__graft_entry__.py``: a request that finishes and parks its prefix, a
second that adopts it, a sampled one) through the port's ``PagedEngine``
on {"tp": 2}, with plain and speculative ticks; ``generate()`` greedy,
sampled and beam; ``fuse_projections`` on Llama and on Qwen2's biased
q/k/v; ``Predictor`` at int8 and int4 (each rank holding half of every
projection's codes); the quantized tp layers (the JAX
``test_quantized_tp_matches_dense_on_mesh`` case, a row rank's offset
into the whole scales table, the ``ValueError`` of a row split that cuts a
128-row block); an MoE model served at tp 2 (its tokens the whole
model's); and the refusals (a gateway over a tp engine with no
sequencer, ranks whose schedules part). A world of 4 runs one kv head a
rank and the fused interleave at T = 4. The JAX side runs in this process
on ``jax.devices()[:tp]`` while the worlds run. Weights cross from the JAX
models as numpy."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.qwen2 import Qwen2ForCausalLM as JaxQwen2
from paddle_tpu.models.qwen2 import qwen2_tiny as jax_qwen2_tiny
from paddle_tpu.nn import fuse as jfuse
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.quant.weight_only import linear_quant_meta as jax_quant_meta
from paddle_tpu.quant import quantize_model as jax_quantize_model
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.nn import fuse as tfuse
from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
from paddle_tpu_torch.quant import QuantizedLinear, linear_quant_meta
from paddle_tpu_torch.quant.weight_only import quantize_blockwise
from torch_dist_workers import start_world

# the _dryrun_paged_tp config: 8 query heads over 4 kv heads
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4)
# widths whose projections quantize at tp 2 (in_features / 2 a multiple
# of the 128-row scale block: o_proj 256 / 2, down_proj 512 / 2)
QCFG = dict(CFG, hidden_size=256, intermediate_size=512)
# fp32 logits of sums of up to 512 terms, the tp partial sums added in
# another order than the JAX program's
ATOL = 1e-4


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
def _mesh(tp):
    jenv.init_parallel_env({"tp": tp}, devices=jax.devices()[:tp])
    try:
        yield
    finally:
        jenv.init_parallel_env({})


def _state(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def _jax_llama(cfg, seed):
    pt.seed(seed)
    return JaxLlama(jax_llama_tiny(**cfg))


def _jax_qwen(seed):
    pt.seed(seed)
    return JaxQwen2(jax_qwen2_tiny())


def _payload():
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 256, 16).tolist()
    return dict(cfg=CFG, params=_state(_jax_llama(CFG, 0)), qcfg=QCFG,
                qparams=_state(_jax_llama(QCFG, 1)), qwen_cfg={},
                qwen_params=_state(_jax_qwen(2)),
                prompts={"a": [shared + [3]], "b": [shared + [5, 7]]},
                sampled=rs.randint(1, 256, (1, 7)),
                qids=rs.randint(1, 256, (2, 9)),
                qx=rs.randn(3, 128).astype(np.float32))


def _jax_forward(m, ids):
    fn, params = m.functional()
    return np.asarray(jax.jit(fn)(params, jnp.asarray(ids)))


def _jax_tp2(p):
    """The JAX references on {"tp": 2}."""
    ref = {}
    with _mesh(2):
        m = _jax_llama(CFG, 0)
        jax_shard_layer(m, fsdp_min_size=1 << 30)
        eng = JaxEngine(m, max_slots=2, num_blocks=24, block_size=8,
                        max_blocks_per_seq=6, prefill_buckets=(16,),
                        chunk_prefill_tokens=8, enable_prefix_cache=True)
        eng.submit("a", np.asarray(p["prompts"]["a"]), max_new_tokens=8)
        out = eng.run()
        eng.submit("b", np.asarray(p["prompts"]["b"]), max_new_tokens=8)
        eng.submit("s", np.asarray(p["sampled"]), max_new_tokens=8,
                   temperature=0.8, top_p=0.9, seed=5)
        out.update(eng.run())
        ref["engine"] = {k: [int(t) for t in v] for k, v in out.items()}
        ref["engine_hits"] = eng.stats["prefix_hit_tokens"]
        for k, ids in p["prompts"].items():
            ref[f"generate_{k}"] = np.asarray(m.generate(
                jnp.asarray(ids), max_new_tokens=8, temperature=0.0))
        ids = np.asarray(p["prompts"]["b"])
        ref["logits"] = _jax_forward(m, ids)
        ref["beam"] = np.asarray(m.generate(jnp.asarray(ids),
                                            max_new_tokens=6, num_beams=3))
        fused = _jax_llama(CFG, 0)
        jfuse.fuse_projections(fused)
        ref["fused_qkv"] = np.asarray(
            fused.model.layers[0].self_attn.qkv_proj.weight)
        jax_shard_layer(fused, fsdp_min_size=1 << 30)
        ref["fused_logits"] = _jax_forward(fused, ids)
        q = _jax_qwen(2)
        jfuse.fuse_projections(q)
        ref["qwen_bias"] = np.asarray(
            q.model.layers[0].self_attn.qkv_proj.bias)
        jax_shard_layer(q, fsdp_min_size=1 << 30)
        ref["qwen_logits"] = _jax_forward(q, ids)
        for bits in (8, 4):
            qm = _jax_llama(QCFG, 1)
            jax_quantize_model(qm, bits=bits, skip=["lm_head", "embed"])
            jax_shard_layer(qm, fsdp_min_size=1 << 30)
            ref[f"q{bits}_logits"] = _jax_forward(qm, p["qids"])
            ref[f"q{bits}_greedy"] = np.asarray(qm.generate(
                jnp.asarray(p["qids"]), max_new_tokens=6, temperature=0.0))
    return ref


def _jax_tp4(p):
    with _mesh(4):
        m = _jax_llama(CFG, 0)
        jfuse.fuse_projections(m)
        qkv = np.asarray(m.model.layers[0].self_attn.qkv_proj.weight)
        jax_shard_layer(m, fsdp_min_size=1 << 30)
        ids = jnp.asarray(p["prompts"]["b"])
        return dict(fused_qkv=qkv, greedy=np.asarray(
            m.generate(ids, max_new_tokens=8, temperature=0.0)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    p = _payload()
    w2 = start_world("tp_serving", 2, tmp, p, timeout_s=420)
    w4 = start_world("tp4_serving", 4, tmp, p, timeout_s=420)
    with _no_cache_writes():
        ref2, ref4 = _jax_tp2(p), _jax_tp4(p)
    return p, w2.result(), w4.result(), ref2, ref4


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


# --------------------------------------------------------------- tp 2
def test_paged_dryrun_scenario_matches_jax_engine_at_tp2(worlds):
    p, ranks, _, ref, _ = worlds
    for tag in ("paged", "spec"):
        got = ranks[0][f"{tag}_streams"]
        for rid in ("a", "b"):
            assert got[rid] == ref["engine"][rid], (tag, rid)
            want = ref[f"generate_{rid}"][0, len(p["prompts"][rid][0]):]
            assert got[rid] == want.tolist(), (tag, rid)
        assert len(got["s"]) == 8
        assert ranks[0][f"{tag}_stats"]["prefix_hit_tokens"] > 0
        # every rank's streams, the sampled one too, and its schedule
        _same_on_every_rank(ranks, f"{tag}_streams")
        _same_on_every_rank(ranks, f"{tag}_stats")
        assert ranks[0][f"{tag}_digests"] > 0
    assert ref["engine_hits"] > 0
    assert ranks[0]["spec_stats"]["spec_proposed"] > 0
    # a sampled spec stream is the spec-off one, on every rank
    assert ranks[0]["spec_streams"]["s"] == ranks[0]["paged_streams"]["s"]


def test_each_rank_holds_its_heads_of_the_caches(worlds):
    _, ranks, ranks4, _, _ = worlds
    for r in ranks:
        assert r["cache_heads"] == CFG["num_key_value_heads"] // 2
        assert r["paged_pools"][2] == r["spec_pools"][2] == 2
        assert r["q_local"] == (8 * 8 // 2, 64)   # 4 of 8 heads of 8
        # bound once: the compute tensor is the local shard itself, and
        # the shard owns its storage (the full tensor was dropped)
        assert r["alias"]
        assert r["own_storage"]
    for r in ranks4:
        assert r["cache_heads"] == r["pools"][2] == 1


def test_sharded_build_is_the_whole_model_sharded(worlds):
    _, ranks, _, _, _ = worlds
    for r in ranks:
        # decoder layers cut as drawn, the embedding left to shard_layer
        assert r["built_sharded"] == (True, False)
        assert r["built_same"] and r["built_logits_same"]


def test_generate_greedy_and_beam_match_jax_at_tp2(worlds):
    _, ranks, _, ref, _ = worlds
    np.testing.assert_allclose(ranks[0]["logits"], ref["logits"], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ranks[0]["greedy"], ref["generate_b"])
    np.testing.assert_array_equal(ranks[0]["beam"], ref["beam"])
    for key in ("logits", "greedy", "beam", "sampled"):
        _same_on_every_rank(ranks, key)


def test_no_eager_collective_in_serving_programs(worlds):
    """generate(), beam, the engine's ticks and prefills reach only the
    in-region collectives: an eager facade (a retry and a stream sync)
    would break a captured program."""
    _, ranks, _, _, _ = worlds
    for r in ranks:
        assert r["eager_serving"] == []


def test_eager_collective_refuses_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        C.eager_all_reduce(torch.ones(2), group="tp")


def test_fused_tp2_matches_jax_fused_on_mesh(worlds):
    _, ranks, _, ref, _ = worlds
    full = ref["fused_qkv"]                     # [h, out], interleaved
    per = full.shape[1] // 2
    for t, r in enumerate(ranks):
        np.testing.assert_array_equal(r["fused_qkv_local"],
                                      full[:, t * per:(t + 1) * per].T)
        np.testing.assert_allclose(r["fused_logits"], ref["fused_logits"],
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(ranks[0]["fused_logits"], ranks[0]["logits"],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ranks[0]["fused_greedy"],
                                  ref["generate_b"])


def test_qwen2_biases_fuse_at_tp2(worlds):
    _, ranks, _, ref, _ = worlds
    per = ref["qwen_bias"].shape[0] // 2
    for t, r in enumerate(ranks):
        np.testing.assert_array_equal(r["qwen_fused_bias"],
                                      ref["qwen_bias"][t * per:(t + 1) * per])
        np.testing.assert_allclose(r["qwen_fused_logits"],
                                   ref["qwen_logits"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_predictor_quantized_at_tp2_matches_jax(worlds, bits):
    _, ranks, _, ref, _ = worlds
    r = ranks[0]
    np.testing.assert_allclose(r[f"q{bits}_logits"], ref[f"q{bits}_logits"],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(r[f"q{bits}_greedy"],
                                  ref[f"q{bits}_greedy"])
    # half of each projection's codes a rank; the row layer's scales whole
    h, f = QCFG["hidden_size"], QCFG["intermediate_size"]
    rows = 1 if bits == 8 else 2
    assert r[f"q{bits}_codes"] == {
        "q_proj": (h // rows, 8 * 32 // 2), "o_proj": (h // 2 // rows, h),
        "o_scales": (h // 128, h), "down_proj": (f // 2 // rows, h)}
    _same_on_every_rank(ranks, f"q{bits}_greedy")
    if bits == 8:
        np.testing.assert_allclose(r["q8_fused_logits"], r["q8_logits"],
                                   atol=ATOL, rtol=0)


def test_quantized_tp_matches_dense_on_mesh(worlds):
    """The JAX test_quant case at tp 2: a gathered column layer quantized
    whole, then sharded, equals the dense quantized layer, each rank
    holding half of its codes."""
    _, ranks, _, _, _ = worlds
    for r in ranks:
        ref, got, shape = r["col_dense"]
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert shape == (128, 32)


@pytest.mark.parametrize("bits", [8, 4])
def test_row_rank_reads_its_scale_blocks(worlds, bits):
    _, ranks, _, _, _ = worlds
    for r in ranks:
        ref, got, codes, scales, meta = r[f"row{bits}"]
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert codes == (128 // (1 if bits == 8 else 2), 64)
        assert scales == (2, 64)              # the whole table
        assert meta == ((None, "tp"), None, None, None)
        # quantized after sharding: the rank's rows of the whole codes,
        # and the whole scales table
        assert r[f"row{bits}_after"] == (True, True)


def test_row_split_off_the_scale_blocks_raises(worlds):
    _, ranks, _, _, _ = worlds
    for r in ranks:
        assert "128-row scale block" in r["row_indivisible"]
        assert "scale blocks" in r["row_indivisible_after"]


def test_refusals_at_tp2(worlds):
    _, ranks, _, _, _ = worlds
    # an MoE model serves at tp 2: generate() and the engine give the
    # whole model's tokens (two tokens, dropless at one row)
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM, qwen2_moe_tiny
    moe = Qwen2MoeForCausalLM(qwen2_moe_tiny(), device="cpu")
    want = ptt.generate(moe, torch.ones(1, 4, dtype=torch.int64),
                        max_new_tokens=2).numpy()
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["moe_generate"], want)
        assert r["moe_engine"] == want[0, 4:].tolist()
        # a gateway over a bare tp engine is refused; over rank 0's
        # sequenced engine it builds, over a follower's it is refused
        assert "no sequencer" in r["gateway"]
        if i == 0:
            assert r["gateway_sequenced"] == "built"
        else:
            assert "follower" in r["gateway_sequenced"]
        # ranks that submit differently fail the schedule digest at once
        assert "parted" in r["diverge"]


# --------------------------------------------------------------- tp 4
def test_tp4_one_kv_head_a_rank_matches_jax(worlds):
    p, _, ranks, _, ref = worlds
    want = ref["greedy"]
    per = ref["fused_qkv"].shape[1] // 4
    for t, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["fused_qkv_local"], ref["fused_qkv"][:, t * per:(t + 1) * per].T)
        np.testing.assert_array_equal(r["greedy"], want)
        np.testing.assert_array_equal(r["fused_greedy"], want)
        assert r["paged"] == want[0, len(p["prompts"]["b"][0]):].tolist()


# -------------------------------------------- in this process (no mesh)
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fused_weight_is_the_jax_fused_weight(tp):
    """The port's interleave (along dim 0 of [out, in] weights) is the
    JAX one (along dim 1 of [in, out]) transposed, at tp 1, 2 and 4."""
    rs = np.random.RandomState(tp)
    ws = [rs.randn(64, n).astype(np.float32) for n in (64, 32, 32)]
    want = np.asarray(jfuse._interleave([jnp.asarray(w) for w in ws], tp))
    got = tfuse._interleave([torch.from_numpy(w.T) for w in ws], tp, 0)
    np.testing.assert_array_equal(got.numpy(), want.T)
    bs = [rs.randn(n).astype(np.float32) for n in (64, 32, 32)]
    np.testing.assert_array_equal(
        tfuse._interleave_bias([torch.from_numpy(b) for b in bs],
                               tp).numpy(),
        np.asarray(jfuse._interleave_bias([jnp.asarray(b) for b in bs], tp)))


def test_fused_model_loads_jax_fused_state_and_matches():
    """A fused JAX model's qkv_proj / gate_up_proj keys load into a fused
    port model; logits equal the unfused ones."""
    jm = _jax_llama(dict(CFG, attention_bias=True), 4)
    ids = np.random.RandomState(4).randint(0, 256, (2, 12))
    ref = np.asarray(jm(jnp.asarray(ids)))
    jfuse.fuse_projections(jm)
    tm = tfuse.fuse_projections(ptt.LlamaForCausalLM(
        ptt.llama_tiny(**CFG, attention_bias=True), device="cpu"))
    ptt.load_jax_state_dict(tm, _state(jm))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    tfuse.fuse_projections(tm)            # idempotent
    with torch.no_grad():
        np.testing.assert_array_equal(tm(torch.from_numpy(ids)).numpy(), got)


def test_attention_only_fusion_keeps_the_mlp():
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (1, 9)))
    with torch.no_grad():
        ref = tm(ids)
    tfuse.fuse_projections(tm, mlp=False)
    layer = tm.model.layers[0]
    assert hasattr(layer.self_attn, "qkv_proj")
    assert hasattr(layer.mlp, "gate_proj")
    with torch.no_grad():
        torch.testing.assert_close(tm(ids), ref, atol=ATOL, rtol=0)


def test_fuse_tp_indivisible_heads_raises(monkeypatch):
    """kv heads 2 over tp 4: ValueError before anything changes."""
    monkeypatch.setattr(tfuse, "axis_degree", lambda axis: 4)
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tfuse.fuse_projections(tm)
    assert hasattr(tm.model.layers[0].self_attn, "q_proj")
    assert hasattr(tm.model.layers[0].mlp, "gate_proj")


def test_linear_quant_meta_is_the_jax_tuple_for_every_projection():
    jm = JaxLlama(jax_llama_tiny())
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    jmods = dict(jm.named_sublayers())
    n = 0
    for name, mod in tm.named_modules():
        if not isinstance(mod, ptt.nn.Linear):
            continue
        wp, bp, ia, oa = linear_quant_meta(mod)
        jwp, jbp, jia, joa = jax_quant_meta(jmods[name])
        assert (tuple(reversed(wp)) if wp else None,
                bp, ia, oa) == (jwp, jbp, jia, joa), name
        n += 1
    assert n == 2 * 7 + 1


def test_quantized_partition_fields_follow_the_source():
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear)
    gen = ptt.make_generator(0, "cpu")
    col = ColumnParallelLinear(128, 64, gather_output=False, generator=gen,
                               device="cpu")
    q = QuantizedLinear.from_linear(col, bits=8)
    assert q.weight_partition == ("tp", None)
    assert q.output_parallel_axis == "tp"
    assert q.buffer_partitions() == {"qweight": (None, "tp"),
                                     "scales": (None, "tp"),
                                     "bias": ("tp",)}
    row = RowParallelLinear(256, 64, generator=gen, device="cpu")
    qr = QuantizedLinear.from_linear(row, bits=4)
    assert qr.weight_partition == (None, "tp")
    assert qr.input_parallel_axis == "tp"
    assert qr.buffer_partitions() == {"qweight": ("tp", None),
                                      "scales": (None, None)}


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_wrapper_reads_a_row_ranks_scale_blocks(bits):
    """The wrapper at a block offset into the whole table is the plain
    version over that rank's blocks."""
    rs = np.random.RandomState(bits)
    w = torch.from_numpy(rs.randn(512, 128).astype(np.float32))
    codes, scales = quantize_blockwise(w, bits)
    x = torch.from_numpy(rs.randn(4, 256).astype(np.float32))
    rows = 256 if bits == 8 else 128
    for rank in (0, 1):
        mine = codes[rank * rows:(rank + 1) * rows]
        got = quant_matmul(x, mine, scales, bits, block_offset=2 * rank)
        want = quant_matmul_plain(x, mine, scales[2 * rank:2 * rank + 2],
                                  bits)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="outside"):
        quant_matmul(x, codes[:rows], scales, bits, block_offset=3)


def test_llama3_70b_preset_is_the_jax_one():
    from paddle_tpu.models.llama import llama3_70b as jax_70b
    want, got = jax_70b(), ptt.llama3_70b()
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "max_position_embeddings",
              "rope_theta", "rms_norm_eps"):
        assert getattr(got, f) == getattr(want, f), f
