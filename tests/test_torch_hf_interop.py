"""The port's Llama HF interop against the JAX package's: a seeded HF
checkpoint directory (``config.json`` and safetensors, written in the
test with the ``safetensors`` package) loads through both
``from_pretrained`` into the same parameters (bit for bit, fp32) and the
same logits (within 1e-5 plus 1e-5 of each logit, fp32 CPU: logits reach
~15 here, and sums over 64-128 products in another order move their last
bits), for tied embeddings, rope_scaling
llama3 and sharded index files; the port's own safetensors reader gives
what the JAX reader gives; ``to_hf_state_dict`` round-trips."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.models import hf_interop as jax_hf
from paddle_tpu_torch.models import hf_interop

safetensors_numpy = pytest.importorskip("safetensors.numpy")

TOL_LOGITS = 1e-5    # absolute, and the same relative


def _hf_config(**kw):
    cfg = dict(model_type="llama", vocab_size=128, hidden_size=64,
               intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=256, rms_norm_eps=1e-5,
               rope_theta=10000.0, tie_word_embeddings=False,
               torch_dtype="float32")
    cfg.update(kw)
    return cfg


def _hf_weights(cfg, seed):
    """HF names and [out, in] layout, seeded."""
    rs = np.random.RandomState(seed)
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    d = h // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * d
    w = {"model.embed_tokens.weight": rs.randn(v, h),
         "model.norm.weight": 1 + 0.1 * rs.randn(h)}
    if not cfg["tie_word_embeddings"]:
        w["lm_head.weight"] = rs.randn(v, h) * 0.1
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w.update({
            p + "self_attn.q_proj.weight": rs.randn(h, h) * 0.1,
            p + "self_attn.k_proj.weight": rs.randn(kv, h) * 0.1,
            p + "self_attn.v_proj.weight": rs.randn(kv, h) * 0.1,
            p + "self_attn.o_proj.weight": rs.randn(h, h) * 0.1,
            p + "mlp.gate_proj.weight": rs.randn(f, h) * 0.1,
            p + "mlp.up_proj.weight": rs.randn(f, h) * 0.1,
            p + "mlp.down_proj.weight": rs.randn(h, f) * 0.1,
            p + "input_layernorm.weight": 1 + 0.1 * rs.randn(h),
            p + "post_attention_layernorm.weight": 1 + 0.1 * rs.randn(h),
            p + "self_attn.rotary_emb.inv_freq": rs.rand(d // 2)})
    return {k: a.astype(np.float32) for k, a in w.items()}


def _write(dirpath, cfg, weights, shards=1):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(cfg, f)
    keys = sorted(weights)
    if shards == 1:
        safetensors_numpy.save_file(
            weights, os.path.join(dirpath, "model.safetensors"))
        return str(dirpath)
    names = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
             for i in range(shards)]
    wm = {k: names[i * shards // len(keys)] for i, k in enumerate(keys)}
    for name in names:
        safetensors_numpy.save_file(
            {k: weights[k] for k in keys if wm[k] == name},
            os.path.join(dirpath, name))
    with open(os.path.join(dirpath, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"weight_map": wm}, f)
    return str(dirpath)


def _assert_same_model(jax_model, port_model, vocab):
    """Parameters bit for bit (the JAX layout through the port's
    ``jax_state_dict``) and logits within TOL_LOGITS."""
    from paddle_tpu_torch.convert import jax_state_dict
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = {k: v.numpy() for k, v in jax_state_dict(port_model).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ids = np.random.RandomState(1).randint(0, vocab, (2, 40))
    ref = np.asarray(jax_model(jnp.asarray(ids)))
    with torch.no_grad():
        out = port_model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL_LOGITS, rtol=TOL_LOGITS)


@pytest.mark.parametrize("case", ["plain", "tied", "rope-llama3", "sharded",
                                  "qwen2-bias"])
def test_from_pretrained_matches_jax(tmp_path, case):
    cfg = _hf_config()
    if case == "tied":
        cfg.update(tie_word_embeddings=True)
    if case == "rope-llama3":
        cfg.update(rope_theta=500000.0, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 16})
    if case == "qwen2-bias":
        cfg.update(model_type="qwen2")
    weights = _hf_weights(cfg, seed=7)
    if case == "qwen2-bias":
        rs = np.random.RandomState(8)
        for i in range(cfg["num_hidden_layers"]):
            for p, n in (("q", 64), ("k", 32), ("v", 32)):
                weights[f"model.layers.{i}.self_attn.{p}_proj.bias"] = \
                    rs.randn(n).astype(np.float32)
    d = _write(tmp_path / case, cfg, weights,
               shards=3 if case == "sharded" else 1)
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    assert tm.config.tie_word_embeddings == (case == "tied")
    assert tm.config.attention_bias == (case == "qwen2-bias")
    _assert_same_model(jm, tm, cfg["vocab_size"])


def test_reader_gives_what_the_jax_reader_gives(tmp_path):
    """F32, F16, I64 and BF16 tensors: the same values and dtypes, but
    BF16, which the port gives as float32 (numpy has no bf16; the JAX
    reader gives ml_dtypes' bf16 or, by the safetensors version, float32
    through torch) with the same values."""
    import safetensors.torch
    rs = np.random.RandomState(9)
    path = str(tmp_path / "mixed.safetensors")
    safetensors.torch.save_file({
        "f32": torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rs.randn(4).astype(np.float16)),
        "i64": torch.from_numpy(rs.randint(0, 99, (2, 2))),
        "bf16": torch.from_numpy(rs.randn(6, 2).astype(np.float32))
        .to(torch.bfloat16),
        "empty": torch.zeros(0, 3)}, path)
    got = hf_interop._load_safetensors_file(path)
    want = jax_hf._load_safetensors_file(path)
    assert set(got) == set(want)
    for k in want:
        ref = np.asarray(want[k])
        if k == "bf16":
            assert got[k].dtype == np.float32
            ref = ref.astype(np.float32)
        assert got[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(got[k], ref)


def test_bf16_checkpoint_loads_in_the_model_dtype(tmp_path):
    """A bf16 checkpoint (``torch_dtype`` bfloat16) loads into a bf16
    model whose parameters are the file's bf16 values, bit for bit, and
    equal to the JAX package's."""
    import safetensors.torch
    cfg = _hf_config(torch_dtype="bfloat16")
    weights = _hf_weights(cfg, seed=10)
    d = tmp_path / "bf16"
    d.mkdir()
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    tw = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          weights.items()}
    safetensors.torch.save_file(tw, str(d / "model.safetensors"))
    tm = hf_interop.from_pretrained(str(d), device="cpu")
    assert tm.config.dtype == torch.bfloat16
    got = tm.state_dict()
    for k, v in tw.items():
        if k.endswith("inv_freq"):
            continue
        assert torch.equal(got[k], v), k
    jm = jax_hf.from_pretrained(str(d))
    for k, v in jm.state_dict().items():
        src = torch.from_numpy(np.asarray(v, np.float32))
        if v.ndim == 2 and not k.endswith("embed_tokens.weight"):
            src = src.T
        assert torch.equal(got[k].float(), src), k


def test_to_hf_state_dict_round_trips(tmp_path):
    cfg = _hf_config()
    weights = _hf_weights(cfg, seed=11)
    d = _write(tmp_path / "rt", cfg, weights)
    tm = hf_interop.from_pretrained(d, device="cpu")
    back = hf_interop.to_hf_state_dict(tm)
    want = {k: v for k, v in weights.items() if not k.endswith("inv_freq")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jm = jax_hf.from_pretrained(d)
    jback = jax_hf.to_hf_state_dict(jm)
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(jback[k]))
    # the converters are each other's inverse, and the JAX package's
    conv = hf_interop.convert_hf_state_dict(weights, tm.config, "llama")
    jconv = jax_hf.convert_hf_state_dict(weights, jm.config, "llama")
    assert set(conv) == set(jconv)
    for k in jconv:
        np.testing.assert_array_equal(conv[k], jconv[k])


def test_strictness_and_unknown_models(tmp_path):
    cfg = _hf_config()
    weights = _hf_weights(cfg, seed=12)
    weights.pop("model.layers.1.mlp.up_proj.weight")
    d = _write(tmp_path / "missing", cfg, weights)
    with pytest.raises(KeyError, match="missing"):
        hf_interop.from_pretrained(d, device="cpu")
    with pytest.warns(UserWarning, match="random init"):
        hf_interop.from_pretrained(d, device="cpu", strict=False)
    extra = dict(_hf_weights(cfg, seed=12), **{
        "model.layers.0.mlp.extra.weight": np.zeros((2, 2), np.float32)})
    d = _write(tmp_path / "extra", cfg, extra)
    with pytest.raises(KeyError, match="not in model"):
        hf_interop.from_pretrained(d, device="cpu")
    d = _write(tmp_path / "gpt2", dict(cfg, model_type="gpt2"), {})
    with pytest.raises(ValueError, match="gpt2"):
        hf_interop.from_pretrained(d, device="cpu")


def test_greedy_generate_from_pretrained_matches_jax(tmp_path):
    """The loaded model serves: greedy ``generate`` equals the JAX
    package's on the same checkpoint."""
    from paddle_tpu.generation import GenerationConfig as JaxGenConfig
    from paddle_tpu.generation import generate as jax_generate
    cfg = _hf_config()
    d = _write(tmp_path / "gen", cfg, _hf_weights(cfg, seed=13))
    jm = jax_hf.from_pretrained(d)
    tm = ptt.from_pretrained(d, device="cpu")
    ids = np.random.RandomState(2).randint(0, 128, (2, 8)).astype(np.int32)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=10)))
    got = ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------- the MoE families
MOE_CONFIGS = {
    "qwen2_moe": dict(
        model_type="qwen2_moe", num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, shared_expert_intermediate_size=48,
        norm_topk_prob=True, decoder_sparse_step=1, rms_norm_eps=1e-6),
    "ernie4_5_moe": dict(
        model_type="ernie4_5_moe", moe_num_experts=4, moe_k=2,
        moe_intermediate_size=32, moe_num_shared_experts=2,
        moe_layer_start_index=1, use_bias=False),
    "deepseek_v2": dict(
        model_type="deepseek_v2", n_routed_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
        first_k_dense_replace=1, q_lora_rank=None, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        topk_method="group_limited_greedy", n_group=2, topk_group=1,
        rope_scaling=dict(type="yarn", factor=4.0,
                          original_max_position_embeddings=64,
                          mscale=0.707, mscale_all_dim=0.707)),
    "deepseek_v3": dict(
        model_type="deepseek_v3", n_routed_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
        first_k_dense_replace=1, q_lora_rank=24, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_group=2, topk_group=1, routed_scaling_factor=2.5,
        rope_scaling=dict(type="yarn", factor=4.0,
                          original_max_position_embeddings=64,
                          mscale=1.0, mscale_all_dim=1.0)),
}


def _moe_weights(cfg, seed):
    """An HF checkpoint of ``cfg``'s family, seeded: Llama names for the
    embeddings, norms and dense layers, the family's names for the
    attention, router, experts, shared experts and score bias."""
    rs = np.random.RandomState(seed)
    mt = cfg["model_type"]
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    nh = cfg["num_attention_heads"]
    E = cfg.get("num_experts") or cfg.get("moe_num_experts") or \
        cfg.get("n_routed_experts")
    m = cfg["moe_intermediate_size"]
    first_dense = cfg.get("first_k_dense_replace",
                          cfg.get("moe_layer_start_index", 0))

    def lin(o, i):
        return rs.randn(o, i) * 0.1

    w = {"model.embed_tokens.weight": rs.randn(v, h),
         "model.norm.weight": 1 + 0.1 * rs.randn(h),
         "lm_head.weight": lin(v, h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w[p + "input_layernorm.weight"] = 1 + 0.1 * rs.randn(h)
        w[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rs.randn(h)
        if mt.startswith("deepseek"):
            qd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
            r = cfg["kv_lora_rank"]
            a = p + "self_attn."
            if cfg["q_lora_rank"] is None:
                w[a + "q_proj.weight"] = lin(nh * qd, h)
            else:
                w[a + "q_a_proj.weight"] = lin(cfg["q_lora_rank"], h)
                w[a + "q_a_layernorm.weight"] = \
                    1 + 0.1 * rs.randn(cfg["q_lora_rank"])
                w[a + "q_b_proj.weight"] = lin(nh * qd, cfg["q_lora_rank"])
            w[a + "kv_a_proj_with_mqa.weight"] = lin(
                r + cfg["qk_rope_head_dim"], h)
            w[a + "kv_a_layernorm.weight"] = 1 + 0.1 * rs.randn(r)
            w[a + "kv_b_proj.weight"] = lin(
                nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]), r)
            w[a + "o_proj.weight"] = lin(h, nh * cfg["v_head_dim"])
        else:
            d = h // nh
            kv = cfg["num_key_value_heads"] * d
            for n, o in (("q", h), ("k", kv), ("v", kv)):
                w[p + f"self_attn.{n}_proj.weight"] = lin(o, h)
                if mt == "qwen2_moe":
                    w[p + f"self_attn.{n}_proj.bias"] = 0.1 * rs.randn(o)
            w[p + "self_attn.o_proj.weight"] = lin(h, h)
        mlp = p + "mlp."
        if i < first_dense:
            w.update({mlp + "gate_proj.weight": lin(f, h),
                      mlp + "up_proj.weight": lin(f, h),
                      mlp + "down_proj.weight": lin(h, f)})
            continue
        w[mlp + "gate.weight"] = lin(E, h)
        for e in range(E):
            x = f"{mlp}experts.{e}."
            w.update({x + "gate_proj.weight": lin(m, h),
                      x + "up_proj.weight": lin(m, h),
                      x + "down_proj.weight": lin(h, m)})
        if mt == "qwen2_moe":
            sm = cfg["shared_expert_intermediate_size"]
            shared = mlp + "shared_expert."
            w[mlp + "shared_expert_gate.weight"] = lin(1, h)
        else:
            sm = m * (cfg.get("n_shared_experts")
                      or cfg.get("moe_num_shared_experts"))
            shared = mlp + "shared_experts."
        w.update({shared + "gate_proj.weight": lin(sm, h),
                  shared + "up_proj.weight": lin(sm, h),
                  shared + "down_proj.weight": lin(h, sm)})
        if mt == "ernie4_5_moe":
            w[mlp + "moe_statics.e_score_correction_bias"] = \
                0.1 * rs.randn(1, E)
        if mt == "deepseek_v3":
            w[mlp + "gate.e_score_correction_bias"] = 0.1 * rs.randn(E)
    return {k: a.astype(np.float32) for k, a in w.items()}


def _write_experts_split(dirpath, cfg, weights):
    """Two shards and an index; each MoE layer's even experts in the
    first shard and its odd ones in the second."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(cfg, f)
    names = ["model-00001-of-00002.safetensors",
             "model-00002-of-00002.safetensors"]
    wm = {}
    for i, k in enumerate(sorted(weights)):
        m = hf_interop._MOE_EXPERT.match(k)
        wm[k] = names[int(m.group(2)) % 2 if m else i % 2]
    for name in names:
        safetensors_numpy.save_file(
            {k: weights[k] for k in weights if wm[k] == name},
            os.path.join(dirpath, name))
    with open(os.path.join(dirpath, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"weight_map": wm}, f)
    return str(dirpath)


@pytest.mark.parametrize("family", list(MOE_CONFIGS))
def test_moe_from_pretrained_matches_jax(tmp_path, family):
    """Experts split across two shards: the port fills each stacked
    tensor expert by expert as the shards arrive, the JAX package merges
    the checkpoint first; the same parameters bit for bit and the same
    logits."""
    cfg = _hf_config(**MOE_CONFIGS[family])
    d = _write_experts_split(tmp_path / family, cfg,
                             _moe_weights(cfg, seed=14))
    jcls, jcfg, jmt = jax_hf.config_from_hf(d)
    tcls, tcfg, tmt = hf_interop.config_from_hf(d)
    assert (tcls.__name__, tmt) == (jcls.__name__, jmt)
    for f in jcfg.__dataclass_fields__:
        if f != "dtype":
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    _assert_same_model(jm, tm, cfg["vocab_size"])
    # the whole-checkpoint converter stacks what from_pretrained filled
    conv = hf_interop.convert_hf_state_dict(
        hf_interop.load_hf_checkpoint(d), tcfg, family)
    jconv = jax_hf.convert_hf_state_dict(
        jax_hf.load_hf_checkpoint(d), jcfg, family)
    assert set(conv) == set(jconv)
    for k in jconv:
        np.testing.assert_array_equal(conv[k], np.asarray(jconv[k]))


def test_moe_missing_expert_raises(tmp_path):
    cfg = _hf_config(**MOE_CONFIGS["qwen2_moe"])
    weights = _moe_weights(cfg, seed=15)
    for p in ("gate", "up", "down"):
        weights.pop(f"model.layers.1.mlp.experts.3.{p}_proj.weight")
    d = _write_experts_split(tmp_path / "gap", cfg, weights)
    with pytest.raises(KeyError, match="missing experts"):
        hf_interop.from_pretrained(d, device="cpu")


def test_qwen2_loads_as_qwen2_and_variants_raise_as_in_jax(tmp_path):
    d = _write(tmp_path / "q", _hf_config(model_type="qwen2"),
               _hf_weights(_hf_config(), seed=16))
    cls, cfg, _ = hf_interop.config_from_hf(d)
    assert cls is ptt.models.Qwen2ForCausalLM
    assert isinstance(cfg, ptt.models.Qwen2Config)
    bad = {
        "sparse-step": dict(MOE_CONFIGS["qwen2_moe"], decoder_sparse_step=2),
        "topk-method": dict(MOE_CONFIGS["deepseek_v2"],
                            topk_method="noaux_tc"),
        "layer-freq": dict(MOE_CONFIGS["deepseek_v2"], moe_layer_freq=2),
        "rope": dict(MOE_CONFIGS["deepseek_v2"],
                     rope_scaling=dict(type="linear", factor=2.0)),
        "rotate-half": dict(MOE_CONFIGS["deepseek_v3"],
                            rope_interleave=False)}
    for name, over in bad.items():
        d = _write(tmp_path / name, _hf_config(**over), {})
        with pytest.raises(ValueError) as ref:
            jax_hf.config_from_hf(d)
        with pytest.raises(ValueError) as got:
            hf_interop.config_from_hf(d)
        assert str(got.value) == str(ref.value), name
