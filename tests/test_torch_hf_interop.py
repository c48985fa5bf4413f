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
