"""The port's HF interop for the GPT-2, BERT and ERNIE families against the
JAX package's: seeded HF-layout checkpoints (``config.json`` and
safetensors, written in the test from seeded numpy with the
``safetensors`` package) load through both ``from_pretrained`` into the
same parameters (bit for bit, fp32, through the port's
``jax_state_dict``), the same configs (``config_from_hf``, field by
field) and the same logits (within 1e-5 plus 1e-5 of each logit, as the
Llama interop tests hold them). Where ``transformers`` imports, the HF
model on the same arrays gives those logits too. A bare encoder
checkpoint leaves the heads at random init with the JAX warning; a
sharded BERT checkpoint (a layer's q, k, v in different files) loads."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import hf_interop as jax_hf
from paddle_tpu_torch.convert import jax_state_dict
from paddle_tpu_torch.models import hf_interop

safetensors_numpy = pytest.importorskip("safetensors.numpy")

TOL_LOGITS = 1e-5    # absolute, and the same relative

H, FFN, LAYERS, HEADS, VOCAB, POS = 64, 128, 2, 4, 128, 64


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gpt2(seed):
    cfg = dict(model_type="gpt2", vocab_size=VOCAB, n_embd=H, n_layer=LAYERS,
               n_head=HEADS, n_positions=POS, layer_norm_epsilon=1e-5,
               torch_dtype="float32")
    rs = np.random.RandomState(seed)
    w = {"transformer.wte.weight": rs.randn(VOCAB, H) * 0.1,
         "transformer.wpe.weight": rs.randn(POS, H) * 0.1,
         "transformer.ln_f.weight": 1 + 0.1 * rs.randn(H),
         "transformer.ln_f.bias": 0.1 * rs.randn(H)}
    for i in range(LAYERS):
        p = f"transformer.h.{i}."
        # Conv1D weights are [in, out]
        for name, din, dout in (("attn.c_attn", H, 3 * H),
                                ("attn.c_proj", H, H),
                                ("mlp.c_fc", H, 4 * H),
                                ("mlp.c_proj", 4 * H, H)):
            w[p + name + ".weight"] = rs.randn(din, dout) * 0.1
            w[p + name + ".bias"] = 0.1 * rs.randn(dout)
        for ln in ("ln_1", "ln_2"):
            w[p + ln + ".weight"] = 1 + 0.1 * rs.randn(H)
            w[p + ln + ".bias"] = 0.1 * rs.randn(H)
    return cfg, {k: v.astype(np.float32) for k, v in w.items()}


def _encoder(prefix, rs, with_pooler=True, task_types=False):
    e = prefix + "embeddings."
    w = {e + "word_embeddings.weight": rs.randn(VOCAB, H) * 0.1,
         e + "position_embeddings.weight": rs.randn(POS, H) * 0.1,
         e + "token_type_embeddings.weight": rs.randn(2, H) * 0.1,
         e + "LayerNorm.weight": 1 + 0.1 * rs.randn(H),
         e + "LayerNorm.bias": 0.1 * rs.randn(H)}
    if task_types:
        w[e + "task_type_embeddings.weight"] = rs.randn(3, H) * 0.1
    for i in range(LAYERS):
        p = f"{prefix}encoder.layer.{i}."
        for name, din, dout in (("attention.self.query", H, H),
                                ("attention.self.key", H, H),
                                ("attention.self.value", H, H),
                                ("attention.output.dense", H, H),
                                ("intermediate.dense", H, FFN),
                                ("output.dense", FFN, H)):
            w[p + name + ".weight"] = rs.randn(dout, din) * 0.1
            w[p + name + ".bias"] = 0.1 * rs.randn(dout)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            w[p + ln + ".weight"] = 1 + 0.1 * rs.randn(H)
            w[p + ln + ".bias"] = 0.1 * rs.randn(H)
    if with_pooler:
        w[prefix + "pooler.dense.weight"] = rs.randn(H, H) * 0.1
        w[prefix + "pooler.dense.bias"] = 0.1 * rs.randn(H)
    return w


def _mlm_head(rs, nsp=True):
    c = "cls.predictions."
    w = {c + "transform.dense.weight": rs.randn(H, H) * 0.1,
         c + "transform.dense.bias": 0.1 * rs.randn(H),
         c + "transform.LayerNorm.weight": 1 + 0.1 * rs.randn(H),
         c + "transform.LayerNorm.bias": 0.1 * rs.randn(H),
         c + "bias": 0.1 * rs.randn(VOCAB)}
    if nsp:
        w["cls.seq_relationship.weight"] = rs.randn(2, H) * 0.1
        w["cls.seq_relationship.bias"] = 0.1 * rs.randn(2)
    return w


def _bert(seed, bare=False):
    cfg = dict(model_type="bert", vocab_size=VOCAB, hidden_size=H,
               intermediate_size=FFN, num_hidden_layers=LAYERS,
               num_attention_heads=HEADS, max_position_embeddings=POS,
               type_vocab_size=2, layer_norm_eps=1e-12,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               torch_dtype="float32")
    rs = np.random.RandomState(seed)
    w = _encoder("" if bare else "bert.", rs)
    if not bare:
        w.update(_mlm_head(rs))
    return cfg, {k: v.astype(np.float32) for k, v in w.items()}


def _ernie(seed):
    cfg = dict(model_type="ernie", vocab_size=VOCAB, hidden_size=H,
               intermediate_size=FFN, num_hidden_layers=LAYERS,
               num_attention_heads=HEADS, max_position_embeddings=POS,
               type_vocab_size=2, task_type_vocab_size=3, use_task_id=True,
               layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, torch_dtype="float32")
    rs = np.random.RandomState(seed)
    w = _encoder("ernie.", rs, with_pooler=False, task_types=True)
    w.update(_mlm_head(rs, nsp=False))
    return cfg, {k: v.astype(np.float32) for k, v in w.items()}


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


def _outputs(model, ids, jax_side):
    """The family's logits as a tuple of numpy arrays (eval mode)."""
    model.eval()
    if jax_side:
        out = model(jnp.asarray(ids))
    else:
        with torch.no_grad():
            out = model(torch.from_numpy(ids).long())
    out = out if isinstance(out, tuple) else (out,)
    return tuple(np.asarray(o) if jax_side else o.numpy() for o in out)


def _config_fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).replace("torch.", "")
    return out


CASES = {"gpt2": _gpt2, "bert": _bert, "ernie": _ernie,
         "bert-sharded": _bert}


@pytest.mark.parametrize("case", tuple(CASES))
def test_from_pretrained_matches_jax(tmp_path, case):
    cfg, weights = CASES[case](seed=3)
    d = _write(tmp_path / case, cfg, weights,
               shards=3 if case.endswith("sharded") else 1)
    jcls, jcfg, jmt = jax_hf.config_from_hf(d)
    tcls, tcfg, tmt = hf_interop.config_from_hf(d)
    assert (tcls.__name__, tmt) == (jcls.__name__, jmt)
    assert _config_fields(tcfg) == _config_fields(jcfg)
    # the converters over a whole checkpoint are the JAX package's
    conv = hf_interop.convert_hf_state_dict(weights, tcfg, tmt)
    jconv = jax_hf.convert_hf_state_dict(weights, jcfg, jmt)
    assert set(conv) == set(jconv)
    for k in jconv:
        np.testing.assert_array_equal(np.asarray(conv[k]), jconv[k])
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    want = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    got = {k: v.numpy() for k, v in jax_state_dict(tm).items()}
    assert set(got) == set(want)
    # every loaded tensor bit for bit (ERNIE's MLM model has a pooler the
    # checkpoint lacks: left at each package's own random init)
    for k in jconv:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ids = np.random.RandomState(4).randint(0, VOCAB, (2, 24))
    for o, r in zip(_outputs(tm, ids, False), _outputs(jm, ids, True)):
        np.testing.assert_allclose(o, r, atol=TOL_LOGITS, rtol=TOL_LOGITS)


def test_bare_encoder_warns_and_strictness_holds(tmp_path):
    """A bare ``BertModel`` checkpoint leaves the MLM / NSP heads at
    random init with the JAX warning, strict or not, and its encoder
    equals the JAX package's; a missing encoder tensor still raises."""
    cfg, weights = _bert(seed=5, bare=True)
    d = _write(tmp_path / "bare", cfg, weights)
    with pytest.warns(UserWarning, match="random init"):
        tm = hf_interop.from_pretrained(d, device="cpu")
    with pytest.warns(UserWarning, match="random init"):
        jm = jax_hf.from_pretrained(d)
    tm.eval()
    jm.eval()
    ids = np.random.RandomState(6).randint(0, VOCAB, (2, 16))
    ref = np.asarray(jm.bert(jnp.asarray(ids))[0])
    with torch.no_grad():
        got = tm.bert(torch.from_numpy(ids).long())[0].numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_LOGITS, rtol=TOL_LOGITS)
    weights.pop("encoder.layer.1.output.dense.bias")
    d = _write(tmp_path / "missing", cfg, weights)
    with pytest.raises(KeyError):
        hf_interop.from_pretrained(d, device="cpu")


@pytest.mark.parametrize("case", ("gpt2", "bert", "ernie"))
def test_logits_match_transformers(tmp_path, case):
    """The HF model built from the same ``config.json`` with the same
    arrays loaded gives the port's logits (dropout off, eval mode)."""
    transformers = pytest.importorskip("transformers")
    cfg, weights = CASES[case](seed=7)
    d = _write(tmp_path / case, cfg, weights)
    cls = {"gpt2": transformers.GPT2LMHeadModel,
           "bert": transformers.BertForPreTraining,
           "ernie": transformers.ErnieForMaskedLM}[case]
    hf_cfg = transformers.AutoConfig.from_pretrained(
        d, attn_implementation="eager")
    hf = cls(hf_cfg)
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(v) for k, v in weights.items()}, strict=False)
    assert not unexpected
    # tied decoders and causal-mask buffers only
    assert all(k.endswith(("lm_head.weight", "decoder.weight",
                           "decoder.bias", ".attn.bias",
                           ".attn.masked_bias")) for k in missing), missing
    hf.tie_weights()
    hf.eval()
    tm = hf_interop.from_pretrained(d, device="cpu")
    ids = np.random.RandomState(8).randint(0, VOCAB, (2, 24))
    with torch.no_grad():
        out = hf(torch.from_numpy(ids).long())
    refs = ((out.prediction_logits, out.seq_relationship_logits)
            if case == "bert" else (out.logits,))
    for o, r in zip(_outputs(tm, ids, False), refs):
        np.testing.assert_allclose(o, r.numpy(), atol=TOL_LOGITS,
                                   rtol=TOL_LOGITS)


TOL_BF16 = 0      # loaded tensors: both packages round fp32 to bf16 (RNE)


@pytest.mark.parametrize("case", ("bert", "ernie"))
def test_bf16_checkpoints_load_with_the_jax_dtypes(tmp_path, case):
    """A checkpoint whose config says bfloat16 loads every tensor in the
    JAX loader's dtype, key by key: the JAX ``_place`` casts each
    floating tensor of the checkpoint to the config's dtype (the NSP and
    MLM heads the constructor keeps fp32 load bf16), and a tensor the
    checkpoint lacks keeps the constructor's dtype in both. Then the
    loaded values, within ``TOL_BF16``."""
    cfg, weights = CASES[case](seed=9)
    cfg = dict(cfg, torch_dtype="bfloat16")
    d = _write(tmp_path / case, cfg, weights)
    jconv = jax_hf.convert_hf_state_dict(
        weights, *jax_hf.config_from_hf(d)[1:])
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    jsd = dict(jm.state_dict())
    tsd = jax_state_dict(tm)
    assert set(tsd) == set(jsd)
    got = {k: str(v.dtype).replace("torch.", "") for k, v in tsd.items()}
    want = {k: str(jnp.asarray(v).dtype) for k, v in jsd.items()}
    assert got == want
    assert "bfloat16" in {want[k] for k in jconv if "cls" in k
                          or "head" in k}
    for k in jconv:
        np.testing.assert_allclose(
            tsd[k].float().numpy(),
            np.asarray(jnp.asarray(jsd[k], jnp.float32)), atol=TOL_BF16,
            rtol=0, err_msg=k)
