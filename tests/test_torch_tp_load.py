"""Checkpoints loaded a rank's slices at a time, on the CPU.

A seeded JAX Llama tiny is written as an HF checkpoint (two safetensors
shards and an index, the layout ``chip_smoke.py``'s ``_write_safetensors``
writes) in float32, and again in BF16. In spawned gloo worlds of 2 and 4
ranks (``tests/torch_dist_workers.py`` ``tp_load_cases``) each rank calls
``from_pretrained`` inside ``sharded_build`` and ``load_jax_state_dict``
into a model built sharded:

- each rank's tensors are bit for bit ``shard_layer`` of the whole load;
- greedy tokens equal the JAX ``from_pretrained`` model's ``generate``;
- no rank makes a tensor of a decoder layer's whole projection shape but
  while that layer is drawn (one layer's at a time), none after the
  build, and every read of the checkpoint is a rank's slice;
- a quantized model's cut buffers load the same way (tp 2);
- a missing key raises ``KeyError`` and a wrong shape ``ValueError``, as
  the whole loader's do.

The config is the ``_dryrun_paged_tp`` Llama widened so that no shard of
a projection, and no other tensor the load makes, has a whole
projection's shape."""
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import hf_interop as jax_hf
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import hf_interop
from torch_dist_workers import _layer_shapes, start_world

# 12 query heads of 8 over 4 kv heads; no projection's shard, at tp 2 or
# 4, has a whole projection's shape, nor do the embedding and the head
CFG = dict(vocab_size=320, hidden_size=96, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=12,
           num_key_value_heads=4)
# widths whose projections quantize at tp 2 (the tp serving test's)
QCFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4)
PROJECTIONS = 7          # q, k, v, o, gate, up, down


def _write_safetensors(path, tensors, dtype):
    """{name: float32 array} in the safetensors layout, as F32 or BF16
    (bf16 rounded to nearest even)."""
    header, off, blobs = {}, 0, []
    for name, a in tensors.items():
        t = torch.from_numpy(np.array(a, np.float32))
        if dtype == "BF16":
            t = t.to(torch.bfloat16)
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        off += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _write_checkpoint(d, hf, cfg, dtype="F32", torch_dtype="float32"):
    """``hf`` ({HF name: array}) as two shards (decoder layers, the rest)
    and an index, with a config.json of ``cfg``'s widths."""
    os.makedirs(d, exist_ok=True)
    shards = {n: ("model-00001-of-00002.safetensors"
                  if n.startswith("model.layers.")
                  else "model-00002-of-00002.safetensors") for n in hf}
    for shard in sorted(set(shards.values())):
        _write_safetensors(os.path.join(d, shard),
                           {n: hf[n] for n in sorted(hf)
                            if shards[n] == shard}, dtype)
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": shards}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "num_key_value_heads": cfg.num_key_value_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": False,
                   "torch_dtype": torch_dtype}, f)
    return d


def _jax(cfg, seed):
    pt.seed(seed)
    return JaxLlama(jax_llama_tiny(**cfg))


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_load")
    jm = _jax(CFG, 0)
    hf = jax_hf.to_hf_state_dict(jm)
    cfg = jm.config
    d = _write_checkpoint(str(tmp / "f32"), hf, cfg)
    bad = dict(hf)
    del bad["model.layers.1.mlp.up_proj.weight"]
    wrong = dict(hf)
    wrong["model.layers.0.self_attn.k_proj.weight"] = \
        hf["model.layers.0.self_attn.k_proj.weight"][:, :-1]
    ids = np.random.RandomState(4).randint(1, 320, (2, 9))
    p = dict(cfg=CFG, dir=d, ids=ids,
             bf16_dir=_write_checkpoint(str(tmp / "bf16"), hf, cfg, "BF16",
                                        "bfloat16"),
             missing_dir=_write_checkpoint(str(tmp / "missing"), bad, cfg),
             shape_dir=_write_checkpoint(str(tmp / "shape"), wrong, cfg),
             params={k: np.asarray(v) for k, v in jm.state_dict().items()},
             qcfg=QCFG, qparams={k: np.asarray(v) for k, v in
                                 _jax(QCFG, 1).state_dict().items()})
    worlds = {tp: start_world("tp_load", tp, tmp, p, timeout_s=300)
              for tp in (2, 4)}
    jax_model = jax_hf.from_pretrained(d)
    want = np.asarray(jax_model.generate(jnp.asarray(ids), max_new_tokens=8,
                                         temperature=0.0))
    return p, {tp: w.result() for tp, w in worlds.items()}, want


@pytest.mark.parametrize("tp", [2, 4])
def test_per_rank_from_pretrained_is_the_whole_load_sharded(loaded, tp):
    _, ranks, want = loaded
    for r in ranks[tp]:
        assert r["hf_same"] and r["bf16_same"]
        np.testing.assert_array_equal(r["hf_greedy"], want)


@pytest.mark.parametrize("tp", [2, 4])
def test_per_rank_load_jax_state_dict_is_the_whole_load_sharded(loaded,
                                                                tp):
    _, ranks, _ = loaded
    for r in ranks[tp]:
        assert r["jax_same"]


@pytest.mark.parametrize("tp", [2, 4])
def test_no_rank_holds_a_decoder_layer_whole_but_the_one_drawn(loaded, tp):
    """While the model is built each layer's projections are made whole,
    at most one layer's alive at a time; the load after the build makes
    none and reads only this rank's slices."""
    _, ranks, _ = loaded
    whole = _layer_shapes(ptt.llama_tiny(**CFG))
    for r in ranks[tp]:
        for key in ("count", "jax_count"):
            made, peak, marks = r[key]
            assert len(marks) == 1 and made == marks[0] > 0, key
            assert 0 < peak <= PROJECTIONS, (key, peak)
        for key in ("reads", "jax_reads"):
            assert r[key] and not whole & set(r[key]), key


def test_quantized_buffers_load_as_their_cut(loaded):
    _, ranks, _ = loaded
    for r in ranks[2]:
        assert r["quant_same"]


@pytest.mark.parametrize("key, exc", [("missing", "KeyError"),
                                      ("shape", "ValueError")])
def test_per_rank_errors_are_the_whole_loaders(loaded, key, exc):
    p, ranks, _ = loaded
    with pytest.raises(KeyError if exc == "KeyError" else ValueError) as e:
        hf_interop.from_pretrained(p[f"{key}_dir"], device="cpu")
    for tp in (2, 4):
        for r in ranks[tp]:
            assert r[key][0] == exc
            if key == "missing":
                assert r[key][1] == str(e.value)
            else:
                assert "k_proj" in r[key][1] and "k_proj" in str(e.value)


def test_file_views_read_what_the_whole_reader_reads(tmp_path):
    """A memory-mapped view reads, at any slice and through ``.T``, the
    values the whole reader gives (BF16 widened bit for bit)."""
    rs = np.random.RandomState(0)
    a = rs.randn(6, 10).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    for dtype in ("F32", "BF16"):
        path = str(tmp_path / f"{dtype}.safetensors")
        _write_safetensors(path, {"a": a, "b": b}, dtype)
        whole = hf_interop._load_safetensors_file(path)
        views = hf_interop._open_safetensors_file(path)
        np.testing.assert_array_equal(np.asarray(views["a"]), whole["a"])
        np.testing.assert_array_equal(views["a"][2:4], whole["a"][2:4])
        np.testing.assert_array_equal(views["a"].T[1:3], whole["a"].T[1:3])
        np.testing.assert_array_equal(views["a"].T[:, 3:5],
                                      whole["a"].T[:, 3:5])
        np.testing.assert_array_equal(views["b"][2:5], whole["b"][2:5])
        assert views["a"].T.shape == (10, 6)
        if dtype == "F32":
            np.testing.assert_array_equal(whole["a"], a)
        else:
            np.testing.assert_array_equal(
                whole["a"], torch.from_numpy(a).bfloat16().float().numpy())


def test_moe_families_load_whole_only(tmp_path):
    """A MoE checkpoint inside ``sharded_build`` raises before anything is
    built: those families serve at tp 1 and load whole."""
    from paddle_tpu_torch.parallel.sharding import sharded_build
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "qwen2_moe", "vocab_size": 64,
                   "hidden_size": 32, "num_hidden_layers": 1,
                   "num_attention_heads": 4, "intermediate_size": 64,
                   "num_experts": 4, "moe_intermediate_size": 16}, f)
    with sharded_build(mesh=object()):
        with pytest.raises(ValueError, match="loads whole"):
            hf_interop.from_pretrained(str(tmp_path), device="cpu")
