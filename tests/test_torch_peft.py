"""The port's LoRA (``paddle_tpu_torch.peft``) against the JAX package's.

The JAX model is built from its seed with its adapters injected; its
weights, adapters included, cross as numpy through ``load_jax_state_dict``
(which transposes ``lora_A`` [in, r] -> [r, in] and ``lora_B`` [r, out] ->
[out, r]), and both sides see the same numpy inputs, in fp32 on the CPU at
``llama_tiny`` sizes. Every case of the JAX package's
``tests/test_lora.py`` has its counterpart here: identity at init, the
delta, the scaling, freezing, the partitions, merge and unmerge, the
Trainer (and SFTTrainer) on the adapters alone, gradient accumulation,
adapter files in both directions, dropout (matched in distribution: the
JAX package draws its masks from keys, the port from a
``torch.Generator``) and evaluation without it; then what is the port's
own: captured programs dropped by a merge, ``fuse_projections`` on an
adapted model as the JAX one does it, and one SFT step at tp 2 in a gloo
world against the JAX step on a tp 2 mesh."""
import contextlib
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import causal_lm_loss as jax_causal_lm_loss
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn.fuse import fuse_projections as jax_fuse
from paddle_tpu.peft import LoRAConfig as JaxLoRAConfig
from paddle_tpu.peft import LoRAModel as JaxLoRAModel
from paddle_tpu.peft import apply_lora as jax_apply_lora
from paddle_tpu.peft import inject_lora as jax_inject_lora
from paddle_tpu.peft import merge_lora as jax_merge_lora
from paddle_tpu.peft import unmerge_lora as jax_unmerge_lora
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu.trl import DataCollatorForSFT as JaxCollator
from paddle_tpu.trl import SFTTrainer as JaxSFTTrainer
from paddle_tpu_torch.generation.graphs import weights_links, weights_moved
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.fuse import fuse_projections
from paddle_tpu_torch.peft import (LoRAConfig, LoRAModel, apply_lora,
                                   inject_lora, lora_state_dict, merge_lora,
                                   unmerge_lora)
from paddle_tpu_torch.trl import DataCollatorForSFT, SFTTrainer
from torch_dist_workers import start_world

# fp32 forwards: the same products summed in another order by XLA and torch
ATOL_FP32 = 1e-5
# logits of a 2-layer fp32 model
ATOL_LOGITS = 1e-4
# adapters after AdamW steps at lr 1e-3: Adam's first steps move an entry
# by about lr * sign(g), so an entry whose gradient is within rounding of
# zero may move by a different part of lr in the two packages (seen: 5e-6)
ATOL_ADAPTERS = 1e-5
# loss histories
RTOL_LOSS = 1e-5
# merge then unmerge: one fp32 rounding of the weight each way
ATOL_ROUNDTRIP = 1e-5
ALL7 = [".*q_proj", ".*k_proj", ".*v_proj", ".*o_proj", ".*gate_proj",
        ".*up_proj", ".*down_proj"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _no_cache_writes():
    """JAX references compiled without writing the persistent compilation
    cache (a reader in another worker could get a torn entry)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


def _np(t):
    return t.detach().float().cpu().numpy()


def _ids(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s))


def _jax_lora_model(cfg, seed=0, b_scale=0.0, b_seed=1):
    """The JAX tiny Llama with adapters; B drawn N(0, b_scale) from numpy
    when b_scale > 0 (at 0 the adapted model is the base model)."""
    pt.seed(seed)
    jm = JaxLlama(jax_llama_tiny())
    hit = jax_apply_lora(jm, JaxLoRAConfig(**cfg))
    if b_scale:
        rs = np.random.RandomState(b_seed)
        for k, v in jm.state_dict().items():
            if k.endswith("lora_B"):
                jm._set_by_path(k, jnp.asarray(
                    rs.randn(*v.shape).astype(np.float32) * b_scale))
    return jm, hit


def _port_twin(jm, cfg):
    """A port tiny Llama with the same adapters holding ``jm``'s weights."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    hit = apply_lora(tm, LoRAConfig(**cfg))
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return tm, hit


def _port_args(tmp_path, **kw):
    return ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                 graceful_shutdown=False, logging_steps=1,
                                 **kw)


def _jax_args(tmp_path, **kw):
    return JaxArgs(output_dir=str(tmp_path / "jax"), logging_steps=1,
                   resume_from_checkpoint=False, **kw)


def _assert_adapters(tm, jax_params, atol):
    n = 0
    for name, v in lora_state_dict(tm).items():
        np.testing.assert_allclose(_np(v).T, np.asarray(jax_params[name]),
                                   atol=atol, rtol=0, err_msg=name)
        n += 1
    assert n


# ------------------------------------------------------------ the layer
def _linear_pair(seed=0):
    pt.seed(seed)
    jl = jnn.Linear(16, 32)
    tl = Linear(16, 32, generator=ptt.make_generator(0, "cpu"),
                device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight).T.copy()))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias).copy()))
    return jl, tl


def test_lora_identity_at_init():
    """B = 0 at init: the adapted layer's output is the base layer's,
    bit for bit, and the JAX one's within fp32 rounding."""
    jl, tl = _linear_pair()
    x = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    y0 = _np(tl(torch.from_numpy(x)))
    inject_lora(tl, LoRAConfig(r=4), ptt.make_generator(0, "cpu"))
    jax_inject_lora(jl, JaxLoRAConfig(r=4))
    assert tuple(tl.lora_A.shape) == (4, 16)
    assert tuple(tl.lora_B.shape) == (32, 4)
    assert not tl.lora_B.detach().any()
    np.testing.assert_array_equal(_np(tl(torch.from_numpy(x))), y0)
    np.testing.assert_allclose(y0, np.asarray(jl(jnp.asarray(x))),
                               atol=ATOL_FP32, rtol=0)


def test_lora_delta_math_matches_jax():
    """The same A [16, 4] and B [4, 32] (transposed into the port's
    layout) give the JAX layer's output and y0 + (x A B) * scaling."""
    cfg = dict(r=4, lora_alpha=8)
    jl, tl = _linear_pair()
    x = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    y0 = np.asarray(jl(jnp.asarray(x)))
    jax_inject_lora(jl, JaxLoRAConfig(**cfg))
    inject_lora(tl, LoRAConfig(**cfg), ptt.make_generator(0, "cpu"))
    a = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    b = np.random.RandomState(3).randn(4, 32).astype(np.float32)
    jl.lora_A, jl.lora_B = jnp.asarray(a), jnp.asarray(b)
    with torch.no_grad():
        tl.lora_A.copy_(torch.from_numpy(a.T.copy()))
        tl.lora_B.copy_(torch.from_numpy(b.T.copy()))
    got = _np(tl(torch.from_numpy(x)))
    want = y0 + (x @ a @ b) * LoRAConfig(**cfg).scaling
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jl(jnp.asarray(x))),
                               atol=ATOL_FP32, rtol=0)


def test_lora_rslora_scaling():
    for kw in (dict(r=16, lora_alpha=16), dict(r=16, lora_alpha=16,
                                               rslora=True),
               dict(r=8, lora_alpha=16)):
        assert LoRAConfig(**kw).scaling == JaxLoRAConfig(**kw).scaling
    assert LoRAConfig(r=16, lora_alpha=16, rslora=True).scaling == 4.0


def test_lora_double_injection_rejected():
    lin = Linear(8, 8, generator=ptt.make_generator(0, "cpu"), device="cpu")
    inject_lora(lin, LoRAConfig(r=2))
    with pytest.raises(ValueError, match="already injected"):
        inject_lora(lin, LoRAConfig(r=2))


# ------------------------------------------------------------ the model
def test_lora_targets_and_freeze_match_jax():
    """The same paths get adapters, and only they train: the port's
    ``requires_grad`` set is the JAX package's trainable set."""
    jm, jhit = _jax_lora_model(dict(r=4))
    tm, hit = _port_twin(jm, dict(r=4))
    assert hit == jhit
    assert all(h.endswith(("q_proj", "v_proj")) for h in hit)
    assert len(hit) == 2 * tm.config.num_hidden_layers
    trainable = [k for k, p in tm.named_parameters() if p.requires_grad]
    assert trainable == list(jm.trainable_parameters())
    assert "lm_head.weight" in dict(tm.named_parameters())
    # trainable_bias: the adapted layers' biases train too
    tm2 = ptt.LlamaForCausalLM(ptt.llama_tiny(attention_bias=True),
                               device="cpu")
    apply_lora(tm2, LoRAConfig(r=2, trainable_bias=True))
    assert {k for k, p in tm2.named_parameters() if p.requires_grad} == {
        f"model.layers.{i}.self_attn.{m}.{w}" for i in range(2)
        for m in ("q_proj", "v_proj") for w in ("lora_A", "lora_B", "bias")}


def test_lora_no_match_raises():
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    with pytest.raises(ValueError, match="matched nothing"):
        apply_lora(tm, LoRAConfig(target_modules=[".*nonexistent"]))


def test_lora_partitions_follow_jax():
    """q_proj (column): A replicated, B split on out; o_proj (row): A
    split on in, B replicated: the JAX partitions, reversed as the
    port's layout is."""
    cfg = dict(r=4, target_modules=[".*q_proj", ".*o_proj", ".*down_proj",
                                    ".*gate_proj"])
    jm, _ = _jax_lora_model(cfg)
    tm, _ = _port_twin(jm, cfg)
    meta = jm.param_meta()
    got = {k: getattr(v, "partition", None)
           for k, v in lora_state_dict(tm).items()}
    for k, part in got.items():
        want = meta[k].partition
        assert part == (tuple(reversed(want)) if want else None), k
    assert got["model.layers.0.self_attn.q_proj.lora_B"] == ("tp", None)
    assert got["model.layers.0.self_attn.o_proj.lora_A"] == (None, "tp")


# ------------------------------------------------------------ merging
def test_lora_merge_unmerge_roundtrip_matches_jax():
    """B = 0.01 everywhere: the merged weights equal the JAX merge's,
    the merged logits equal the adapted ones (and JAX's), merging is
    idempotent, and unmerging brings the weight back within the fp32
    round trip the JAX test allows."""
    jm, _ = _jax_lora_model(dict(r=4))
    for k, v in jm.state_dict().items():
        if k.endswith("lora_B"):
            jm._set_by_path(k, jnp.full_like(v, 0.01))
    tm, _ = _port_twin(jm, dict(r=4))
    ids = _ids()
    y_adapter = _np(tm(torch.from_numpy(ids)))
    q = tm.model.layers[0].self_attn.q_proj
    w0 = _np(q.weight).copy()
    ptr = q.weight.data_ptr()
    merge_lora(tm)
    jax_merge_lora(jm)
    assert q.weight.data_ptr() == ptr            # in place
    assert not np.allclose(_np(q.weight), w0)
    for name, p in tm.named_parameters():
        if name.endswith(".weight") and "proj" in name:
            np.testing.assert_allclose(
                _np(p).T, np.asarray(jm.state_dict()[name]),
                atol=1e-6, rtol=0, err_msg=name)
    merged = _np(tm(torch.from_numpy(ids)))
    np.testing.assert_allclose(merged, y_adapter, atol=ATOL_LOGITS)
    np.testing.assert_allclose(merged, np.asarray(jm(jnp.asarray(ids))),
                               atol=ATOL_LOGITS)
    merge_lora(tm)   # idempotent
    np.testing.assert_array_equal(_np(tm(torch.from_numpy(ids))), merged)
    unmerge_lora(tm)
    jax_unmerge_lora(jm)
    np.testing.assert_allclose(_np(q.weight), w0, atol=ATOL_ROUNDTRIP)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(ids))), y_adapter,
                               atol=ATOL_LOGITS)


def test_lora_merge_drops_captured_programs():
    """A captured decode program records each module's hooks: a merge
    (hook removed) and an unmerge (hook back) each make the recorded
    links stale, so ``generate()``'s and the engine's programs are
    rebuilt instead of replaying the adapter's captured delta."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    apply_lora(tm, LoRAConfig(r=2))
    links = weights_links(tm)
    assert not weights_moved(links)
    merge_lora(tm)
    assert weights_moved(links)
    links = weights_links(tm)
    merge_lora(tm)                      # already merged: nothing moves
    assert not weights_moved(links)
    unmerge_lora(tm)
    assert weights_moved(links)
    q = tm.model.layers[0].self_attn.q_proj
    assert len(q._forward_hooks) == 1


def test_lora_generate_after_merge_uses_merged_weights():
    """``generate()`` before a merge, after it and after the unmerge, on
    the same model object: greedy tokens of the adapted, merged and
    unmerged model equal a fresh forward's argmax each time (on the
    card the second and third calls must not replay the first's
    program)."""
    jm, _ = _jax_lora_model(dict(r=4, target_modules=ALL7), b_scale=0.3)
    tm, _ = _port_twin(jm, dict(r=4, target_modules=ALL7))
    ids = torch.from_numpy(_ids(2, 8, seed=3))
    cfg = ptt.GenerationConfig(max_new_tokens=4)
    outs = []
    for step in ("adapted", "merged", "unmerged"):
        if step == "merged":
            merge_lora(tm)
        elif step == "unmerged":
            unmerge_lora(tm)
        out = ptt.generate(tm, ids, cfg)
        with torch.no_grad():
            logits = tm(out[:, :-1])
        np.testing.assert_array_equal(
            out[:, 8:].numpy(), logits[:, 7:].argmax(-1).numpy())
        outs.append(out)
    np.testing.assert_array_equal(outs[0].numpy(), outs[2].numpy())


@pytest.mark.parametrize("merged", (False, True))
def test_lora_fuse_projections_as_jax(merged):
    """``fuse_projections`` on an adapted model does what the JAX pass
    does: the fused layer is built from the weights alone, so a merged
    adapter survives the fusion and an unmerged one goes with the
    unfused layers. Logits equal the JAX fused model's either way."""
    cfg = dict(r=4, target_modules=ALL7)
    jm, _ = _jax_lora_model(cfg, b_scale=0.3)
    tm, _ = _port_twin(jm, cfg)
    ids = _ids(2, 8, seed=4)
    adapted = _np(tm(torch.from_numpy(ids)))
    if merged:
        merge_lora(tm)
        jax_merge_lora(jm)
    fuse_projections(tm)
    jax_fuse(jm)
    got = _np(tm(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(ids))),
                               atol=ATOL_LOGITS)
    assert np.allclose(got, adapted, atol=ATOL_LOGITS) == merged


# ------------------------------------------------------------ training
def test_lora_trainer_updates_only_adapters(tmp_path):
    """6 AdamW steps through both Trainers on 3 batches: optimizer state
    only for the adapters, every base weight bit for bit as it was, B
    moved, the adapters within ATOL_ADAPTERS of the JAX Trainer's and the
    loss histories within RTOL_LOSS."""
    cfg = dict(r=4, lora_alpha=8)
    jm, _ = _jax_lora_model(cfg)
    tm, _ = _port_twin(jm, cfg)
    base = {k: v.detach().clone() for k, v in tm.named_parameters()
            if "lora" not in k}
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 256, (4, 16)) for _ in range(3)]
    with _no_cache_writes():
        jtr = JaxTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-3),
                         _jax_args(tmp_path, max_steps=6),
                         train_dataloader=[jnp.asarray(b) for b in batches])
        jtr.train()
    tr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-3),
                     _port_args(tmp_path, max_steps=6),
                     train_dataloader=[torch.from_numpy(b) for b in batches])
    tr.train()
    assert len(tr._opt_state["slots"]) == len(lora_state_dict(tm)) == \
        len(jtr._opt_state["slots"])
    after = dict(tm.named_parameters())
    for k, v in base.items():
        assert torch.equal(after[k], v), k
    assert any(after[k].abs().sum() > 0 for k in after
               if k.endswith("lora_B"))
    _assert_adapters(tm, jtr._params, ATOL_ADAPTERS)
    np.testing.assert_allclose(
        [v for _, v in tr.logger.history["loss"]],
        [v for _, v in jtr.logger.history["loss"]], rtol=RTOL_LOSS)


def _sft_batch(seed=4, n=6, max_length=24):
    rs = np.random.RandomState(seed)
    return [{"prompt_ids": rs.randint(1, 256, 4).tolist(),
             "response_ids": rs.randint(1, 256, 6).tolist()}
            for _ in range(n)]


@pytest.mark.parametrize("steps", (1, 3))
def test_lora_sft_trainer_adapters_match_jax(tmp_path, steps):
    """LoRA on all seven projections (B drawn nonzero, so A trains from
    step 1), packed SFT batches, ``steps`` AdamW steps of both
    SFTTrainers: the adapters within ATOL_ADAPTERS of the JAX ones, the
    base weights untouched, the losses within RTOL_LOSS."""
    cfg = dict(r=4, lora_alpha=8, target_modules=ALL7)
    jm, _ = _jax_lora_model(cfg, b_scale=0.05)
    tm, _ = _port_twin(jm, cfg)
    ex = _sft_batch()
    jb = JaxCollator(max_length=24, packing=True)(ex)
    tb = DataCollatorForSFT(max_length=24, packing=True)(ex)
    base = {k: v.detach().clone() for k, v in tm.named_parameters()
            if "lora" not in k}
    with _no_cache_writes():
        jtr = JaxSFTTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-3),
                            _jax_args(tmp_path, max_steps=steps),
                            train_dataloader=[jb])
        jtr.train()
    tr = SFTTrainer(tm, ptt.optimizer.AdamW(learning_rate=1e-3),
                    _port_args(tmp_path, max_steps=steps),
                    train_dataloader=[tb])
    tr.train()
    _assert_adapters(tm, jtr._params, ATOL_ADAPTERS)
    for k, v in tm.named_parameters():
        if "lora" not in k:
            assert torch.equal(v, base[k]), k
    np.testing.assert_allclose(
        [v for _, v in tr.logger.history["loss"]],
        [v for _, v in jtr.logger.history["loss"]], rtol=RTOL_LOSS)


def test_lora_accumulation_equals_big_batch(tmp_path):
    """gradient_accumulation_steps=2 over half batches gives the one big
    batch's SGD step (the frozen path): the port's two runs agree within
    1e-6 and the JAX big-batch step within ATOL_FP32."""
    cfg = dict(r=4, lora_alpha=8)
    jm, _ = _jax_lora_model(cfg, b_scale=0.05)
    params = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ids = _ids(4, 16, seed=5)
    with _no_cache_writes():
        jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=1e-1),
                         _jax_args(tmp_path, max_steps=1),
                         train_dataloader=[jnp.asarray(ids)])
        jtr.train()
    got = {}
    for accum in (1, 2):
        tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
        apply_lora(tm, LoRAConfig(**cfg))
        ptt.load_jax_state_dict(tm, params)
        tr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=1e-1),
                         _port_args(tmp_path / str(accum), max_steps=1,
                                    gradient_accumulation_steps=accum),
                         train_dataloader=[torch.from_numpy(ids)])
        tr.train()
        got[accum] = (tr.logger.history["loss"][0][1],
                      {k: _np(v) for k, v in lora_state_dict(tm).items()})
        _assert_adapters(tm, jtr._params, ATOL_FP32)
    assert abs(got[1][0] - got[2][0]) < 1e-6
    for k in got[1][1]:
        np.testing.assert_allclose(got[1][1][k], got[2][1][k], atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ the facade
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_lora_adapter_files_cross(tmp_path, writer):
    """An adapter saved by one package's ``LoRAModel.save_pretrained``
    loads into the other's ``from_pretrained`` on a fresh base model
    (the same seed): the file holds only the adapters, in the JAX
    layout, and the logits equal the writer's."""
    path = str(tmp_path / "adapter")
    ids = _ids()
    pt.seed(0)
    jbase = JaxLlama(jax_llama_tiny())
    params = {k: np.asarray(v) for k, v in jbase.state_dict().items()}
    if writer == "jax":
        jl = JaxLoRAModel(jbase, JaxLoRAConfig(r=4))
        rs = np.random.RandomState(7)
        for k, v in jbase.state_dict().items():
            if k.endswith("lora_B"):
                jbase._set_by_path(k, jnp.asarray(
                    rs.randn(*v.shape).astype(np.float32) * 0.02))
        want = np.asarray(jl(jnp.asarray(ids)))
        jl.save_pretrained(path)
        fresh = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
        ptt.load_jax_state_dict(fresh, params)
        lm = LoRAModel.from_pretrained(fresh, path)
        assert lm.lora_config.r == 4
        got = _np(lm(torch.from_numpy(ids)))
    else:
        tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
        ptt.load_jax_state_dict(tm, params)
        lm = LoRAModel(tm, LoRAConfig(r=4))
        rs = np.random.RandomState(7)
        with torch.no_grad():
            for k, v in lora_state_dict(tm).items():
                if k.endswith("lora_B"):
                    v.copy_(torch.from_numpy(
                        rs.randn(*v.shape).astype(np.float32) * 0.02))
        want = _np(lm(torch.from_numpy(ids)))
        lm.save_pretrained(path)
        from paddle_tpu.checkpoint import load as jax_load
        saved = jax_load(os.path.join(path, "lora_weights.pdparams"))
        assert set(saved) == set(lora_state_dict(tm))
        for k, v in saved.items():
            assert tuple(v.shape) == tuple(lora_state_dict(tm)[k].T.shape)
        pt.seed(0)
        jl = JaxLoRAModel.from_pretrained(JaxLlama(jax_llama_tiny()), path)
        got = np.asarray(jl(jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=ATOL_LOGITS)


def test_lora_mismatched_adapter_rejected(tmp_path):
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    lm = LoRAModel(tm, LoRAConfig(r=4))
    path = str(tmp_path / "adapter")
    lm.save_pretrained(path)
    cfgpath = os.path.join(path, "lora_config.json")
    with open(cfgpath) as f:
        cfg = json.load(f)
    cfg["target_modules"] = [".*o_proj"]
    with open(cfgpath, "w") as f:
        json.dump(cfg, f)
    other = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    with pytest.raises(KeyError, match="do not match"):
        LoRAModel.from_pretrained(other, path)


def test_lora_facade_survives_deepcopy():
    lm = LoRAModel(ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu"),
                   LoRAConfig(r=2))
    lm2 = copy.deepcopy(lm)
    assert lm2.lora_config.r == 2
    ids = torch.from_numpy(_ids())
    np.testing.assert_allclose(_np(lm2(ids)), _np(lm(ids)), atol=1e-6)
    # the copy's hooks are its own: merging it leaves the original alone
    merge_lora(lm2.model)
    assert len(lm.model.model.layers[0].self_attn.q_proj._forward_hooks) == 1


# ------------------------------------------------------------ dropout
def _dropout_model(seed):
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    apply_lora(tm, LoRAConfig(r=4, lora_alpha=8, lora_dropout=0.5),
               generator=ptt.make_generator(seed, "cpu"))
    with torch.no_grad():
        for k, v in lora_state_dict(tm).items():
            if k.endswith("lora_B"):
                v.fill_(0.05)
    return tm


def test_lora_dropout_masks_vary_and_replay(tmp_path):
    """Under the Trainer (SGD, lr 0), each step draws a new mask (the
    losses differ); the same generator seed replays the same masks (the
    counterpart of the JAX package's step-folded keys)."""
    ids = torch.from_numpy(_ids(2, 16))
    runs = []
    for _ in range(2):
        tm = _dropout_model(seed=11)
        tr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.0),
                         _port_args(tmp_path, max_steps=3),
                         train_dataloader=[ids])
        tr.train()
        runs.append([v for _, v in tr.logger.history["loss"]])
    assert runs[0][0] != runs[0][1] != runs[0][2]
    assert runs[0] == runs[1]


def test_lora_dropout_matches_jax_in_distribution():
    """The adapter's dropout keeps each input with probability 1 - p and
    scales the kept ones by 1 / (1 - p), as the JAX package's
    ``F.dropout`` does: over 2^16 inputs both packages keep a share
    within 5 standard deviations of 1 - p, JAX's kept values are
    x / (1 - p), and the port's delta is the sum of its kept inputs over
    (1 - p), its mask replayed from the same generator seed."""
    from paddle_tpu.nn import functional as JF
    n, p = 1 << 16, 0.5
    sd = np.sqrt(n * p * (1 - p))
    x = np.random.RandomState(0).rand(n).astype(np.float32) + 1.0
    jax_y = np.asarray(JF.dropout(jnp.asarray(x), p, training=True,
                                  key=jax.random.PRNGKey(0)))
    kept = jax_y != 0
    assert abs(np.count_nonzero(kept) - n * (1 - p)) < 5 * sd
    np.testing.assert_allclose(jax_y[kept], x[kept] / (1 - p), rtol=1e-6)

    lin = Linear(n, 1, generator=ptt.make_generator(0, "cpu"),
                 device="cpu", has_bias=False)
    inject_lora(lin, LoRAConfig(r=1, lora_alpha=1, lora_dropout=p),
                ptt.make_generator(3, "cpu"))
    with torch.no_grad():
        lin.weight.zero_()
        lin.lora_A.fill_(1.0)
        lin.lora_B.fill_(1.0)
    with torch.no_grad():
        delta = float(lin(torch.from_numpy(x)[None])[0, 0])
    # the replay: A's Kaiming draw came first from the same generator
    g = ptt.make_generator(3, "cpu")
    torch.empty(1, n).uniform_(generator=g)
    keep = torch.empty(n).bernoulli_(1 - p, generator=g)
    assert abs(float(keep.sum()) - n * (1 - p)) < 5 * sd
    want = float((torch.from_numpy(x) * keep).sum() / (1 - p))
    assert delta == pytest.approx(want, rel=1e-5)
    lin.eval()                      # eval: no dropout, the plain sum
    with torch.no_grad():
        plain = float(lin(torch.from_numpy(x)[None])[0, 0])
    assert plain == pytest.approx(float(x.sum()), rel=1e-5)


def test_lora_evaluate_runs_without_dropout(tmp_path):
    """``evaluate()`` runs in eval mode: the adapter's dropout is off, so
    the eval loss is the deterministic loss, equal to the JAX Trainer's
    evaluate on the same weights; the train mode comes back after."""
    jm, _ = _jax_lora_model(dict(r=4, lora_alpha=8, lora_dropout=0.5))
    for k, v in jm.state_dict().items():
        if k.endswith("lora_B"):
            jm._set_by_path(k, jnp.full_like(v, 0.05))
    tm, _ = _port_twin(jm, dict(r=4, lora_alpha=8, lora_dropout=0.5))
    ids = _ids(2, 16)
    with _no_cache_writes():
        jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.0),
                         _jax_args(tmp_path),
                         eval_dataloader=[jnp.asarray(ids)])
        want = jtr.evaluate()
    tr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.0),
                     _port_args(tmp_path),
                     eval_dataloader=[torch.from_numpy(ids)])
    tm.train()
    got = tr.evaluate()
    assert tm.training
    tm.eval()
    with torch.no_grad():
        plain = float(ptt.causal_lm_loss(tm(torch.from_numpy(ids)),
                                         torch.from_numpy(ids)))
    assert abs(got - plain) < 1e-6
    assert abs(got - want) < 1e-5
    jm.eval()
    fn, p = jm.functional()
    assert abs(want - float(jax_causal_lm_loss(fn(p, jnp.asarray(ids)),
                                               jnp.asarray(ids)))) < 1e-5


# ------------------------------------------------------------ tp 2
TP = 2
TP_LORA = dict(r=4, lora_alpha=8, target_modules=ALL7)


def _tp_payload(out_dir):
    jm, _ = _jax_lora_model(TP_LORA, b_scale=0.05)
    ex = _sft_batch(seed=9)
    batch = DataCollatorForSFT(max_length=24, packing=True)(ex)
    return dict(lora=TP_LORA, out_dir=out_dir,
                params={k: np.asarray(v) for k, v in jm.state_dict().items()},
                batch={k: v.numpy() for k, v in batch.items()},
                examples=ex)


def _jax_tp_step(p, out_dir):
    """The JAX SFTTrainer step on a {"tp": 2} mesh of CPU devices, and the
    adapters' partitions there."""
    jenv.init_parallel_env({"tp": TP}, devices=jax.devices()[:TP])
    try:
        jm, _ = _jax_lora_model(TP_LORA, b_scale=0.05)
        parts = {k: m.partition for k, m in jm.param_meta().items()
                 if k.endswith(("lora_A", "lora_B"))}
        jfleet.distributed_model(jm)
        batch = JaxCollator(max_length=24, packing=True)(p["examples"])
        tr = JaxSFTTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-3),
                           JaxArgs(output_dir=out_dir, max_steps=1,
                                   logging_steps=1,
                                   resume_from_checkpoint=False),
                           train_dataloader=[batch])
        tr.train()
        return (parts, [v for _, v in tr.logger.history["loss"]],
                {k: np.asarray(v) for k, v in tr._params.items()})
    finally:
        jenv.init_parallel_env({})


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora_tp")
    p = _tp_payload(str(tmp / "port"))
    handle = start_world("lora_tp", TP, tmp, p, timeout_s=240)
    with _no_cache_writes():
        ref = _jax_tp_step(p, str(tmp / "jax"))
    return handle.result(), ref


def test_lora_tp2_shards_follow_jax_partitions(tp_world):
    """At tp 2 every adapter is split where the JAX ``_adapter_partitions``
    puts it (reversed into the port's layout): a column layer's B on
    out, a row layer's A on in, the other factor whole on each rank."""
    ranks, (parts, _, _) = tp_world
    for r in ranks:
        assert set(r["spec"]) == set(parts)
        for name, spec in r["spec"].items():
            want = parts[name]
            want = tuple(reversed(want)) if want else (None, None)
            assert spec == want, name
            full = tuple(r["adapters"][name].shape)
            local = r["local"][name]
            assert local == tuple(n // TP if a == "tp" else n
                                  for n, a in zip(full, spec)), name


def test_lora_tp2_sft_step_matches_jax(tp_world):
    """One SFTTrainer step at tp 2 (gloo, the adapters and their tp
    collectives): every rank's loss within RTOL_LOSS and its gathered
    adapters within ATOL_ADAPTERS of the JAX step on the tp 2 mesh."""
    ranks, (_, losses, params) = tp_world
    for r in ranks:
        np.testing.assert_allclose([v for _, v in r["loss"]], losses,
                                   rtol=RTOL_LOSS)
        for name, v in r["adapters"].items():
            np.testing.assert_allclose(v.T, params[name], atol=ATOL_ADAPTERS,
                                       rtol=0, err_msg=name)
