"""The port's training path against the JAX package's.

The JAX model is built from its seed, its weights cross as numpy through
``load_jax_state_dict``, and both trainers see the same numpy batches, in
fp32 on the CPU. The dense path (``llama_tiny``, seq 16) and the flash
path (head_dim 64, seq 128; the JAX side in Pallas interpret mode, the
port through ``FlashAttentionFunction``'s plain backward) must give the
same loss history. The satellite modules (clip, LR schedules,
cross_entropy, recompute, the prefetcher) are held against their JAX
counterparts or against their own contracts."""
import copy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.io.device_prefetch import DevicePrefetcher
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.recompute import POLICIES, recompute
from paddle_tpu_torch.optimizer import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.utils.profiler import StepTimer, device_peak_flops

# loss histories: the same fp32 training, summed in another order by XLA
# and torch, over a few optimizer steps
RTOL_LOSS = 1e-4
# parameters after one SGD step
ATOL_PARAMS = 1e-5
# fp32 scalar math (clip, lr, cross_entropy)
ATOL_FP32 = 1e-6

FLASH_CFG = dict(hidden_size=256, num_attention_heads=4,
                 num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed=0, **overrides):
    pt.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**overrides))
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**overrides), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _batches(n, b, s, vocab=256, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (b, s)).astype(np.int32) for _ in range(n)]


def _port_args(tmp_path, **kw):
    return ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                 graceful_shutdown=False, **kw)


def _jax_args(tmp_path, **kw):
    return JaxArgs(output_dir=str(tmp_path / "jax"),
                   resume_from_checkpoint=False, **kw)


@pytest.mark.parametrize("path", ["dense", "flash"])
def test_loss_history_matches_jax_trainer(tmp_path, monkeypatch, path):
    """AdamW through both Trainers from the same weights and batches:
    dense path 5 steps (llama_tiny, seq 16), flash path 3 steps (head_dim
    64, seq 128, JAX in interpret mode); loss histories within 1e-4
    relative."""
    if path == "flash":
        monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        overrides, steps, shape = FLASH_CFG, 3, (2, 128)
    else:
        overrides, steps, shape = {}, 5, (4, 16)
    jm, tm = _pair(seed=3, **overrides)
    batches = _batches(2, *shape, seed=4)
    kw = dict(max_steps=steps, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-2),
                     _jax_args(tmp_path, **kw),
                     train_dataloader=[jnp.asarray(x) for x in batches])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2),
                      _port_args(tmp_path, **kw), train_dataloader=batches)
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)
    assert got[-1] < got[0]


def test_sgd_step_matches_jax_parameters(tmp_path):
    """One SGD step with global-norm clipping: every parameter within
    1e-5 of the JAX trainer's."""
    jm, tm = _pair(seed=5)
    batches = _batches(1, 4, 16, seed=6)
    kw = dict(max_steps=1, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(
        learning_rate=0.5, grad_clip=jclip.ClipGradByGlobalNorm(1.0)),
        _jax_args(tmp_path, **kw),
        train_dataloader=[jnp.asarray(x) for x in batches])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(
        learning_rate=0.5, grad_clip=tclip.ClipGradByGlobalNorm(1.0)),
        _port_args(tmp_path, **kw), train_dataloader=batches)
    ttr.train()
    ref = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(ref, {k: np.asarray(v)
                                  for k, v in jtr._params.items()})
    want = dict(ref.named_parameters())
    moved = 0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0, err_msg=name)
        moved += int(not torch.equal(p, want[name]))
    assert moved > 0


def test_four_micro_batches_equal_one_big_batch(tmp_path):
    """accum=4 over micro-batches == one batch of 4x size (the JAX
    package's tests/test_trainer.py pin)."""
    _, tm = _pair(seed=5)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    batch = _batches(1, 8, 16, seed=1)

    def run(accum):
        tm.load_state_dict(init)
        args = _port_args(tmp_path, max_steps=1, logging_steps=1,
                          gradient_accumulation_steps=accum)
        ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.1), args,
                    train_dataloader=batch).train()
        return {k: v.clone() for k, v in tm.state_dict().items()}

    p1, p4 = run(1), run(4)
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p4[k].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_trainer_overfits(tmp_path):
    """Memorise one batch (the JAX package's overfit pin); metrics land
    in the JSONL log and the observability artifacts in the run dir."""
    _, tm = _pair(seed=7)
    args = _port_args(tmp_path, max_steps=40, logging_steps=5)
    tr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=3e-3), args,
                     train_dataloader=_batches(1, 4, 16))
    tr.train()
    hist = tr.logger.history["loss"]
    assert hist[-1][1] < hist[0][1] * 0.5
    assert len(tr.logger.history["tokens_per_sec"]) == 8
    assert tr.logger.history["mfu"][-1][1] == 0.0  # the CPU has no peak
    runs = tmp_path / "port" / "runs"
    assert {"metrics.jsonl", "metrics.prom", "trace_0.json"} <= {
        p.name for p in runs.iterdir()}


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_recompute_gives_the_same_grads(policy):
    """Per-layer recompute (config.recompute) changes memory, not math:
    the loss and every gradient equal those without recompute, on the
    flash path."""
    grads = []
    for on in (False, True):
        _, tm = _pair(seed=8, recompute=on, recompute_policy=policy,
                      **FLASH_CFG)
        ids = torch.from_numpy(_batches(1, 1, 128, seed=9)[0]).long()
        loss = ptt.causal_lm_loss(tm(ids), ids)
        grads.append([loss] + list(torch.autograd.grad(
            loss, list(tm.parameters()))))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_train_branch_grads_match_jax_with_segments_and_window(monkeypatch):
    """The no-cache (train) flash branch with packed segment ids and a
    sliding window on the second layer: the loss and every parameter's
    gradient match jax.grad of the JAX model (interpret mode), fp32,
    within 1e-4."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    from paddle_tpu.models.llama import causal_lm_loss as jax_loss
    jm, tm = _pair(seed=15, sliding_window=48, max_window_layers=1,
                   **FLASH_CFG)
    ids = _batches(1, 2, 128, seed=16)[0]
    seg = np.ones((2, 128), np.int32)
    seg[:, 50:] = 2
    seg[:, 100:120] = 3
    seg[:, 120:] = 0
    pure, params = jm.functional()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss(pure(p, jnp.asarray(ids),
                                segment_ids=jnp.asarray(seg)),
                           jnp.asarray(ids)))(dict(params))
    tids = torch.from_numpy(ids).long()
    loss = ptt.causal_lm_loss(tm(tids, segment_ids=torch.from_numpy(seg)),
                              tids)
    tgrads = dict(zip(dict(tm.named_parameters()), torch.autograd.grad(
        loss, list(tm.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    # the JAX grads in the port's layout (Linear weights transposed)
    ref = ptt.LlamaForCausalLM(ptt.llama_tiny(**FLASH_CFG), device="cpu")
    ptt.load_jax_state_dict(ref, {k: np.asarray(v)
                                  for k, v in jgrads.items()})
    for name, want in ref.named_parameters():
        np.testing.assert_allclose(tgrads[name].numpy(),
                                   want.detach().numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_recompute_policies_match_jax_names():
    from paddle_tpu.nn.recompute import POLICIES as JAX_POLICIES
    assert set(POLICIES) == set(JAX_POLICIES)
    x = torch.randn(3, 5, requires_grad=True)
    w = torch.randn(5, 5)
    for policy in POLICIES:
        y = recompute(lambda t: torch.tanh(t @ w) @ w, x, policy=policy)
        g, = torch.autograd.grad(y.sum(), x)
        g0, = torch.autograd.grad((torch.tanh(x @ w) @ w).sum(), x)
        assert torch.equal(g, g0), policy


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_checkpoint_wrapper_replays_and_matches_jax(policy):
    """``checkpoint_wrapper`` on a module replays its forward in the
    backward and leaves its gradients as they were; on a function its
    gradient equals ``jax.grad`` of the JAX wrapper's (fp32, 1e-6)."""
    from paddle_tpu.nn.recompute import checkpoint_wrapper as jax_wrapper
    from paddle_tpu_torch.nn.recompute import checkpoint_wrapper
    rs = np.random.RandomState(11)
    x, w = rs.randn(3, 5).astype(np.float32), rs.randn(5, 5).astype(np.float32)

    def fn(t, m, w):
        return m.tanh(t @ w) @ w
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jg = jax.grad(lambda t: jax_wrapper(lambda u: fn(u, jnp, jw),
                                        policy=policy)(t).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    g, = torch.autograd.grad(checkpoint_wrapper(
        lambda u: fn(u, torch, tw), policy=policy)(tx).sum(), tx)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL_FP32)

    torch.manual_seed(0)
    plain = torch.nn.Sequential(torch.nn.Linear(5, 5), torch.nn.Tanh(),
                                torch.nn.Linear(5, 5))
    wrapped = copy.deepcopy(plain)
    calls = []
    wrapped[0].register_forward_hook(lambda *_: calls.append(1))
    checkpoint_wrapper(wrapped, policy=policy)
    grads = []
    for m in (plain, wrapped):
        grads.append(torch.autograd.grad(m(tx).pow(2).sum(),
                                         list(m.parameters())))
    assert len(calls) == 2   # the forward, then its replay in the backward
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL_FP32, rtol=0)


def test_frozen_parameters_get_no_state(tmp_path):
    """requires_grad=False parameters: no gradient, no optimizer state,
    unchanged by training."""
    _, tm = _pair(seed=10)
    tm.model.embed_tokens.weight.requires_grad_(False)
    before = tm.model.embed_tokens.weight.clone()
    tr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2),
                     _port_args(tmp_path, max_steps=2, logging_steps=1),
                     train_dataloader=_batches(1, 2, 16))
    tr.train()
    assert "model.embed_tokens.weight" not in tr._opt_state["slots"]
    assert len(tr._opt_state["slots"]) == len(list(tm.parameters())) - 1
    assert torch.equal(tm.model.embed_tokens.weight, before)
    assert not torch.equal(tm.lm_head.weight,
                           _pair(seed=10)[1].lm_head.weight)


def test_multi_precision_keeps_fp32_masters(tmp_path):
    """bf16 parameters with multi_precision: the update runs on fp32
    masters and the parameters are the masters cast down; evaluate runs
    without gradients."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(dtype=torch.bfloat16),
                              device="cpu")
    opt = ptt.optimizer.AdamW(learning_rate=1e-2, multi_precision=True)
    tr = ptt.Trainer(tm, opt, _port_args(tmp_path, max_steps=2,
                                         logging_steps=1, eval_steps=2),
                     train_dataloader=_batches(2, 2, 16),
                     eval_dataloader=_batches(1, 2, 16, seed=3))
    tr.train()
    for name, p in tm.named_parameters():
        master = tr._opt_state["master"][name]
        assert master.dtype == torch.float32 and p.dtype == torch.bfloat16
        assert torch.equal(master.to(torch.bfloat16), p)
    assert np.isfinite(tr.logger.history["eval_loss"][0][1])


@pytest.mark.parametrize("field,value", [
    ("save_steps", 5), ("graceful_shutdown", True), ("hang_timeout_s", 9.0),
    ("compile_cache_dir", "cache"), ("aot_warmup", True),
    ("virtual_pp_degree", 2)])
def test_next_slice_machinery_raises(tmp_path, field, value):
    _, tm = _pair()
    args = _port_args(tmp_path)
    setattr(args, field, value)
    with pytest.raises(NotImplementedError, match="next training slice"):
        ptt.Trainer(tm, ptt.optimizer.SGD(), args, train_dataloader=[])


def test_training_arguments_keep_the_jax_defaults():
    import dataclasses
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxArgs)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(ptt.TrainingArguments)}
    assert port_fields == jax_fields


# ----------------------------------------------------------- satellites
def _grads(seed=0):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(4, 5).astype(np.float32) * 3,
            "b": rs.randn(7).astype(np.float32)}


@pytest.mark.parametrize("name,args", [
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (100.0,)),
    ("ClipGradByNorm", (2.0,)), ("ClipGradByValue", (0.5,)),
    ("ClipGradByValue", (1.0, -0.2))])
def test_clip_matches_jax(name, args):
    g = _grads()
    want = getattr(jclip, name)(*args)({k: jnp.asarray(v)
                                        for k, v in g.items()})
    got = getattr(tclip, name)(*args)({k: torch.from_numpy(v.copy())
                                       for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL_FP32, rtol=1e-6)
    np.testing.assert_allclose(
        float(tclip.global_norm({k: torch.from_numpy(v)
                                 for k, v in g.items()})),
        float(jclip.global_norm({k: jnp.asarray(v) for k, v in g.items()})),
        rtol=1e-6)


OPTIMIZERS = [
    ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, use_nesterov=True,
                      weight_decay=0.01)),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.01)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1,
                   apply_decay_param_fun=lambda n: n != "b")),
    ("AdamW", dict(learning_rate=0.01, multi_precision=True)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_apply_matches_jax(name, kw):
    """The functional core: init + 3 applies on the same parameters and
    gradients as the JAX optimizer, fp32, within 1e-6."""
    rs = np.random.RandomState(13)
    params = {"a": rs.randn(4, 5).astype(np.float32),
              "b": rs.randn(7).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = getattr(pt.optimizer, name)(**kw)
    topt = getattr(ptt.optimizer, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js, jnp.asarray(step))
        topt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                   step)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL_FP32, rtol=1e-6, err_msg=k)


def test_optimizer_step_facade_reads_grads():
    """``Optimizer(parameters=module).step()`` after ``backward()`` equals
    ``apply`` on the same grads; ``clear_grad`` drops them; a missing
    grad raises."""
    _, tm = _pair(seed=14)
    _, ref = _pair(seed=14)
    ids = torch.from_numpy(_batches(1, 2, 16)[0]).long()
    opt = ptt.optimizer.AdamW(learning_rate=1e-2, parameters=tm)
    with pytest.raises(ValueError, match="backward"):
        opt.step()
    ptt.causal_lm_loss(tm(ids), ids).backward()
    opt.step()
    params = dict(ref.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(
        ptt.causal_lm_loss(ref(ids), ids), list(params.values()))))
    ropt = ptt.optimizer.AdamW(learning_rate=1e-2)
    ropt.apply(params, grads, ropt.init(params), 0)
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p, params[name], atol=1e-6, rtol=0)
    opt.clear_grad()
    assert all(p.grad is None for p in tm.parameters())


SCHEDULES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4)),
    ("PiecewiseDecay", dict(boundaries=[3, 6], values=[0.1, 0.05, 0.01])),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.9)),
    ("NaturalExpDecay", dict(learning_rate=0.1, gamma=0.3)),
    ("InverseTimeDecay", dict(learning_rate=0.1, gamma=0.5)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=4, cycle=True,
                             power=2.0)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=7)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=3)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=2,
                                         T_mult=2)),
    ("StepDecay", dict(learning_rate=0.1, step_size=3)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[2, 5])),
    ("LambdaDecay", dict(learning_rate=0.1, lr_lambda=lambda s: 0.5 ** s)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=10)),
    ("ReduceOnPlateau", dict(learning_rate=0.1)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, kw):
    want = getattr(jlr, name)(**kw)
    got = getattr(tlr, name)(**kw)
    for step in range(12):
        np.testing.assert_allclose(got.value_at(step),
                                   float(want.value_at(jnp.asarray(step))),
                                   rtol=1e-5, atol=1e-9, err_msg=str(step))
    assert got.get_lr() == pytest.approx(want.get_lr(), rel=1e-5)


def test_linear_warmup_into_cosine_matches_jax():
    """The schedule of the slice's chip run: 2 warm-up steps into a
    cosine over 10."""
    want = jlr.LinearWarmup(jlr.CosineAnnealingDecay(3e-4, T_max=10),
                            warmup_steps=2)
    got = tlr.LinearWarmup(tlr.CosineAnnealingDecay(3e-4, T_max=10),
                           warmup_steps=2)
    for step in range(14):
        np.testing.assert_allclose(got.value_at(step),
                                   float(want.value_at(step)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(label_smoothing=0.1), dict(weight=True), dict(ignore=True),
    dict(ignore=True, label_smoothing=0.2), dict(soft_label=True),
    dict(soft_label=True, label_smoothing=0.1), dict(bf16=True)],
    ids=["mean", "sum", "none", "smooth", "weight", "ignore",
         "ignore-smooth", "soft", "soft-smooth", "bf16-logits"])
def test_cross_entropy_matches_jax(kw):
    rs = np.random.RandomState(11)
    logits = rs.randn(3, 5, 7).astype(np.float32) * 2
    label = rs.randint(0, 7, (3, 5)).astype(np.int64)
    kw = dict(kw)
    if kw.pop("ignore", False):
        label[0, :2] = -100
    if kw.pop("soft_label", False):
        kw["soft_label"] = True
        label = rs.dirichlet(np.ones(7), (3, 5)).astype(np.float32)
    jw = tw = None
    if kw.pop("weight", False):
        w = rs.rand(7).astype(np.float32)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if kw.pop("bf16", False):
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    want = JF.cross_entropy(jl, jnp.asarray(label), weight=jw, **kw)
    got = F.cross_entropy(tl, torch.from_numpy(label), weight=tw, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_FP32, rtol=1e-6)


def test_causal_lm_loss_matches_jax():
    from paddle_tpu.models.llama import causal_lm_loss as jax_loss
    rs = np.random.RandomState(12)
    logits = rs.randn(2, 6, 9).astype(np.float32)
    labels = rs.randint(0, 9, (2, 6))
    np.testing.assert_allclose(
        float(ptt.causal_lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels))),
        float(jax_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


class _Loader:
    """A list of batches with a resumable cursor (``state_dict``)."""

    def __init__(self, n):
        self.batches = _batches(n, 2, 4)
        self.pos = 0

    def __iter__(self):
        self.pos = 0
        for b in self.batches:
            self.pos += 1
            yield b

    def state_dict(self):
        return {"pos": self.pos}


def test_prefetcher_reports_the_consumer_position():
    """The producer runs ahead by the buffer depth; state_dict() is the
    position of the last batch handed over, batches come out in order as
    tensors, prep applied."""
    loader = _Loader(6)
    pf = DevicePrefetcher(loader, prep=lambda b: b * 2, depth=2,
                          device="cpu")
    it = iter(pf)
    first = next(it)
    assert isinstance(first, torch.Tensor)
    assert torch.equal(first, torch.from_numpy(loader.batches[0] * 2))
    next(it)
    assert pf.state_dict() == {"pos": 2}
    rest = list(it)
    assert len(rest) == 4 and pf.state_dict() == {"pos": 6}
    pf.close()
    assert pf.state_dict() == {"pos": 6}


def test_prefetcher_propagates_a_loader_error():
    """An exception in the producer thread reaches the consumer at the
    batch where it happened, after the batches before it."""
    def broken():
        yield np.zeros(2)
        raise KeyError("bad sample")

    pf = DevicePrefetcher(broken(), depth=2, device="cpu")
    it = iter(pf)
    assert float(next(it)[0]) == 0.0
    with pytest.raises(KeyError, match="bad sample"):
        next(it)
    pf.close()


def test_step_timer_and_peak_table():
    t = StepTimer(flops_per_token=1e9, peak_flops=1e12)
    t.start()
    t.stop(tokens=1000)
    assert t.mfu > 0 and t.tokens_per_sec > 0
    assert StepTimer(flops_per_token=1e9, peak_flops=0.0).mfu_at(1e6) == 0.0
    assert device_peak_flops() == (0.0 if not torch.cuda.is_available()
                                   else device_peak_flops())


def test_training_modules_keep_jax_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.trainer, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.recompute, "
            "paddle_tpu_torch.io.device_prefetch, "
            "paddle_tpu_torch.utils.profiler\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
