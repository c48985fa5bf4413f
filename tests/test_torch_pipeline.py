"""The port's pipeline parallelism against the JAX package's, fp32 on the
CPU: ``_build_schedule``'s tables; ``pipeline_functional``'s loss and
flat gradients on the counterparts of tests/test_pipeline_1f1b.py (1F1B
on {"pp": 2, "dp": 2} at M = 1 and 3, on {"pp": 2, "tp": 2}, the
interleaved schedule at vpp 2 for two M and with tp, a custom
``logits_loss``, and Qwen2-MoE on {"pp": 2, "ep": 2} plain and
interleaved), each against the JAX ``pipeline_functional`` on the same
mesh of 4 virtual devices; ``pipeline_apply``; the JAX refusals; the
Trainer's pp and vpp steps for 3 steps against the JAX Trainer; and a
resume saved on {"pp": 2, "dp": 2} and continued on {"dp": 4}. The
multi-rank cases run in one spawned gloo world of 4 ranks. Weights come
from the JAX model's seed through ``load_jax_state_dict``; batches from
a numpy seed."""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as JaxQwenMoe
from paddle_tpu.models.qwen2_moe import qwen2_moe_tiny as jax_moe_tiny
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu.parallel import pipeline_interleaved as jinter
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch import models
from paddle_tpu_torch.parallel import pipeline, pipeline_interleaved
from torch_dist_workers import start_world

WORLD = 4
# gradients and outputs: fp32 sums of the same terms in another order
TOL = dict(rtol=1e-5, atol=1e-5)
RTOL_LOSS = 1e-5
# parameters after 3 AdamW steps of 1e-3 (as tests/test_torch_parallel.py)
ATOL_PARAMS = 1e-4
LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_attention_heads=4, num_key_value_heads=2)
MOE = dict(LLAMA, moe_intermediate_size=32, num_experts=4,
           num_experts_per_tok=2, first_k_dense_replace=0,
           num_shared_experts=0)
PP_DP, PP_TP, PP_EP = {"pp": 2, "dp": 2}, {"pp": 2, "tp": 2}, \
    {"pp": 2, "ep": 2}
CASES = [
    dict(name="1f1b_M1", kind="llama", L=2, M=1, mesh=PP_DP, seed=2),
    dict(name="1f1b_M3", kind="llama", L=4, M=3, mesh=PP_DP, seed=1),
    dict(name="1f1b_tp", kind="llama", L=4, M=3, mesh=PP_TP, seed=5),
    dict(name="vpp_M3", kind="llama", L=4, M=3, vpp=2, mesh=PP_DP, seed=9),
    dict(name="vpp_M4", kind="llama", L=4, M=4, vpp=2, mesh=PP_DP, seed=9),
    dict(name="vpp_tp", kind="llama", L=4, M=2, vpp=2, mesh=PP_TP,
         seed=11),
    dict(name="logits_loss", kind="llama", L=2, M=2, mesh=PP_DP, seed=7,
         smooth=True),
    dict(name="moe_ep", kind="moe", L=2, M=2, mesh=PP_EP, seed=1),
    dict(name="moe_ep_vpp", kind="moe", L=4, M=2, vpp=2, mesh=PP_EP,
         seed=4),
]
# the Trainer's cases: Llama L 4 on {"pp": 2, "dp": 2}, accumulation 2
TRAIN_CFG = dict(LLAMA, num_hidden_layers=4)


@contextlib.contextmanager
def _no_cache_writes():
    """The JAX references compile without writing the persistent
    compilation cache (two processes on one entry can tear it)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


def _cfg(c):
    return dict(MOE if c["kind"] == "moe" else LLAMA,
                num_hidden_layers=c["L"])


def _jax_model(kind, cfg):
    pt.seed(0)
    if kind == "moe":
        return JaxQwenMoe(jax_moe_tiny(**cfg))
    return JaxLlama(jax_llama_tiny(**cfg))


def _state(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, ptt.nn.Linear)}


def _port_model(kind, cfg):
    if kind == "moe":
        return models.Qwen2MoeForCausalLM(models.qwen2_moe_tiny(**cfg),
                                          device="cpu")
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**cfg), device="cpu")


def _jax_layout(lin, name, value):
    return value.T if name in lin else value


def smoothed_ce(logits, labels, eps=0.1):
    v = logits.shape[-1]
    lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    tgt = jax.nn.one_hot(labels[:, 1:], v) * (1 - eps) + eps / v
    return -jnp.mean(jnp.sum(tgt * lp, axis=-1))


# ------------------------------------------------------------ no world
@pytest.mark.parametrize("pp,v,M", [(2, 1, 1), (2, 2, 4), (4, 2, 8),
                                    (2, 3, 5)])
def test_build_schedule_tables_equal_jax(pp, v, M):
    got, T, K = pipeline_interleaved._build_schedule(pp, v, M)
    want, T_j, K_j = jinter._build_schedule(pp, v, M)
    assert (T, K) == (T_j, K_j)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_validate_pp_mesh_refuses_as_jax():
    from jax.sharding import Mesh
    no_pp = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("x",))
    with pytest.raises(ValueError, match="pp") as jerr:
        jpipe.validate_pp_mesh(no_pp)
    with pytest.raises(ValueError, match="pp") as terr:
        pipeline.validate_pp_mesh(types.SimpleNamespace(shape={"x": 4}))
    assert str(terr.value) == str(jerr.value).replace(
        str(no_pp.shape), "{'x': 4}")
    pipeline.validate_pp_mesh(types.SimpleNamespace(shape={"pp": 1}))


@pytest.mark.parametrize("kind,cfg,pp,vpp", [
    ("llama", dict(num_hidden_layers=4), 3, 1),
    ("llama", dict(num_hidden_layers=4), 2, 4),
    ("llama", dict(num_hidden_layers=4, tie_word_embeddings=True), 2, 1),
    ("moe", dict(num_hidden_layers=4, first_k_dense_replace=1), 2, 1)])
def test_pipeline_functional_refuses_as_jax(kind, cfg, pp, vpp):
    """L % (pp * vpp), tied embeddings and dense first layers: the same
    ValueError, word for word."""
    base = MOE if kind == "moe" else LLAMA
    jm = _jax_model(kind, dict(base, **cfg))
    tm = _port_model(kind, dict(base, **cfg))
    with pytest.raises(ValueError) as jerr:
        jm.pipeline_functional(pp, vpp=vpp)
    with pytest.raises(ValueError) as terr:
        tm.pipeline_functional(pp, vpp=vpp)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------- the gloo world
def _payload(out_dir):
    params = {f"{c['kind']}{c['L']}": _state(_jax_model(c["kind"], _cfg(c)))
              for c in CASES}
    params["trainer"] = _state(_jax_model("llama", TRAIN_CFG))
    cases = []
    for c in CASES:
        toks = np.random.RandomState(c["seed"]).randint(
            0, 128, (c["M"], 2, 16)).astype(np.int64)
        cases.append(dict(c, cfg=_cfg(c), tokens=toks,
                          params=f"{c['kind']}{c['L']}"))
    rs = np.random.RandomState(3)
    batches = [rs.randint(0, 128, (4, 16)).astype(np.int64)
               for _ in range(2)]
    apply = (rs.randn(2, 8, 8).astype(np.float32),
             rs.randn(3, 2, 8).astype(np.float32))
    return dict(cases=cases, params=params, cfg=TRAIN_CFG, batches=batches,
                apply=apply, out_dir=out_dir)


def _jax_case(c):
    """The JAX pipeline_functional on the case's mesh of 4 devices."""
    jenv.init_parallel_env(c["mesh"], devices=jax.devices()[:WORLD])
    try:
        jm = _jax_model(c["kind"], c["cfg"])
        if c["mesh"].get("tp", 1) > 1 or c["mesh"].get("ep", 1) > 1:
            jax_shard_layer(jm, fsdp_min_size=1 << 30)
        _, params = jm.functional()
        vag = jax.jit(jm.pipeline_functional(
            c["mesh"]["pp"], logits_loss=smoothed_ce if c.get("smooth")
            else None, vpp=c.get("vpp", 1)))
        loss, grads = vag(dict(params), jnp.asarray(c["tokens"]))
        return float(loss), {k: np.asarray(v) for k, v in grads.items()}
    finally:
        jenv.init_parallel_env({})


def _jax_opt():
    return pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              grad_clip=jclip.ClipGradByGlobalNorm(1.0))


def _jax_trainer(mesh, p, out_dir, steps, save_steps=0, vpp=1, **kw):
    jenv.init_parallel_env(mesh, devices=jax.devices()[:WORLD])
    try:
        jm = _jax_model("llama", p["cfg"])
        args = JaxArgs(output_dir=out_dir, max_steps=steps,
                       logging_steps=1, save_steps=save_steps,
                       resume_from_checkpoint=bool(save_steps),
                       virtual_pp_degree=vpp,
                       gradient_accumulation_steps=2)
        tr = JaxTrainer(jm, _jax_opt(), args, train_dataloader=[
            jnp.asarray(b) for b in p["batches"]], **kw)
        tr.train()
        return ([v for _, v in tr.logger.history["loss"]],
                tr.args.gradient_accumulation_steps,
                {k: np.asarray(v) for k, v in tr._params.items()})
    finally:
        jenv.init_parallel_env({})


def _jax_apply(p):
    """The JAX pipeline_apply (GPipe forward) on {"pp": 2, "dp": 2}."""
    jenv.init_parallel_env(PP_DP, devices=jax.devices()[:WORLD])
    try:
        w, mbs = p["apply"]
        return np.asarray(jax.jit(lambda w, x: jpipe.pipeline_apply(
            lambda prm, y: jnp.tanh(y @ prm["w"]), {"w": w}, x))(
                jnp.asarray(w), jnp.asarray(mbs)))
    finally:
        jenv.init_parallel_env({})


def _jax_refusals(p, out_dir):
    """The JAX trainer's pp path refusing, on {"pp": 2, "dp": 2}."""
    jenv.init_parallel_env(PP_DP, devices=jax.devices()[:WORLD])
    out = {}
    try:
        for key in ("frozen", "scaler", "loss_fn", "dict"):
            jm = _jax_model("llama", p["cfg"])
            kw = {}
            if key == "frozen":
                jm.model.embed_tokens.stop_gradient_()
            if key == "scaler":
                kw["scaler"] = pt.amp.GradScaler()
            if key == "loss_fn":
                kw["loss_fn"] = lambda fn, prm, b: 0.0
            batches = [{"input_ids": jnp.zeros((2, 16), jnp.int32)}] \
                if key == "dict" else [jnp.zeros((2, 16), jnp.int32)]
            tr = JaxTrainer(jm, pt.optimizer.SGD(), JaxArgs(
                output_dir=f"{out_dir}/{key}", max_steps=1,
                resume_from_checkpoint=False), train_dataloader=batches,
                **kw)
            try:
                tr.train()
                out[key] = None
            except (ValueError, TypeError) as e:
                out[key] = (type(e).__name__, str(e))
    finally:
        jenv.init_parallel_env({})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    p = _payload(str(tmp / "port"))
    handle = start_world("pipeline", WORLD, tmp, p, timeout_s=420)
    ref = {}
    with _no_cache_writes():
        for c in p["cases"]:
            ref[c["name"]] = _jax_case(c)
        ref["apply"] = _jax_apply(p)
        ref["refusals"] = _jax_refusals(p, str(tmp / "jax_refuse"))
        # the 1F1B run saves step 2, which the resume continues on dp 4
        shared = str(tmp / "jax_resume")
        for vpp in (1, 2):
            ref[f"train_vpp{vpp}"] = _jax_trainer(
                PP_DP, p, shared if vpp == 1 else str(tmp / "jax_vpp2"), 3,
                save_steps=2 if vpp == 1 else 0, vpp=vpp)
        ref["resume"] = _jax_trainer({"dp": 4}, p, shared, 4, save_steps=2)
    return handle.result(), ref


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_pipeline_functional_matches_jax(world, case):
    """The loss and every flat gradient of ``pipeline_functional`` (each
    rank's whole gradient, after the data axes' sum) against the JAX
    ``pipeline_functional`` on the same mesh, on every rank."""
    ranks, ref = world
    c = next(c for c in CASES if c["name"] == case)
    want_loss, want = ref[case]
    lin = _linear_names(_port_model(c["kind"], _cfg(c)))
    for r in ranks:
        loss, grads = r[case]
        np.testing.assert_allclose(loss, want_loss, rtol=RTOL_LOSS, atol=0)
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(_jax_layout(lin, k, g), want[k],
                                       **TOL, err_msg=f"{case} {k}")


def test_trainer_pp_refusals_match_jax(world):
    """Frozen parameters, a GradScaler, a whole-model loss_fn and a dict
    batch on a pp mesh: the JAX trainer's error types and messages."""
    ranks, ref = world
    assert all(v is not None for v in ref["refusals"].values())
    for r in ranks:
        assert r["refusals"] == ref["refusals"]


@pytest.mark.parametrize("vpp", [1, 2])
def test_trainer_pp_matches_jax(world, vpp):
    """3 AdamW steps (clip 1.0) on {"pp": 2, "dp": 2} with gradient
    accumulation 2 (two microbatches through the schedule), 1F1B and
    interleaved: every rank's losses within 1e-5 relative of the JAX
    Trainer's on the same mesh, the parameters within 1e-4."""
    ranks, ref = world
    want_losses, _, want_params = ref[f"train_vpp{vpp}"]
    lin = _linear_names(_port_model("llama", TRAIN_CFG))
    for r in ranks:
        losses, params = r[f"train_vpp{vpp}"]
        np.testing.assert_allclose([v for _, v in losses], want_losses,
                                   rtol=RTOL_LOSS, atol=0)
        for k, v in params.items():
            np.testing.assert_allclose(_jax_layout(lin, k, v),
                                       want_params[k], atol=ATOL_PARAMS,
                                       rtol=0, err_msg=k)


def test_resume_pp_onto_dp4_matches_jax(world):
    """Saved at step 2 on {"pp": 2, "dp": 2}, resumed on {"dp": 4}: the
    accumulation halves (the JAX reconcile) and steps 3-4's losses and
    the final parameters match the JAX trainer doing the same."""
    ranks, ref = world
    want_losses, want_accum, want_params = ref["resume"]
    lin = _linear_names(_port_model("llama", TRAIN_CFG))
    for r in ranks:
        losses, accum, params = r["resume"]
        assert accum == want_accum == 1
        assert [s for s, _ in losses] == [3, 4]
        np.testing.assert_allclose([v for _, v in losses], want_losses,
                                   rtol=RTOL_LOSS, atol=0)
        for k, v in params.items():
            np.testing.assert_allclose(_jax_layout(lin, k, v),
                                       want_params[k], atol=ATOL_PARAMS,
                                       rtol=0, err_msg=k)


def test_pipeline_apply_matches_jax(world):
    """The GPipe forward of ``pipeline_apply`` (two tanh stages, 3
    microbatches) on {"pp": 2, "dp": 2}: every rank's outputs equal the
    JAX function's on the same mesh; ``stack_stage_params`` stacks."""
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r["apply"], ref["apply"], **TOL)
    stacked = pipeline.stack_stage_params([{"w": torch.ones(2)},
                                           {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)
    assert torch.equal(stacked["w"][1], torch.zeros(2))


def test_pp_with_sp_is_refused_as_the_jax_package_cannot_run_it(monkeypatch):
    """pp with sp > 1 raises ``NotImplementedError`` when the step runs:
    the JAX package's own step does not run on that mesh (its ring's
    ``shard_map`` nested in the pipeline's raises under ``jit``; without
    ``sequence_parallel`` XLA deadlocks), so the port keeps the refusal
    and its message says so."""
    import paddle_tpu_torch.models.llama as llama
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    vag = model.pipeline_functional(2)
    monkeypatch.setattr(llama, "axis_size",
                        lambda axis: 2 if axis == "sp" else 1)
    flat = {k: v.detach() for k, v in model.named_parameters()}
    with pytest.raises(NotImplementedError,
                       match="does not run this mesh either"):
        vag(flat, torch.zeros(2, 1, 8, dtype=torch.long))
