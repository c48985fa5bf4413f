"""The port's expert parallelism and its MoE families on a mesh, against the
JAX package's on the same mesh of 4 virtual CPU devices, fp32: in one
spawned gloo world of 4 ranks, ``MoEMLP`` on {"ep": 2, "dp": 2} (output,
aux loss, the gradient of every parameter and of the input, the routing
decisions exactly, each rank's [E / ep, ...] expert shards), Qwen2-MoE
and DeepSeek-V2 forward on {"dp": 2, "tp": 2}, the Trainer for 3 steps
with ``moe_lm_loss`` on {"ep": 2, "dp": 2} and with
``deepseek_mtp_loss`` on {"dp": 2, "tp": 2}, and a run saved on {"ep":
2, "dp": 2} resumed without a mesh. Weights come from the JAX model's
seed through ``load_jax_state_dict``; inputs from a numpy seed."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import deepseek_v2 as jax_ds
from paddle_tpu.models import qwen2_moe as jax_qwen
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
import paddle_tpu_torch as ptt
from torch_dist_workers import family_trainer, start_world

WORLD = 4
# layer outputs and gradients, logits: fp32 (as tests/test_torch_parallel)
TOL = dict(rtol=1e-5, atol=1e-5)
RTOL_LOSS = 1e-5
ATOL_PARAMS = 1e-4
EP_DP, DP_TP = {"ep": 2, "dp": 2}, {"dp": 2, "tp": 2}
# a capacity under the tokens' demand: some choices drop
MLP_KW = dict(hidden_size=32, intermediate_size=32, num_experts=4, top_k=2,
              capacity_factor=0.75, num_shared_experts=1,
              shared_intermediate_size=32, use_shared_expert_gate=True)
CFGS = {"qwen": dict(shared_expert_gate=True),
        "deepseek": dict(num_nextn_predict_layers=1)}
JAX_FAMILY = {"qwen": (jax_qwen.Qwen2MoeForCausalLM, jax_qwen.qwen2_moe_tiny),
              "deepseek": (jax_ds.DeepseekV2ForCausalLM,
                           jax_ds.deepseek_v2_tiny)}


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


def _jax_model(kind):
    cls, cfg = JAX_FAMILY[kind]
    pt.seed(0)
    return cls(cfg(**CFGS[kind]))


def _state(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def _jax_loss(kind):
    if kind == "deepseek":
        def loss(fn, p, b):
            logits, mtp = fn(p, b, return_mtp=True)
            return jax_ds.deepseek_mtp_loss(logits, mtp, b, weight=0.1)
        return loss

    def loss(fn, p, b):
        logits, aux = fn(p, b, return_aux=True)
        return jax_qwen.moe_lm_loss(logits, aux, b)
    return loss


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, ptt.nn.Linear)}


def _port_model(kind):
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import deepseek_v2 as ds
    if kind == "deepseek":
        return ds.DeepseekV2ForCausalLM(ds.deepseek_v2_tiny(**CFGS[kind]),
                                        device="cpu")
    return models.Qwen2MoeForCausalLM(models.qwen2_moe_tiny(**CFGS[kind]),
                                      device="cpu")


def _payload(out_dir):
    rs = np.random.RandomState(0)
    pt.seed(0)
    mlp = jmoe.MoEMLP(**MLP_KW)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return dict(mlp_kw=MLP_KW, mlp=_state(mlp), x=f(4, 8, 32),
                go=f(4, 8, 32), cfgs=CFGS,
                params={k: _state(_jax_model(k)) for k in CFGS},
                ids=rs.randint(1, 256, (4, 16)).astype(np.int64),
                batches=[rs.randint(1, 256, (4, 16)).astype(np.int64)
                         for _ in range(2)], out_dir=out_dir)


def _jax_mlp(p):
    """The JAX MoEMLP on {"ep": 2, "dp": 2}: y, aux, the gradients of
    sum(y * go) + aux, and the dispatch tensor."""
    jenv.init_parallel_env(EP_DP, devices=jax.devices()[:WORLD])
    try:
        pt.seed(0)
        mlp = jmoe.MoEMLP(**MLP_KW)
        jax_shard_layer(mlp, fsdp_min_size=1 << 30)
        fn, params = mlp.functional()
        x, go = jnp.asarray(p["x"]), jnp.asarray(p["go"])

        def obj(prm, x):
            y, aux = fn(prm, x, return_aux=True)
            return jnp.sum(y * go) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(dict(params), x)
        logits = x.reshape(-1, 32) @ params["gate"]
        dispatch, _, _ = jmoe.top_k_routing(
            logits, mlp.top_k, mlp.capacity(logits.shape[0]))
        return dict(y=np.asarray(y), aux=float(aux), dx=np.asarray(gx),
                    grads={k: np.asarray(v) for k, v in gp.items()},
                    dispatch=np.asarray(dispatch, np.float32))
    finally:
        jenv.init_parallel_env({})


def _jax_forward(kind, p):
    jenv.init_parallel_env(DP_TP, devices=jax.devices()[:WORLD])
    try:
        jm = _jax_model(kind)
        jax_shard_layer(jm, fsdp_min_size=1 << 30)
        fn, params = jm.functional()
        return np.asarray(jax.jit(fn)(params, jnp.asarray(p["ids"])))
    finally:
        jenv.init_parallel_env({})


def _jax_train(kind, mesh, p, out_dir, steps, save_steps=0, n_dev=WORLD):
    jenv.init_parallel_env(mesh, devices=jax.devices()[:n_dev])
    try:
        jm = _jax_model(kind)
        jfleet.distributed_model(jm, fsdp_min_size=1 << 30)
        opt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 grad_clip=jclip.ClipGradByGlobalNorm(1.0))
        tr = JaxTrainer(jm, opt, JaxArgs(
            output_dir=out_dir, max_steps=steps, logging_steps=1,
            save_steps=save_steps, resume_from_checkpoint=bool(save_steps)),
            loss_fn=_jax_loss(kind),
            train_dataloader=[jnp.asarray(b) for b in p["batches"]])
        tr.train()
        return ([v for _, v in tr.logger.history["loss"]],
                {k: np.asarray(v) for k, v in tr._params.items()},
                tr.args.gradient_accumulation_steps)
    finally:
        jenv.init_parallel_env({})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    p = _payload(str(tmp / "port"))
    handle = start_world("ep", WORLD, tmp, p, timeout_s=420)
    ref = {}
    with _no_cache_writes():
        ref["mlp"] = _jax_mlp(p)
        for kind in CFGS:
            ref[f"fwd_{kind}"] = _jax_forward(kind, p)
        # the Qwen2-MoE run saves step 2, which the resume continues
        shared = str(tmp / "jax_resume")
        ref["train_qwen"] = _jax_train("qwen", EP_DP, p, shared, 3,
                                       save_steps=2)
        ref["train_deepseek"] = _jax_train("deepseek", DP_TP, p,
                                           str(tmp / "jax_ds"), 3)
        ref["resume"] = _jax_train("qwen", {"dp": 1}, p, shared, 4,
                                   save_steps=2, n_dev=1)
    ranks = handle.result()
    # the port's save on {"ep": 2, "dp": 2}, resumed here: no mesh
    losses, params = family_trainer(
        "qwen", CFGS["qwen"], p["params"]["qwen"], p["batches"],
        str(tmp / "port" / "resume"), 4, save_steps=2)
    return ranks, ref, (losses, params)


def test_moe_mlp_matches_jax_on_ep_dp(world):
    """MoEMLP on {"ep": 2, "dp": 2}, each dp rank on its rows, with a
    capacity that drops choices: the output (gathered), the aux loss,
    the input's gradient and every parameter's (the aux counted once
    over the ranks that split the data, none summed over ep) against
    the JAX MoEMLP's on the same mesh; each rank holds 2 of the 4
    experts."""
    ranks, ref, _ = world
    want = ref["mlp"]
    for r in ranks:
        got = r["mlp"]
        np.testing.assert_allclose(got["y"], want["y"], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **TOL)
        np.testing.assert_allclose(got["dx"], want["dx"], **TOL)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][k], **TOL,
                                       err_msg=k)
        for k in ("w_gate", "w_up", "w_down"):
            assert got["local"][k][0] == 2
        assert got["local"]["gate"] == (32, 4)


def test_routing_decisions_match_jax_exactly(world):
    """The dispatch of the whole call's tokens (gathered over dp): the
    same (token, expert, slot) triples as the JAX router's, drops
    included."""
    ranks, ref, _ = world
    want = ref["mlp"]["dispatch"]
    assert want.sum() < 32 * 2          # the capacity dropped some
    for r in ranks:
        np.testing.assert_array_equal(r["dispatch"], want)


@pytest.mark.parametrize("kind", list(CFGS))
def test_forward_on_dp_tp_matches_jax(world, kind):
    """Qwen2-MoE and DeepSeek-V2 (MLA) logits on {"dp": 2, "tp": 2}, each
    dp rank on its rows: the heads split over tp, the routing over every
    row of the batch, as the JAX model computes on the same mesh."""
    ranks, ref, _ = world
    for r in ranks:
        np.testing.assert_allclose(r[f"fwd_{kind}"], ref[f"fwd_{kind}"],
                                   **TOL)


@pytest.mark.parametrize("kind", list(CFGS))
def test_trainer_matches_jax(world, kind):
    """3 AdamW steps (clip 1.0): Qwen2-MoE with moe_lm_loss on {"ep": 2,
    "dp": 2}, DeepSeek-V2 with deepseek_mtp_loss on {"dp": 2, "tp": 2};
    every rank's losses within 1e-5 relative of the JAX Trainer's on the
    same mesh, the parameters within 1e-4."""
    ranks, ref, _ = world
    want_losses, want_params, _ = ref[f"train_{kind}"]
    lin = _linear_names(_port_model(kind))
    for r in ranks:
        losses, params = r[f"train_{kind}"]
        np.testing.assert_allclose([v for _, v in losses], want_losses,
                                   rtol=RTOL_LOSS, atol=0)
        for k, v in params.items():
            np.testing.assert_allclose(v.T if k in lin else v,
                                       want_params[k], atol=ATOL_PARAMS,
                                       rtol=0, err_msg=k)


def test_resume_ep_without_mesh_matches_jax(world):
    """Saved at step 2 on {"ep": 2, "dp": 2}, resumed on one process
    without a mesh: steps 3-4 (the accumulation doubled by the
    reconcile) and the final parameters match the JAX trainer resuming
    its own save on one device."""
    _, ref, (losses, params) = world
    want_losses, want_params, want_accum = ref["resume"]
    assert want_accum == 2
    assert [s for s, _ in losses] == [3, 4]
    np.testing.assert_allclose([v for _, v in losses], want_losses,
                               rtol=RTOL_LOSS, atol=0)
    lin = _linear_names(_port_model("qwen"))
    for k, v in params.items():
        np.testing.assert_allclose(v.T if k in lin else v, want_params[k],
                                   atol=ATOL_PARAMS, rtol=0, err_msg=k)
