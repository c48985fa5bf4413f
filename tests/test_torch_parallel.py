"""The port's sharded training against the JAX package's, in spawned gloo
worlds on the CPU: the tp layers on {"dp": 2, "tp": 2} (forward and
gradients, the JAX package's tests/test_parallel.py cases), fsdp's choice
of dimension against JAX's ``param_shardings`` on {"fsdp": 2, "tp": 2},
the port's partitions (the JAX ones in the port's layout), the Trainer
for 3 steps on {"fsdp": 2, "tp": 2} (ZeRO-3) and on {"dp": 2, "sp": 2}
(ring attention) against the JAX Trainer on the same mesh of 4 virtual
devices, a same-mesh resume bit for bit, and a resume from dp 4 onto dp 2
against the JAX trainer's reconcile. Weights come from the JAX model's
seed through ``load_jax_state_dict``; batches from a numpy seed; fp32."""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.io import DataLoader as JaxLoader
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.parallel import (ColumnParallelLinear as JCol,
                                 RowParallelLinear as JRow,
                                 VocabParallelEmbedding as JEmb)
from paddle_tpu.parallel.sharding import param_shardings as jax_shardings
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.nn.common import partition_of
from paddle_tpu_torch.parallel.sharding import (ShardingError,
                                                validate_partition)
from torch_dist_workers import start_world

WORLD = 4
# layer outputs and gradients: fp32 products of 16-64 terms
TOL = dict(rtol=1e-5, atol=1e-5)
# loss histories: the issue's fp32 bound
RTOL_LOSS = 1e-5
# parameters after 3 AdamW steps of 1e-3: Adam divides by sqrt(v), so an
# entry whose gradient is near zero moves by up to lr on fp32 noise
ATOL_PARAMS = 1e-4
FSDP_MIN = 1024
CFGS = {"fsdp_tp": {}, "dp_sp": {"sequence_parallel": True}}
MESHES = {"fsdp_tp": {"fsdp": 2, "tp": 2}, "dp_sp": {"dp": 2, "sp": 2}}


@contextlib.contextmanager
def _no_cache_writes():
    """The JAX references below compile without writing the persistent
    compilation cache: two processes writing and reading one entry at
    once (a run that spreads this file's tests over workers) can hand a
    reader a torn executable."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


def _jax_params(**cfg):
    pt.seed(0)
    return {k: np.asarray(v) for k, v in
            JaxLlama(jax_llama_tiny(**cfg)).state_dict().items()}


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, ptt.nn.Linear)}


def _jax_layout(model, name, value):
    """A port tensor in the JAX layout (Linear weights transposed)."""
    return value.T if name in _linear_names(model) else value


def test_partitions_are_jax_partitions_in_port_layout():
    """Every Llama parameter's partition is the JAX package's ParamMeta
    partition, reversed for the transposed Linear weights."""
    jm = JaxLlama(jax_llama_tiny())
    meta = jm.param_meta()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    lin = _linear_names(tm)
    for name, p in tm.named_parameters():
        want = meta[name].partition
        if want is not None and name in lin:
            want = tuple(reversed(want))
        assert partition_of(p) == (tuple(want) if want else None), name


def test_validate_partition_rejects_as_jax():
    mesh = types.SimpleNamespace(shape={"tp": 4, "dp": 2})
    for shape, part in (((16, 32), (None, "nope")), ((16, 30), (None, "tp")),
                        ((16,), (None, "tp"))):
        with pytest.raises(ShardingError):
            validate_partition(shape, part, mesh)
    validate_partition((16, 32), (None, "tp"), mesh)
    validate_partition((16, 32), (("dp", "tp"), None), mesh)


# ------------------------------------------------------- the gloo world
def _layer_weights(rs):
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    # the port's layout ([out, in] Linear weights)
    return {"col": {"weight": f(32, 16), "bias": f(32)},
            "row": {"weight": f(16, 32), "bias": f(16)},
            "emb": {"weight": f(64, 16)},
            "col2": {"weight": f(64, 16)}, "row2": {"weight": f(16, 64)}}


def _payload(out_dir):
    rs = np.random.RandomState(0)
    layers = _layer_weights(rs)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return dict(layers=layers, x=f(4, 16), x32=f(4, 32),
                ids=rs.randint(0, 64, (4, 8)), fsdp_min_size=FSDP_MIN,
                params=_jax_params(),
                batches=[rs.randint(0, 256, (4, 32)).astype(np.int64)
                         for _ in range(2)],
                cfgs=CFGS, out_dir=out_dir)


def _jax_layers(p):
    """The JAX tp layers on {"dp": 2, "tp": 2} (4 devices), the same
    weights: outputs and the col -> gelu -> row gradients."""
    L = p["layers"]
    mesh = jenv.init_parallel_env({"dp": 2, "tp": 2},
                                  devices=jax.devices()[:WORLD])
    try:
        col = JCol(16, 32, gather_output=True)
        col.weight, col.bias = jnp.asarray(L["col"]["weight"].T), \
            jnp.asarray(L["col"]["bias"])
        row = JRow(32, 16, input_is_parallel=False)
        row.weight, row.bias = jnp.asarray(L["row"]["weight"].T), \
            jnp.asarray(L["row"]["bias"])
        emb = JEmb(64, 16)
        emb.weight = jnp.asarray(L["emb"]["weight"])
        out = {}
        for key, m, x in (("col", col, p["x"]), ("row", row, p["x32"]),
                          ("emb", emb, p["ids"])):
            jax_shard_layer(m)
            fn, params = m.functional()
            out[key] = np.asarray(jax.jit(fn)(params, jnp.asarray(x)))
        col2 = JCol(16, 64, gather_output=False, has_bias=False)
        col2.weight = jnp.asarray(L["col2"]["weight"].T)
        row2 = JRow(64, 16, has_bias=False)
        row2.weight = jnp.asarray(L["row2"]["weight"].T)
        jax_shard_layer(col2), jax_shard_layer(row2)
        f1, p1 = col2.functional()
        f2, p2 = row2.functional()
        x = jnp.asarray(p["x"])

        def loss(a, b):
            return jnp.sum(f2(b, jax.nn.gelu(f1(a, x))) ** 2)
        g = jax.jit(jax.grad(loss, argnums=(0, 1)))(p1, p2)
        out["tp_grads"] = [np.asarray(g[0]["weight"]).T,
                           np.asarray(g[1]["weight"]).T]
        jenv.init_parallel_env({"fsdp": 2, "tp": 2},
                               devices=jax.devices()[:WORLD])
        jm = JaxLlama(jax_llama_tiny())
        out["shardings"] = {k: tuple(v.spec) for k, v in jax_shardings(
            jm, fsdp_min_size=FSDP_MIN).items()}
        return out, mesh
    finally:
        jenv.init_parallel_env({})


def _jax_args(out_dir, steps, save_steps=0):
    return JaxArgs(output_dir=out_dir, max_steps=steps, logging_steps=1,
                   save_steps=save_steps,
                   resume_from_checkpoint=bool(save_steps))


def _jax_opt():
    return pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              grad_clip=jclip.ClipGradByGlobalNorm(1.0))


def _jax_train(key, p, out_dir):
    """The JAX Trainer on the same mesh of 4 devices, 3 steps."""
    jenv.init_parallel_env(MESHES[key], devices=jax.devices()[:WORLD])
    try:
        pt.seed(0)
        jm = JaxLlama(jax_llama_tiny(**CFGS[key]))
        jfleet.distributed_model(jm, fsdp_min_size=FSDP_MIN)
        tr = JaxTrainer(jm, _jax_opt(), _jax_args(out_dir, 3),
                        train_dataloader=[jnp.asarray(b)
                                          for b in p["batches"]])
        tr.train()
        return ([v for _, v in tr.logger.history["loss"]],
                {k: np.asarray(v) for k, v in tr._params.items()})
    finally:
        jenv.init_parallel_env({})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    p = _payload(str(tmp / "port"))
    handle = start_world("parallel", WORLD, tmp, p, timeout_s=300)
    with _no_cache_writes():
        ref, _ = _jax_layers(p)
        for key in CFGS:
            ref[f"train_{key}"] = _jax_train(key, p,
                                             str(tmp / f"jax_{key}"))
    return handle.result(), ref


@pytest.mark.parametrize("key", ["col", "row", "emb"])
def test_tp_layer_matches_jax(world, key):
    """ColumnParallelLinear (gathered), RowParallelLinear (input split
    here) and VocabParallelEmbedding on {"dp": 2, "tp": 2}."""
    ranks, ref = world
    for r in ranks:
        np.testing.assert_allclose(r[key], ref[key], **TOL)
        assert r["col_local"] == (16, 16)     # the out dim split over tp


def test_tp_gradients_match_jax(world):
    """d/dW of sum(row(gelu(col(x)))^2), each rank on its dp rows: the
    gradients reach ~1e3, and fp32 partial sums in another order (the tp
    all-reduce against XLA's) differ by ~1e-5 of that scale where terms
    cancel, hence a bound relative to the largest entry."""
    ranks, ref = world
    for r in ranks:
        for a, b in zip(r["tp_grads"], ref["tp_grads"]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2e-5 * np.abs(b).max())


def test_fsdp_dimension_matches_jax(world):
    """fsdp lands on the dimension JAX's param_shardings picks (the
    specs compared in the JAX layout), at fsdp_min_size 1024."""
    ranks, ref = world
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    lin = _linear_names(model)
    for name, spec in ranks[0]["shardings"].items():
        spec = tuple(spec) + (None,) * (2 - len(spec)) if name in lin \
            else tuple(spec)
        got = tuple(reversed(spec)) if name in lin else spec
        want = tuple(ref["shardings"][name])
        want = want + (None,) * (len(got) - len(want))
        assert got == want, name


@pytest.mark.parametrize("key", list(CFGS))
def test_trainer_matches_jax_on_mesh(world, key):
    """3 AdamW steps (clip 1.0) on {"fsdp": 2, "tp": 2} at ZeRO-3 and on
    {"dp": 2, "sp": 2} with sequence_parallel: every rank's loss history
    within 1e-5 relative of the JAX Trainer's on the same mesh, and the
    final parameters (gathered) within 1e-5."""
    ranks, ref = world
    want_losses, want_params = ref[f"train_{key}"]
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    for r in ranks:
        got = [v for _, v in r[f"train_{key}"]]
        np.testing.assert_allclose(got, want_losses, rtol=RTOL_LOSS, atol=0)
        for name, value in r[f"params_{key}"].items():
            np.testing.assert_allclose(_jax_layout(model, name, value),
                                       want_params[name], atol=ATOL_PARAMS,
                                       rtol=0, err_msg=name)


def test_same_mesh_resume_is_bitwise(world):
    """{"dp": 2, "sp": 2}: 2 steps saved at step 2, a fresh Trainer on
    the same directory resumes and runs steps 3-4; their losses equal an
    uninterrupted 4-step run's bit for bit, on every rank."""
    ranks, _ = world
    for r in ranks:
        resumed, full = r["resume"]
        assert [s for s, _ in resumed] == [3, 4]
        assert resumed == full[2:]


def test_preemption_on_one_rank_stops_every_rank(world):
    """{"dp": 2, "sp": 2}, logging every 2 steps: a preemption notice on
    rank 1 alone at step 1 is agreed at the logging boundary after step
    2; every rank checkpoints step 2 and exits with the preemption code
    (76), none runs on alone into a collective."""
    ranks, _ = world
    for r in ranks:
        assert r["preempt"] == (76, 2)


def test_grad_scaler_on_mesh(world):
    """fp32 with a GradScaler on {"fsdp": 2, "tp": 2}: at 2^15 the loss
    history is the unscaled run's (a power-of-two scale is exact); at
    2^127 the first step overflows on every rank, which all skip it
    (their parameters are the initial weights) and halve the scale."""
    ranks, _ = world
    params = _jax_params()
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    for r in ranks:
        np.testing.assert_allclose([v for _, v in r["scaled"]],
                                   [v for _, v in r["train_fsdp_tp"]],
                                   rtol=RTOL_LOSS, atol=0)
        scale, after = r["overflow"]
        assert scale == 2.0 ** 126
        for name, value in after.items():
            np.testing.assert_array_equal(_jax_layout(model, name, value),
                                          params[name], err_msg=name)


# ------------------------------------------------------- dp 4 -> dp 2
def _rows():
    return np.random.RandomState(9).randint(0, 256, (64, 16)).astype(
        np.int64)


def _jax_dp4_to_dp2(out_dir):
    rows = _rows()
    res = {}
    for n, steps in ((4, 2), (2, 4)):
        jenv.init_parallel_env({"dp": n}, devices=jax.devices()[:n])
        try:
            pt.seed(0)
            jm = JaxLlama(jax_llama_tiny())
            tr = JaxTrainer(jm, _jax_opt(), _jax_args(out_dir, steps, 2),
                            train_dataloader=JaxLoader(list(rows),
                                                       batch_size=8))
            tr.train()
            res[n] = ([v for _, v in tr.logger.history["loss"]],
                      tr.args.gradient_accumulation_steps)
        finally:
            jenv.init_parallel_env({})
    return res


def test_resume_dp4_onto_dp2_matches_jax(tmp_path):
    """A world of 4 on {"dp": 4} trains 2 steps and saves; a world of 2
    on {"dp": 2} resumes it: the meta records dp 4, the accumulation
    doubles (the JAX reconcile, for the same global batch), the restored
    parameters equal the saved ones, and steps 3-4's losses are within
    1e-5 relative of the JAX trainer doing the same."""
    p = dict(params=_jax_params(), rows=list(_rows()), batch=8,
             fsdp_min_size=FSDP_MIN, out_dir=str(tmp_path / "port"))
    first = start_world("dp4", 4, tmp_path, dict(p, steps=2))
    with _no_cache_writes():
        ref = _jax_dp4_to_dp2(str(tmp_path / "jax"))
    saved = first.result()
    resumed = start_world("dp4", 2, tmp_path, dict(p, steps=4)).result()
    assert saved[0]["meta"]["topology"]["dp"] == 4
    assert saved[0]["meta"]["topology"]["mesh"]["dp"] == 4
    assert saved[0]["restored"] is None
    for r in resumed:
        assert r["restored"] == 2
        for name, value in saved[0]["params"].items():
            np.testing.assert_array_equal(r["at_resume"][name], value)
        assert r["accum"] == ref[2][1] == 2
        assert [s for s, _ in r["losses"]] == [3, 4]
        np.testing.assert_allclose([v for _, v in r["losses"]], ref[2][0],
                                   rtol=RTOL_LOSS, atol=0)
    for r in saved:
        np.testing.assert_allclose([v for _, v in r["losses"]], ref[4][0],
                                   rtol=RTOL_LOSS, atol=0)
