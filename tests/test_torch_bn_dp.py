"""BatchNorm on a mesh that splits the batch, against the JAX package.

The JAX layer normalises a global array, so on a dp mesh its batch
statistics are the global batch's (``paddle_tpu/nn/norm.py``: "SyncBatchNorm
== BatchNorm here"). A port rank holds its own rows: its BatchNorm
all-reduces the per-channel sums over the data axes. In one CPU gloo world
of 2 ranks ({"dp": 2}), against the JAX package on a 2-device CPU mesh
(or on the whole batch, for an eager forward):

- ResNet (``resnet_tiny``) and DBNet (``dbnet_tiny``): an eager
  train-mode forward on each rank's half of the batch leaves the running
  statistics the JAX layer leaves on the whole batch; ``Trainer(loss_fn=
  ...)``, SGD, 3 steps: the loss histories, every parameter, and the
  buffers (left where they were, as under the JAX Trainer);
- ``SyncBatchNorm``: its output and the gradients of the input, weight
  and bias, each rank's rows against the JAX rows, the weight's and
  bias's summed over the ranks.

Tolerances are the vision tests': ``RTOL_LOSS`` for loss histories,
``ATOL_PARAMS`` for parameters after the steps, ``ATOL`` for outputs,
statistics and gradients of one forward (fp32 sums over 2-16 k values)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import ppocr as jocr
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import functional as JF
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from torch_dist_workers import start_world

DP = 2
ATOL = 1e-5
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5
# SGD steps: the single-device tests' rates (DBNet's sigmoid(50 (P - T))
# is steep; see tests/test_torch_ocr.py)
LR = {"resnet": 0.01, "dbnet": 1e-3}


def _jittered(jm, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in jm.state_dict().items():
        v = np.asarray(v)
        sd[k] = np.asarray(rs.uniform(0.5, 1.5, v.shape)
                           if k.endswith("_variance")
                           else v + scale * rs.randn(*v.shape), np.float32)
    return sd


def _jax_model(name, params):
    pt.seed(0)
    jm = (jresnet.ResNet(jresnet.resnet_tiny()) if name == "resnet"
          else jocr.DBNet(jocr.dbnet_tiny()))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in params.items()})
    return jm


def _jax_loss(name):
    if name == "resnet":
        return lambda fn, p, b: JF.cross_entropy(fn(p, b["x"]), b["labels"])
    return lambda fn, p, b: jocr.db_loss(fn(p, b["x"]), b["shrink"],
                                         b["mask"], b["thresh"], b["tmask"])


def _payload(out):
    rs = np.random.RandomState(30)
    p = {"out": out, "lr": LR}
    pt.seed(31)
    p["resnet"] = dict(
        params=_jittered(jresnet.ResNet(jresnet.resnet_tiny()), 32),
        batch=dict(x=rs.randn(4, 3, 64, 64).astype(np.float32),
                   labels=rs.randint(0, 10, 4).astype(np.int64)))
    pt.seed(33)
    b, h = 4, 64
    p["dbnet"] = dict(
        params=_jittered(jocr.DBNet(jocr.dbnet_tiny()), 34),
        batch=dict(x=rs.randn(b, 3, h, h).astype(np.float32),
                   shrink=(rs.rand(b, h, h) < 0.2).astype(np.float32),
                   mask=(rs.rand(b, h, h) < 0.9).astype(np.float32),
                   thresh=rs.uniform(0.3, 0.7, (b, h, h)).astype(np.float32),
                   tmask=(rs.rand(b, h, h) < 0.5).astype(np.float32)))
    p["sync"] = dict(x=rs.randn(6, 3, 5, 4).astype(np.float32),
                     w=rs.randn(6, 3, 5, 4).astype(np.float32))
    return p


def _jax_reference(p, out):
    ref = {}
    for name in ("resnet", "dbnet"):
        batch = p[name]["batch"]
        jm = _jax_model(name, p[name]["params"])
        jm.train()
        jm(jnp.asarray(batch["x"]))
        ref[f"{name}_eager"] = {k: np.asarray(v) for k, v in
                                jm.state_dict().items()
                                if k.endswith(("_mean", "_variance"))}
        jenv.init_parallel_env({"dp": DP}, devices=jax.devices()[:DP])
        try:
            jm = _jax_model(name, p[name]["params"])
            jfleet.distributed_model(jm)
            tr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=LR[name]),
                            JaxArgs(output_dir=os.path.join(out, name),
                                    max_steps=3, logging_steps=1,
                                    resume_from_checkpoint=False),
                            loss_fn=_jax_loss(name),
                            train_dataloader=[{k: jnp.asarray(v)
                                               for k, v in batch.items()}])
            tr.train()
            ref[f"{name}_losses"] = [v for _, v in tr.logger.history["loss"]]
            ref[f"{name}_params"] = {k: np.asarray(v)
                                     for k, v in tr._params.items()}
        finally:
            jenv.init_parallel_env({})
    x, w = jnp.asarray(p["sync"]["x"]), jnp.asarray(p["sync"]["w"])
    c = x.shape[1]

    def f(x, weight, bias):
        y, m, v = JF.batch_norm(x, jnp.zeros(c), jnp.ones(c), weight, bias,
                                training=True)
        return (y * w).sum(), (y, m, v)
    (_, (y, m, v)), (gx, gw, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(x, jnp.ones(c), jnp.zeros(c))
    ref["sync"] = {k: np.asarray(a) for k, a in dict(
        y=y, gx=gx, gw=gw, gb=gb, mean=m, var=v).items()}
    return ref


def _port_layout(name, loaded, params):
    """The JAX Trainer's parameters in the port's layout (its Linear
    weights transposed), through a port model that loads them."""
    from paddle_tpu_torch.models import (DBNet, ResNet, dbnet_tiny,
                                         resnet_tiny)
    model = (ResNet(resnet_tiny(), device="cpu") if name == "resnet"
             else DBNet(dbnet_tiny(), device="cpu"))
    ptt.load_jax_state_dict(model, {**loaded, **params})
    return {k: v.detach().numpy() for k, v in model.named_parameters()
            if k in params}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn_dp")
    p = _payload(str(tmp / "port"))
    handle = start_world("bn_dp", DP, tmp, p, timeout_s=300)
    ref = _jax_reference(p, str(tmp / "jax"))
    return handle.result(), ref, p


@pytest.mark.parametrize("name", ("resnet", "dbnet"))
def test_eager_forward_moves_the_running_stats_by_the_global_batch(world,
                                                                   name):
    ranks, ref, _ = world
    for r in ranks:
        assert set(r[f"{name}_eager"]) == set(ref[f"{name}_eager"])
        for k, v in ref[f"{name}_eager"].items():
            np.testing.assert_allclose(r[f"{name}_eager"][k], v, atol=ATOL,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ("resnet", "dbnet"))
def test_trainer_at_dp2_matches_the_jax_trainer(world, name):
    """Losses, every parameter after 3 SGD steps, and the buffers (left
    where they were, as under the JAX Trainer); two collectives a
    BatchNorm forward."""
    ranks, ref, p = world
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}_losses"], ref[f"{name}_losses"],
                                   rtol=RTOL_LOSS, atol=0)
        state = r[f"{name}_state"]
        for k, v in _port_layout(name, p[name]["params"],
                                 ref[f"{name}_params"]).items():
            np.testing.assert_allclose(state[k], v, atol=ATOL_PARAMS, rtol=0,
                                       err_msg=k)
        buffers = [k for k in state if k.endswith(("_mean", "_variance"))]
        assert buffers
        for k in buffers:
            np.testing.assert_array_equal(state[k], p[name]["params"][k])
        assert r[f"{name}_reductions"] > 0
    assert ranks[0][f"{name}_state"].keys() == ranks[1][f"{name}_state"].keys()


def test_sync_batch_norm_at_dp2_matches_jax(world):
    """Each rank's rows of the output and of the input's gradient; the
    weight's and bias's gradients summed over the ranks; the running
    statistics moved by the global batch's."""
    ranks, ref, _ = world
    want = ref["sync"]
    for key in ("y", "gx"):
        got = np.concatenate([r["sync"][key] for r in ranks])
        np.testing.assert_allclose(got, want[key], atol=ATOL, rtol=0,
                                   err_msg=key)
    for key in ("gw", "gb"):
        np.testing.assert_allclose(sum(r["sync"][key] for r in ranks),
                                   want[key], atol=ATOL, rtol=0, err_msg=key)
    for r in ranks:
        np.testing.assert_allclose(r["sync"]["mean"], want["mean"],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["sync"]["var"], want["var"], atol=ATOL,
                                   rtol=0)
