"""The port's distributed layer against the JAX package's: the strategy's
mesh shape, the mesh's axes and degree-1 axes, and, in one spawned gloo
world of 4 ranks on {"dp": 2, "sp": 2}, every collective over named axes
(values and gradients, ppermute and all_to_all included) against the JAX
collectives under shard_map on 4 of the 8 virtual devices, the eager
forms with an injected transient fault retried, the sampler's defaults
under the mesh and fleet. Then the launcher: a CPU world of 2 through
``python -m paddle_tpu_torch.distributed.launch --cpu``, and a dead rank
that ends the job with its exit code instead of hanging it."""
import contextlib
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu_torch.distributed as tdist
from paddle_tpu.distributed import collective as jc
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.utils.jax_compat import shard_map
from paddle_tpu_torch.distributed import fleet as tfleet
from torch_dist_workers import start_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# fp32 sums of 2 to 4 values, in another order than XLA's
TOL = dict(rtol=1e-6, atol=1e-6)
KINDS = ("gather", "scatter", "a2a", "perm", "bcast")


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


@pytest.mark.parametrize("hybrid", [
    {"mp_degree": 4, "dp_degree": 2},
    {"sharding_degree": 2, "sep_degree": 2, "dp_degree": 1},
    {"dp_degree": 8, "pp_degree": 1, "ep_degree": 1},
])
def test_strategy_mesh_shape_matches_jax(hybrid):
    assert tfleet.DistributedStrategy(hybrid_configs=hybrid).mesh_shape() \
        == jfleet.DistributedStrategy(hybrid_configs=hybrid).mesh_shape()
    for mod in (tfleet, jfleet):
        with pytest.raises(ValueError):
            mod.DistributedStrategy(hybrid_configs={"bogus": 2}).mesh_shape()


def test_exports_and_axes():
    assert tdist.HYBRID_AXES == jenv.HYBRID_AXES
    for name in ("init_parallel_env", "get_mesh", "all_reduce", "all_gather",
                 "reduce_scatter", "all_to_all", "ppermute", "broadcast",
                 "eager_all_reduce", "eager_all_gather", "eager_broadcast",
                 "init_distributed", "fleet", "ReduceOp", "supervise"):
        assert hasattr(tdist, name), name
    assert vars(tdist.ReduceOp).keys() >= {"SUM", "MAX", "MIN", "PROD",
                                           "AVG"}


# ------------------------------------------------------- the gloo world
def _payload():
    rs = np.random.RandomState(0)
    x = rs.randn(WORLD, 2, 4, 4).astype(np.float32)
    shapes = {"gather": (2, 8, 4), "scatter": (2, 2, 4), "a2a": (2, 8, 2),
              "perm": (2, 4, 4), "bcast": (2, 4, 4)}
    gw = {k: rs.randn(WORLD, *s).astype(np.float32)
          for k, s in shapes.items()}
    return {"x": x, "w": rs.randn(WORLD, 3).astype(np.float32), "gw": gw}


def _jax_refs(p, mesh):
    """Per-device results of the JAX collectives (the devices in rank
    order: the JAX mesh lays devices out row-major over HYBRID_AXES, as
    the port's DeviceMesh lays out ranks)."""
    spec = P(("dp", "sp"))
    x = jnp.asarray(p["x"].reshape(-1, 4, 4))
    fwd = {"gather": lambda v: jc.all_gather(v, "sp", axis=1),
           "scatter": lambda v: jc.reduce_scatter(v, "sp", axis=1),
           "a2a": lambda v: jc.all_to_all(v, "sp", split_axis=2,
                                          concat_axis=1),
           "perm": lambda v: jc.ppermute(v, [(0, 1), (1, 0)], "sp"),
           "bcast": lambda v: jc.broadcast(v, 1, "sp")}
    red = {op: (lambda v, op=op: jc.all_reduce(v, op, "sp"))
           for op in ("sum", "max", "min", "avg")}
    red["prod"] = lambda v: jc.all_reduce(jnp.abs(v) + 0.5, "prod", "sp")
    red["both"] = lambda v: jc.all_reduce(v, "sum", ("dp", "sp"))

    def smap(f):
        return shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec,
                         check_vma=False)

    def per_device(a):
        a = np.asarray(a)
        return a.reshape(WORLD, -1, *a.shape[1:])

    def all_refs(x, gws):
        out = {"reduce": {k: smap(f)(x) for k, f in red.items()},
               "fwd": {}, "grads": {}}
        for k, f in fwd.items():
            y, vjp = jax.vjp(smap(f), x)
            out["fwd"][k] = y
            out["grads"][k] = vjp(gws[k])[0]
        return out
    gws = {k: jnp.asarray(v.reshape(-1, *v.shape[2:]))
           for k, v in p["gw"].items()}
    refs = jax.jit(all_refs)(x, gws)
    return jax.tree.map(per_device, refs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    p = _payload()
    handle = start_world("distributed", WORLD,
                         tmp_path_factory.mktemp("dist"), p)
    mesh = jenv.init_parallel_env({"dp": 2, "sp": 2},
                                  devices=jax.devices()[:WORLD])
    try:
        with _no_cache_writes():
            ref = _jax_refs(p, mesh)
        shape = dict(mesh.shape)
        coords = [dict(zip(mesh.axis_names, np.argwhere(
            np.vectorize(lambda d: d.id)(mesh.devices) == dev.id)[0]))
            for dev in jax.devices()[:WORLD]]
    finally:
        jenv.init_parallel_env({})
    return handle.result(), ref, shape, coords, p


def test_mesh_axes_match_jax(world):
    """The mesh's shape (all six axes, degree-1 ones included), each
    rank's coordinates (as the JAX mesh places device r) and sizes."""
    ranks, _, shape, coords, _ = world
    for r, out in enumerate(ranks):
        assert out["shape"] == shape
        assert out["sizes"] == {a: shape[a] for a in tdist.HYBRID_AXES}
        for a in ("dp", "sp", "tp"):
            assert out["coords"][a] == coords[r][a]
        assert out["axis"] == (coords[r]["sp"], 4)


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg", "prod", "both"])
def test_all_reduce_matches_jax(world, op):
    ranks, ref, _, _, p = world
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["reduce"][op], ref["reduce"][op][r],
                                   **TOL)
        # over an axis of degree 1: the identity
        np.testing.assert_array_equal(out["reduce"]["tp"], p["x"][r])


@pytest.mark.parametrize("kind", KINDS)
def test_collective_and_gradient_match_jax(world, kind):
    """all_gather / reduce_scatter / all_to_all / ppermute / broadcast
    over "sp": each rank's value, and the gradient of sum(y * w) with
    respect to its input (the JAX transposes: reduce_scatter, all_gather,
    the swapped all_to_all, the inverse permutation, the psum to src)."""
    ranks, ref, _, _, _ = world
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["fwd"][kind], ref["fwd"][kind][r],
                                   **TOL)
        np.testing.assert_allclose(out["grads"][kind],
                                   ref["grads"][kind][r], **TOL)


def test_eager_forms_retry_and_agree(world):
    """eager_all_reduce over dp survives one injected collective_fail on
    every rank (retried); with PADDLE_TPU_COLLECTIVE_RETRIES=1 the fault
    raises CollectiveError; eager all_gather and broadcast give the
    shards' concatenation and the source's shard."""
    ranks, _, _, coords, p = world
    w = p["w"]
    for r, out in enumerate(ranks):
        dp = [i for i in range(WORLD) if coords[i]["sp"] == coords[r]["sp"]]
        sp = [i for i in range(WORLD) if coords[i]["dp"] == coords[r]["dp"]]
        np.testing.assert_allclose(out["eager"], w[dp].sum(0), **TOL)
        np.testing.assert_array_equal(out["eager_gather"],
                                      np.concatenate(w[sp], axis=0))
        np.testing.assert_array_equal(out["eager_bcast"], w[dp[1]])
        assert out["no_retry"] == "raised"


def test_sampler_defaults_and_fleet(world):
    """DistributedBatchSampler's defaults under the mesh are the batch
    coordinate (dp degree 2, the rank's dp index; the sp ranks of one dp
    index read the same batches); fleet.init installs the strategy's mesh
    and reports the world; clear_mesh uninstalls it."""
    ranks, _, shape, coords, _ = world
    for r, out in enumerate(ranks):
        nranks, local, first = out["sampler"]
        assert (nranks, local) == (2, coords[r]["dp"])
        assert first == [coords[r]["dp"], coords[r]["dp"] + 2]
        assert out["fleet"] == (shape, WORLD, r, r == 0)
        assert out["has_mesh"] is False


# --------------------------------------------------------- the launcher
_SCRIPT = textwrap.dedent('''
    import os, sys, torch
    from paddle_tpu_torch.distributed import all_reduce, fleet, get_rank
    out, mode = sys.argv[1], sys.argv[2]
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"dp_degree": 2}))
    if mode == "die" and get_rank() == 1:
        sys.exit(3)
    t = torch.tensor([float(get_rank() + 1)])
    s = all_reduce(t, "sum", "dp")
    with open(os.path.join(out, f"rank{get_rank()}.txt"), "w") as f:
        f.write(f"{get_rank()} {get_rank('dp')} {s.item()}")
''')


def _launch(tmp_path, mode, timeout=120):
    script = tmp_path / "job.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--cpu", "--timeout", str(timeout), str(script),
         str(tmp_path), mode], env=env, timeout=timeout + 30,
        capture_output=True, text=True)
    return rc, time.monotonic() - t0


def test_launch_cpu_world(tmp_path):
    """Two ranks on the CPU over gloo: each sees its rank and dp index,
    and the all-reduce over dp sums both."""
    rc, _ = _launch(tmp_path, "ok")
    assert rc.returncode == 0, rc.stderr[-3000:]
    for r in range(2):
        got = (tmp_path / f"rank{r}.txt").read_text().split()
        assert got == [str(r), str(r), "3.0"]


def test_launch_dead_rank_ends_the_job(tmp_path):
    """Rank 1 exits 3 while rank 0 waits in a collective: the launcher
    stops rank 0 and returns 3, well inside the job's timeout."""
    rc, secs = _launch(tmp_path, "die")
    assert rc.returncode == 3, rc.stderr[-3000:]
    assert not (tmp_path / "rank0.txt").exists()
    assert secs < 90


_PORT_SCRIPT = textwrap.dedent('''
    import errno, os, socket, sys
    out = sys.argv[1]
    port = int(os.environ["MASTER_PORT"])
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            held = "free"
        except OSError as e:
            held = "held" if e.errno == errno.EADDRINUSE else str(e)
    import torch
    from paddle_tpu_torch.distributed import all_reduce, fleet, get_rank
    fleet.init(strategy=fleet.DistributedStrategy(
        hybrid_configs={"dp_degree": 2}))
    s = all_reduce(torch.tensor([1.0]), "sum", "dp")
    with open(os.path.join(out, f"rank{get_rank()}.txt"), "w") as f:
        f.write(f"{held} {s.item()}")
''')


def test_launch_holds_the_rendezvous_port_before_any_rank_starts(tmp_path):
    """The launcher binds the rendezvous store's port before it starts a
    rank and holds it for the job (the ranks join as clients), so no
    other process can take the port between its choice and rank 0's
    bind: every rank finds it held, and the world still forms."""
    script = tmp_path / "port_job.py"
    script.write_text(_PORT_SCRIPT)
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--cpu", "--timeout", "120", str(script),
         str(tmp_path)], env=dict(os.environ, PYTHONPATH=ROOT), timeout=150,
        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr[-3000:]
    for r in range(2):
        assert (tmp_path / f"rank{r}.txt").read_text().split() == \
            ["held", "2.0"]
