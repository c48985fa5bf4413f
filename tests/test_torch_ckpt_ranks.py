"""Per-rank checkpoint writing: each rank writes the pieces it owns, no
tensor gathered, and rank 0 commits the step once every rank's files are
durable.

In one CPU gloo world of 2 ranks, the tiny Llama through the Trainer
(AdamW, clip 1.0) on {"fsdp": 2} (ZeRO-3: every parameter above 64
elements split), started while the JAX Trainer runs on a 2-device CPU
mesh of the same shape:

- the step saved at 2 restores bit for bit into {"fsdp": 2} and {"tp": 2}
  (each rank reading only the pieces of its own shards) and, whole, at a
  world of one (this process);
- a Trainer resumed from it at {"fsdp": 2} gives the JAX Trainer's
  resumed losses (within ``RTOL_LOSS``);
- during a save, what rank 0 allocates is about its own shards: every
  tensor an op makes during ``save`` is counted (a dispatch mode), and the
  count stays under ``SAVE_SHARE`` of the whole state's bytes; the ranks'
  written bytes add up to the whole state, each byte written once;
- ``verify_step`` covers every rank's files: a flipped byte in rank 1's
  file fails the step, and a strict restore refuses it;
- a step in the earlier layout (rank 0 wrote every tensor whole,
  ``paddle_tpu_torch.step/1``) still restores."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.checkpoint.distributed_ckpt import (
    CheckpointCorruptionError, DistributedCheckpoint, FORMAT_WHOLE)
from torch_dist_workers import start_world

WORLD = 2
FSDP_MIN = 64
RTOL_LOSS = 1e-5
# rank 0's allocations during a save, as a share of the whole state: its
# half of the fsdp shards plus the small replicated tensors it owns
SAVE_SHARE = 0.6


def _params():
    pt.seed(0)
    return {k: np.asarray(v)
            for k, v in JaxLlama(jax_llama_tiny()).state_dict().items()}


def _batches():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 256, (4, 32)).astype(np.int64) for _ in range(2)]


def _jax_resumed(out_dir):
    """The JAX Trainer on {"fsdp": 2}: 2 steps saved at 2, then a new
    Trainer resumed to step 4; the resumed run's losses."""
    jenv.init_parallel_env({"fsdp": WORLD}, devices=jax.devices()[:WORLD])
    try:
        losses = None
        for steps in (2, 4):
            pt.seed(0)
            jm = JaxLlama(jax_llama_tiny())
            jfleet.distributed_model(jm, fsdp_min_size=FSDP_MIN)
            opt = pt.optimizer.AdamW(
                learning_rate=1e-3, weight_decay=0.01,
                grad_clip=jclip.ClipGradByGlobalNorm(1.0))
            tr = JaxTrainer(jm, opt, JaxArgs(output_dir=out_dir,
                                             max_steps=steps,
                                             logging_steps=1, save_steps=2),
                            train_dataloader=[jnp.asarray(b)
                                              for b in _batches()])
            tr.train()
            losses = list(tr.logger.history["loss"])
        return losses
    finally:
        jenv.init_parallel_env({})


def _steps(p):
    """The Trainer's step directory under its output directory."""
    return os.path.join(p["dir"], "checkpoints")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    p = dict(params=_params(), batches=_batches(), fsdp_min_size=FSDP_MIN,
             dir=str(tmp / "port"), scratch=str(tmp / "scratch"))
    handle = start_world("ckpt_ranks", WORLD, tmp, p, timeout_s=300)
    ref = _jax_resumed(str(tmp / "jax"))
    return handle.result(), ref, p


def test_restores_bit_for_bit_on_each_mesh(world):
    """Step 2 into {"fsdp": 2} and {"tp": 2}, this rank's shards read
    alone; and whole at a world of one."""
    ranks, _, p = world
    for r in ranks:
        for key in ("restore_fsdp", "restore_tp"):
            assert r[key] and all(r[key].values()), \
                [k for k, ok in r[key].items() if not ok]
    whole = DistributedCheckpoint(_steps(p)).restore(2)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        elif torch.is_tensor(tree):
            yield prefix[:-1], tree
    got = dict(leaves(whole))
    saved = ranks[0]["saved"]
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k].float().numpy(), v, err_msg=k)


def test_resumed_trainer_matches_the_jax_resume(world):
    ranks, ref, _ = world
    want = [v for s, v in ref if s > 2]
    for r in ranks:
        got = [v for s, v in r["resumed"] if s > 2]
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)


def test_no_rank_gathers_a_tensor_to_save(world):
    ranks, _, _ = world
    total = ranks[0]["total_bytes"]
    assert sum(r["save_bytes"] for r in ranks) == total
    assert ranks[0]["save_new_bytes"] < SAVE_SHARE * total
    assert ranks[0]["save_bytes"] < SAVE_SHARE * total


def test_a_flipped_byte_in_rank_1s_file_fails_the_step(world, tmp_path):
    import shutil
    _, _, p = world
    d = str(tmp_path / "copy")
    shutil.copytree(_steps(p), d)
    ckpt = DistributedCheckpoint(d)
    assert ckpt.verify_step(2) is True
    rank1 = os.path.join(d, "2", "r1")
    name = max(os.listdir(rank1),
               key=lambda n: os.path.getsize(os.path.join(rank1, n)))
    path = os.path.join(rank1, name)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    ckpt = DistributedCheckpoint(d)
    assert ckpt.verify_step(2) is False
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore(2, strict=True)


def test_a_step_in_the_whole_tensor_layout_restores(tmp_path):
    """The layout before per-rank pieces: ``index.json`` naming one file
    a tensor, ``t00000.bin`` its whole raw bytes."""
    d = tmp_path / "old"
    step = d / "7"
    step.mkdir(parents=True)
    a = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    b = torch.tensor(5, dtype=torch.int64)
    tree = {"params": {"w": {"__tensor__": "t00000.bin",
                             "dtype": "bfloat16", "shape": [3, 4]}},
            "step": {"__tensor__": "t00001.bin", "dtype": "int64",
                     "shape": []},
            "lr": 0.5}
    for t, name in ((a, "t00000.bin"), (b, "t00001.bin")):
        (step / name).write_bytes(
            t.reshape(-1).view(torch.uint8).numpy().tobytes())
    (step / "index.json").write_text(json.dumps(
        {"format": FORMAT_WHOLE, "tree": tree}))
    got = DistributedCheckpoint(str(d)).restore(7)
    assert torch.equal(got["params"]["w"], a)
    assert torch.equal(got["step"], b) and got["lr"] == 0.5
