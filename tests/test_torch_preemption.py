"""Preemption-safe training in the port, mirroring the JAX package's
tests/test_preemption.py (its single-device cases) on the port's
Trainer, samplers, checkpoints and supervisor: the resumable sampler
state (the same classes and cases, on ``paddle_tpu_torch.io``); an
injected ``preempt`` checkpoints the exact step and exits
``PREEMPTED_RC``, and a fresh Trainer resumes to the uninterrupted run's
final loss within 1e-6 by an O(1) sampler restore; SIGTERM latches the
same way; the supervisor restarts a preempted child for free and bounds
a storm; a divergence rollback does not rewind the sampler; a resume
waits for an in-flight asynchronous save; the hang exit (in a
subprocess) checkpoints and exits ``hang_exit_code``; the step
checkpoints' integrity (checksum fallback, strict restore,
``max_to_keep``, bf16/fp16 round trip); and the meta sidecar equals the
JAX trainer's on the same run."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.checkpoint.distributed_ckpt import (
    CheckpointCorruptionError, DistributedCheckpoint, auto_resume)
from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                 RandomSampler, SequenceSampler)
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.shutdown import PREEMPTED_RC, GracefulShutdown

pytestmark = pytest.mark.chaos
# the JAX test's bound on the resumed run's final loss
ATOL_RESUME = 1e-6


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# =========================================================== sampler state
class TestSamplerState:
    def test_seeded_sampler_reshuffles_per_epoch(self):
        """Regression: a supplied generator seed
        must not pin every epoch to the identical permutation — the
        epoch counter folds into the seed."""
        s = RandomSampler(list(range(32)), generator=123)
        e0, e1, e2 = list(s), list(s), list(s)
        assert sorted(e0) == sorted(e1) == sorted(e2) == list(range(32))
        assert e0 != e1 and e1 != e2          # epochs differ...
        s2 = RandomSampler(list(range(32)), generator=123)
        assert [list(s2) for _ in range(3)] == [e0, e1, e2]  # ...reproducibly
        # and an unseeded sampler still reshuffles per epoch
        u = RandomSampler(list(range(32)))
        assert list(u) != list(u)

    def test_random_sampler_state_roundtrip_mid_epoch(self):
        src = list(range(20))
        ref = RandomSampler(src, generator=7)
        epoch0, epoch1 = list(ref), list(ref)
        live = RandomSampler(src, generator=7)
        it = iter(live)
        head = [next(it) for _ in range(7)]
        state = live.state_dict()
        assert state == {"epoch": 0, "cursor": 7}
        fresh = RandomSampler(src, generator=7)
        fresh.load_state_dict(state)
        assert head + list(fresh) == epoch0    # exact remaining order
        # the restored sampler's NEXT epoch is epoch 1, not a replay
        assert list(fresh) == epoch1
        # a state taken at an epoch boundary resumes at the next epoch
        boundary = RandomSampler(src, generator=7)
        list(boundary)
        fresh2 = RandomSampler(src, generator=7)
        fresh2.load_state_dict(boundary.state_dict())
        assert list(fresh2) == epoch1

    def test_sequence_sampler_cursor(self):
        s = SequenceSampler(list(range(10)))
        it = iter(s)
        assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
        fresh = SequenceSampler(list(range(10)))
        fresh.load_state_dict(s.state_dict())
        assert list(fresh) == [4, 5, 6, 7, 8, 9]

    def test_dataloader_state_roundtrip(self):
        data = np.arange(24, dtype=np.float32).reshape(12, 2)
        mk = lambda: DataLoader(list(data), batch_size=3,
                                sampler=RandomSampler(data, generator=5))
        ref = [b.copy() for b in mk()]
        live = mk()
        it = iter(live)
        head = [next(it) for _ in range(2)]
        resumed = mk()
        resumed.load_state_dict(live.state_dict())
        tail = list(resumed)
        got = head + tail
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    def test_distributed_sampler_reshard_disjoint_and_complete(self):
        """A dp=4 mid-epoch state restores under dp=2 (and dp=3, the
        non-dividing case): the new shards cover exactly the unseen
        remainder of the epoch's global order, with no overlap between
        ranks and no sample double-consumed."""
        N, BS = 64, 2
        mk = lambda nr, r: DistributedBatchSampler(
            list(range(N)), BS, num_replicas=nr, rank=r, shuffle=True)
        olds = [mk(4, r) for r in range(4)]
        its = [iter(s) for s in olds]
        consumed = []
        for _ in range(3):                     # 3 lockstep batches
            for it in its:
                consumed += next(it)
        state = olds[0].state_dict()
        assert state["consumed"] == 3 * BS * 4 == len(consumed)
        global_order = olds[0]._epoch_indices()
        # prefix property: rank-strided sharding makes the lockstep-
        # consumed SET exactly the head of the global order — the
        # invariant that lets a new topology resume from one counter
        assert set(consumed) == set(global_order[:len(consumed)])
        for new_ranks in (2, 3):
            news = [mk(new_ranks, r) for r in range(new_ranks)]
            for s in news:
                s.load_state_dict(state)
            shards = [[i for b in s for i in b] for s in news]
            remainder = set(global_order[len(consumed):])
            seen = [i for sh in shards for i in sh]
            assert set(seen) == remainder      # exactly the unseen rest
            assert set(consumed).isdisjoint(remainder)
            # non-overlapping across ranks up to the even-shard pad
            pad = (-len(remainder)) % new_ranks
            assert len(seen) - len(set(seen)) <= pad
            # every rank got the same number of batches (lockstep safety)
            assert len({len(sh) for sh in shards}) == 1

    def test_generator_object_still_accepted(self):
        """Passing a np.random.Generator OBJECT (torch/paddle-style)
        keeps working: epochs differ via its advancing state; exact
        (epoch, cursor) resume needs an int seed."""
        s = RandomSampler(list(range(16)), generator=np.random.default_rng(0))
        e0, e1 = list(s), list(s)
        assert sorted(e0) == sorted(e1) == list(range(16))
        assert e0 != e1
        s.load_state_dict(s.state_dict())      # degrades, never crashes
        assert sorted(list(s)) == list(range(16))
        # a mid-epoch cursor is NOT reconstructible from a generator
        # object: resume restarts the epoch (full coverage) instead of
        # skipping never-seen samples of a fresh permutation
        s2 = RandomSampler(list(range(16)), generator=np.random.default_rng(0))
        s2.load_state_dict({"epoch": 0, "cursor": 5})
        assert sorted(list(s2)) == list(range(16))

    def test_distributed_sampler_reshuffles_per_epoch(self):
        """Epoch wrap without set_epoch must reshuffle (same bug class
        as the seeded RandomSampler fix); explicit set_epoch still
        pins the order."""
        d = DistributedBatchSampler(list(range(32)), 4, num_replicas=1,
                                    rank=0, shuffle=True)
        e0, e1 = list(d), list(d)
        assert e0 != e1
        d.set_epoch(0)
        assert list(d) == e0

    def test_epoch_tail_resume_onto_more_ranks_keeps_lockstep(self):
        """Resuming with only 2 unseen samples onto 8 ranks: the pad
        must CYCLE the remainder so every rank still gets the same
        batch count (uneven shards would hang SPMD lockstep)."""
        N = 64
        olds = [DistributedBatchSampler(list(range(N)), 1, num_replicas=2,
                                        rank=r, shuffle=True)
                for r in range(2)]
        its = [iter(s) for s in olds]
        for _ in range(31):                    # 62 of 64 consumed
            for it in its:
                next(it)
        state = olds[0].state_dict()
        assert state["consumed"] == 62
        news = [DistributedBatchSampler(list(range(N)), 1, num_replicas=8,
                                        rank=r, shuffle=True)
                for r in range(8)]
        for s in news:
            s.load_state_dict(state)
        shards = [[i for b in s for i in b] for s in news]
        assert len({len(sh) for sh in shards}) == 1   # lockstep preserved
        assert all(len(sh) == 1 for sh in shards)
        remainder = set(olds[0]._epoch_indices()[62:])
        assert {i for sh in shards for i in sh} == remainder

    def test_state_survives_restore_without_iteration(self):
        """Double preemption: a restored-but-never-iterated sampler's
        state_dict must re-report the held position (epoch, cursor, and
        for DBS the ORIGINAL saving nranks), not a zeroed one."""
        s = RandomSampler(list(range(16)), generator=3)
        it = iter(s)
        [next(it) for _ in range(5)]
        state = s.state_dict()
        fresh = RandomSampler(list(range(16)), generator=3)
        fresh.load_state_dict(state)
        assert fresh.state_dict() == state     # no iteration in between
        d = DistributedBatchSampler(list(range(10)), 1, num_replicas=4,
                                    rank=0, shuffle=True)
        dit = iter(d)
        next(dit), next(dit)
        dstate = d.state_dict()
        assert dstate["nranks"] == 4
        d2 = DistributedBatchSampler(list(range(10)), 1, num_replicas=5,
                                     rank=0, shuffle=True)
        d2.load_state_dict(dstate)
        assert d2.state_dict() == dstate       # still the saving topology

    def test_distributed_sampler_same_topology_resume(self):
        N, BS = 32, 4
        ref = [b for b in DistributedBatchSampler(
            list(range(N)), BS, num_replicas=2, rank=0, shuffle=True)]
        live = DistributedBatchSampler(list(range(N)), BS, num_replicas=2,
                                       rank=0, shuffle=True)
        it = iter(live)
        head = [next(it), next(it)]
        fresh = DistributedBatchSampler(list(range(N)), BS, num_replicas=2,
                                        rank=0, shuffle=True)
        fresh.load_state_dict(live.state_dict())
        assert head + list(fresh) == ref


# ======================================================= empty dataloader
def test_empty_train_dataloader_raises_value_error(tmp_path):
    tr = ptt.Trainer(_model(), ptt.optimizer.AdamW(learning_rate=1e-3),
                     ptt.TrainingArguments(output_dir=str(tmp_path),
                                           max_steps=2,
                                           resume_from_checkpoint=False),
                     train_dataloader=[])
    with pytest.raises(ValueError, match="train_dataloader is empty"):
        tr.train()


# ========================================================== preempt e2e
class _RecordingDataset:
    """Token dataset that logs every __getitem__: a replay-based resume
    would re-fetch consumed samples; the O(1) sampler restore must not."""

    def __init__(self, n=16, s=16, vocab=256):
        self.data = np.random.RandomState(7).randint(0, vocab, (n, s))
        self.fetches = []

    def __getitem__(self, i):
        self.fetches.append(i)
        return self.data[i]

    def __len__(self):
        return len(self.data)


def _model(seed=0):
    return ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu",
                                generator=ptt.make_generator(seed, "cpu"))


def _preempt_trainer(out_dir, max_steps=10, **kw):
    ds = _RecordingDataset()
    dl = DataLoader(ds, batch_size=4, sampler=RandomSampler(ds, generator=11))
    args = ptt.TrainingArguments(output_dir=str(out_dir),
                                 max_steps=max_steps, logging_steps=1,
                                 save_steps=4, seed=42, **kw)
    tr = ptt.Trainer(_model(), ptt.optimizer.AdamW(learning_rate=1e-3), args,
                     train_dataloader=dl)
    return tr, ds


class TestPreemptionE2E:
    def test_preempt_checkpoints_exits_and_resumes_exactly(self, tmp_path):
        """An injected preempt mid-run: a checkpoint at the exact step and
        PREEMPTED_RC; the relaunch resumes to the SAME final loss as an
        uninterrupted run on the same data order, via the sampler-state
        restore (O(1)), not a replay."""
        ref, _ = _preempt_trainer(tmp_path / "ref")
        ref.train()
        ref_final = ref.logger.history["loss"][-1][1]

        tr, _ = _preempt_trainer(tmp_path / "run")
        with faults.scoped("preempt@6"):
            with pytest.raises(SystemExit) as ei:
                tr.train()
        assert ei.value.code == PREEMPTED_RC == tr.args.preempt_exit_code
        assert tr.global_step == 6             # exact step, not save_steps
        ckdir = tmp_path / "run" / "checkpoints"
        steps = sorted(int(d) for d in os.listdir(ckdir) if d.isdigit())
        assert 6 in steps
        meta = json.load(open(ckdir / "meta" / "6.json"))
        assert meta["step"] == 6
        assert meta["sampler"]["batch_sampler"]["sampler"]["cursor"] == 8
        assert meta["topology"]["dp"] == 1

        tr2, ds2 = _preempt_trainer(tmp_path / "run")
        tr2.train()
        assert tr2._sampler_restored
        assert tr2.global_step == 10
        # no replay: the 4 remaining steps' samples, plus at most the
        # prefetcher's bounded read-ahead (depth + 1 batches drawn, never
        # trained)
        depth = tr2.args.prefetch_depth
        assert 4 * 4 <= len(ds2.fetches) <= (4 + depth + 1) * 4
        final = tr2.logger.history["loss"][-1][1]
        assert abs(final - ref_final) < ATOL_RESUME, (final, ref_final)

    def test_latch_cleared_on_next_train_call(self, tmp_path):
        tr, _ = _preempt_trainer(tmp_path / "again", max_steps=4)
        with faults.scoped("preempt@1"):
            with pytest.raises(SystemExit):
                tr.train()
        assert tr.global_step == 1
        tr.train()                             # latch cleared: runs
        assert tr.global_step == 4

    def test_sigterm_latch_requests_graceful_stop(self, tmp_path):
        import signal as _signal
        tr, _ = _preempt_trainer(tmp_path / "sig", max_steps=6)

        class Kick(ptt.TrainerCallback):
            sent = False

            def on_step_end(self, step, logs):
                if step >= 2 and not self.sent:
                    self.sent = True
                    os.kill(os.getpid(), _signal.SIGTERM)

        tr.callbacks.append(Kick())
        before = _signal.getsignal(_signal.SIGTERM)
        with pytest.raises(SystemExit) as ei:
            tr.train()
        assert ei.value.code == PREEMPTED_RC
        assert 2 <= tr.global_step < 6
        assert _signal.getsignal(_signal.SIGTERM) is before
        assert isinstance(tr._shutdown, GracefulShutdown)
        assert tr._shutdown.requested()


def test_meta_sidecar_equals_the_jax_trainers(tmp_path):
    """The same preempted run through both trainers (same dataset,
    sampler seed and steps): the step's meta JSON has the same keys and
    values. One value differs by design: the JAX trainer records
    jax.device_count() (the test config's 8 virtual CPU devices), the
    port the one device it trains on."""
    from paddle_tpu.io import DataLoader as JaxLoader
    from paddle_tpu.io import RandomSampler as JaxSampler
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import llama_tiny as jax_llama_tiny
    from paddle_tpu.trainer import Trainer as JaxTrainer
    from paddle_tpu.trainer import TrainingArguments as JaxArgs
    from paddle_tpu.utils import faults as jax_faults
    metas = []
    for side in ("jax", "port"):
        ds = _RecordingDataset()
        out = tmp_path / side
        if side == "jax":
            pt.seed(0)
            dl = JaxLoader(ds, batch_size=4,
                           sampler=JaxSampler(ds, generator=11))
            tr = JaxTrainer(JaxLlama(jax_llama_tiny()),
                            pt.optimizer.AdamW(learning_rate=1e-3),
                            JaxArgs(output_dir=str(out), max_steps=10,
                                    logging_steps=1, save_steps=4),
                            train_dataloader=dl)
            scoped = jax_faults.scoped
        else:
            tr, _ = _preempt_trainer(out)
            scoped = faults.scoped
        with scoped("preempt@5"):
            with pytest.raises(SystemExit):
                tr.train()
        metas.append(json.load(open(out / "checkpoints" / "meta" /
                                    "5.json")))
    jm, tm = metas
    assert tm["topology"].pop("device_count") == 1
    jm["topology"].pop("device_count")
    assert tm == jm
    assert tm["sampler"]["batch_sampler"]["sampler"] == {"epoch": 1,
                                                         "cursor": 4}


# ================================================= supervisor awareness
_COUNTER_CHILD = r"""
import os, sys
p = sys.argv[1]
n = int(open(p).read()) if os.path.exists(p) else 0
open(p, "w").write(str(n + 1))
codes = [int(c) for c in sys.argv[2].split(",")]
sys.exit(codes[min(n, len(codes) - 1)])
"""


class TestSupervisorPreemption:
    def _run(self, counter, codes, **kw):
        from paddle_tpu_torch.distributed.elastic import supervise
        rc = supervise([sys.executable, "-c", _COUNTER_CHILD, str(counter),
                        ",".join(map(str, codes))], backoff_s=0.01, **kw)
        n = int(open(counter).read()) if os.path.exists(counter) else 0
        return rc, n

    def test_preempted_rc_restarts_without_consuming_attempts(self, tmp_path):
        rc, n = self._run(tmp_path / "a", [PREEMPTED_RC, PREEMPTED_RC, 0],
                          max_restarts=0)
        assert rc == 0 and n == 3
        rc, n = self._run(tmp_path / "b", [PREEMPTED_RC, 7, 7],
                          max_restarts=1)
        assert rc == 7 and n == 3              # preempt + crash + retry

    def test_preemption_storm_bounded(self, tmp_path):
        rc, n = self._run(tmp_path / "c", [PREEMPTED_RC], max_restarts=0,
                          max_preemptions=2)
        assert rc == PREEMPTED_RC and n == 3   # initial + 2 free restarts

    def test_topology_change_logged(self, tmp_path, capfd):
        topos = iter(["1xH100", "1xH100", "4xH100", "4xH100"])
        rc, n = self._run(tmp_path / "d", [PREEMPTED_RC, 0], max_restarts=0,
                          probe_topology=lambda: next(topos))
        assert rc == 0 and n == 2
        err = capfd.readouterr().err
        assert "topology changed" in err and "4xH100" in err

    def test_default_probe_reads_mutable_file(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.distributed.elastic import _default_topology
        f = tmp_path / "ws"
        monkeypatch.setenv("PADDLE_TPU_WORLD_SIZE_FILE", str(f))
        assert _default_topology() is None
        f.write_text("8\n")
        assert _default_topology() == "8"
        f.write_text("4")
        assert _default_topology() == "4"
        monkeypatch.delenv("PADDLE_TPU_WORLD_SIZE_FILE")
        monkeypatch.setenv("PADDLE_TPU_WORLD_SIZE", "16")
        assert _default_topology() == "16"

    def test_cli_and_supervisor_telemetry(self, tmp_path):
        from paddle_tpu_torch.distributed import elastic
        assert elastic.main([]) == 2           # usage
        run_dir = tmp_path / "runs"
        rc = elastic.supervise(
            [sys.executable, "-c", _COUNTER_CHILD, str(tmp_path / "e"),
             f"{PREEMPTED_RC},0"], backoff_s=0.01, run_dir=str(run_dir))
        assert rc == 0
        prom = (run_dir / "metrics_supervisor.prom").read_text()
        assert "elastic_preemptions_total" in prom


# ====================================== rollback keeps poisoned-window skip
def test_divergence_rollback_does_not_rewind_sampler(tmp_path):
    """A divergence rollback restores tensors only: the sampler keeps its
    live position (the poisoned window is skipped), it does not rewind to
    the checkpoint's."""
    ds = _RecordingDataset()
    dl = DataLoader(ds, batch_size=4, sampler=RandomSampler(ds, generator=11))
    args = ptt.TrainingArguments(output_dir=str(tmp_path), max_steps=6,
                                 logging_steps=1, save_steps=2,
                                 nan_patience=1, seed=42)
    tr = ptt.Trainer(_model(), ptt.optimizer.AdamW(learning_rate=1e-3), args,
                     train_dataloader=dl)
    with faults.scoped("step_nan@2"):      # fires at global step 3
        tr.train()
    assert tr._rollbacks == 1
    assert tr.global_step == 6
    assert not tr._sampler_restored
    depth = tr.args.prefetch_depth
    assert 7 * 4 <= len(ds.fetches) <= (7 + depth + 1) * 4
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


def test_rollbacks_are_bounded_then_divergence_raises(tmp_path):
    from paddle_tpu_torch.utils.watchdog import DivergenceError
    args = ptt.TrainingArguments(output_dir=str(tmp_path), max_steps=8,
                                 logging_steps=1, save_steps=2,
                                 nan_patience=1, max_divergence_rollbacks=1)
    batches = [np.random.RandomState(1).randint(0, 256, (2, 16))]
    tr = ptt.Trainer(_model(), ptt.optimizer.AdamW(learning_rate=1e-3), args,
                     train_dataloader=batches)
    with faults.scoped("step_nan@3+"):
        with pytest.raises(DivergenceError):
            tr.train()
    assert tr._rollbacks == 1


# ============================================== concurrent resume safety
def test_resume_waits_for_inflight_async_save(tmp_path):
    """Auto-resume racing a still-in-flight async save drains it
    (wait_until_finished BEFORE latest_complete_step) and restores the
    finished step, never a torn one."""
    batch = np.random.RandomState(7).randint(0, 256, (4, 16))
    args = ptt.TrainingArguments(output_dir=str(tmp_path), max_steps=3,
                                 logging_steps=1, save_steps=0, seed=42)
    tr = ptt.Trainer(_model(), ptt.optimizer.AdamW(learning_rate=1e-3), args,
                     train_dataloader=[batch])
    tr.train()
    tr.save_checkpoint(wait=False)             # async save in flight
    at_save = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    with torch.no_grad():                      # moved after the snapshot
        for p in tr.model.parameters():
            p.add_(1.0)
    ckpt = tr._ckpt_manager()
    calls = []
    orig_wait = ckpt.wait_until_finished
    orig_latest = ckpt.latest_complete_step
    ckpt.wait_until_finished = lambda: (calls.append("wait"),
                                        orig_wait())[1]
    ckpt.latest_complete_step = lambda: (calls.append("latest"),
                                         orig_latest())[1]
    try:
        restored = tr._try_resume()
    finally:
        ckpt.wait_until_finished = orig_wait
        ckpt.latest_complete_step = orig_latest
    assert restored == 3
    assert calls.index("wait") < calls.index("latest")
    for k, p in tr.model.named_parameters():
        assert torch.equal(p, at_save[k]), k


# ======================================================== the hang exit
_HANG_CHILD = r"""
import numpy as np, paddle_tpu_torch as ptt
m = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu",
                         generator=ptt.make_generator(0, "cpu"))
args = ptt.TrainingArguments(output_dir=%r, max_steps=6, logging_steps=1,
                             save_steps=1, hang_timeout_s=1.0,
                             hang_exit_code=17)
batches = [np.random.RandomState(1).randint(0, 256, (2, 16))]
ptt.Trainer(m, ptt.optimizer.AdamW(learning_rate=1e-3), args,
            train_dataloader=batches).train()
"""


def test_hang_exit_checkpoints_and_exits_in_a_subprocess(tmp_path):
    """A step stuck past hang_timeout_s (the ``hang`` site sleeping
    before step 3): the watchdog's monitor thread checkpoints the current
    step and the process exits hang_exit_code."""
    env = dict(os.environ, PADDLE_TPU_FAULTS="hang@3",
               PADDLE_TPU_FAULT_HANG_S="60")
    proc = subprocess.run([sys.executable, "-c",
                           _HANG_CHILD % str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 17, proc.stderr[-2000:]
    assert "step hung" in proc.stderr
    ckpt = DistributedCheckpoint(str(tmp_path / "checkpoints"))
    assert ckpt.latest_complete_step() == 3
    assert ckpt.verify_step(3) is True


# ======================================================== step checkpoints
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(33, 7, generator=g).bfloat16(),
                       "h": torch.randn(5, generator=g).half()},
            "opt_state": {"slots": {"w": {"m": torch.randn(33, 7,
                                                           generator=g)},
                                    "h": None},
                          "step": 3},
            "scaler": {"scale": torch.tensor(2.0 ** 15),
                       "growth_tracker": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_step_checkpoint_round_trip_keeps_dtypes(tmp_path):
    ckpt = DistributedCheckpoint(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _tree(step), meta={"step": step})
    ckpt.wait_until_finished()
    assert sorted(ckpt.all_steps()) == [2, 3]          # max_to_keep
    assert sorted(os.listdir(tmp_path / "manifests")) == ["2.json",
                                                          "3.json"]
    assert ckpt.verify_step(3) is True
    _equal(ckpt.restore(like=_tree()), _tree(3))
    assert ckpt.load_meta(3) == {"step": 3}
    bad = _tree()
    bad["params"]["w"] = bad["params"]["w"].float()
    with pytest.raises(ValueError, match="params.w"):
        ckpt.restore(3, like=bad)
    state, start = auto_resume(str(tmp_path), _tree())
    assert start == 4
    _equal(state, _tree(3))
    assert auto_resume(str(tmp_path / "none"), {"a": 1}) == ({"a": 1}, 0)


def test_corrupt_latest_step_falls_back(tmp_path):
    """The ``ckpt_corrupt`` site flips bytes of step 2 after its manifest:
    latest_complete_step and restore fall back to step 1; a strict
    restore of step 2 refuses; with every step corrupt, restore raises."""
    ckpt = DistributedCheckpoint(str(tmp_path))
    ckpt.save(1, _tree(1), wait=True)
    with faults.scoped("ckpt_corrupt"):
        ckpt.save(2, _tree(2), wait=True)
    assert ckpt.verify_step(2) is False
    assert ckpt.latest_complete_step() == 1
    _equal(ckpt.restore(), _tree(1))
    assert ckpt.last_restored_step == 1
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore(2, strict=True)
    ckpt._corrupt_step(1)
    ckpt._verify_memo.clear()
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore()


def test_fp16_trainer_resume_restores_the_scaler(tmp_path):
    """A GradScaler's state rides in the checkpoint: a fresh fp16 Trainer
    resumes with the saved scale and trackers."""
    from paddle_tpu_torch.amp import GradScaler

    def make():
        m = ptt.LlamaForCausalLM(ptt.llama_tiny(dtype=torch.float16),
                                 device="cpu",
                                 generator=ptt.make_generator(0, "cpu"))
        args = ptt.TrainingArguments(output_dir=str(tmp_path), max_steps=4,
                                     logging_steps=1, save_steps=2)
        return ptt.Trainer(m, ptt.optimizer.AdamW(learning_rate=1e-3,
                                                  multi_precision=True),
                           args, train_dataloader=[
                               np.random.RandomState(1).randint(
                                   0, 256, (2, 16))],
                           scaler=GradScaler(init_loss_scaling=2.0 ** 20))
    tr = make()
    tr.train()
    saved = {k: v.clone() for k, v in tr._scaler_state.items()}
    tr2 = make()
    tr2._opt_state = tr2.optimizer.init(tr2._trainable)
    assert tr2._try_resume() == 4
    for k, v in saved.items():
        assert torch.equal(tr2._scaler_state[k], v), k
    assert float(saved["scale"]) < 2.0 ** 20


def test_second_training_slice_keeps_jax_out():
    """The modules of this slice import neither jax nor the JAX package
    (a fresh interpreter, so nothing else has imported them)."""
    code = ("import sys, paddle_tpu_torch.amp, paddle_tpu_torch.io, "
            "paddle_tpu_torch.callbacks, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.checkpoint.distributed_ckpt, "
            "paddle_tpu_torch.optimizer.ema, "
            "paddle_tpu_torch.ops.kernels.fused_adam\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
