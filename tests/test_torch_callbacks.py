"""The port's ``callbacks`` against the JAX package's: the same decisions
on the same scripted logs (EarlyStopping's patience and best value,
ModelCheckpoint's saves, LRScheduler's steps), and a ``Callback`` fed by
the port's ``Trainer``."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu import callbacks as jcb
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import callbacks as tcb
from paddle_tpu_torch.optimizer import lr as tlr

LOSSES = [3.0, 2.5, 2.6, 2.4, 2.45, 2.41, 2.5, 2.2]


@pytest.mark.parametrize("kw", [dict(patience=2), dict(patience=3,
                                                       min_delta=0.05),
                                dict(monitor="acc", mode="max",
                                     patience=1)])
def test_early_stopping_decides_as_the_jax_one(kw):
    def run(mod):
        cb = mod.EarlyStopping(raise_on_stop=False, **kw)
        seen = []
        for epoch, loss in enumerate(LOSSES):
            cb.on_epoch_end(epoch, {"loss": loss, "acc": -loss})
            seen.append((cb.stop_training, cb.wait, cb.best))
        return seen, cb.stopped_epoch
    assert run(tcb) == run(jcb)
    with pytest.raises(StopIteration):
        cb = tcb.EarlyStopping(patience=1)
        for epoch, loss in enumerate(LOSSES):
            cb.on_epoch_end(epoch, {"loss": loss})
    with pytest.raises(ValueError):
        tcb.EarlyStopping(mode="median")


def test_model_checkpoint_saves_a_module(tmp_path):
    lin = torch.nn.Linear(3, 2)
    cb = tcb.ModelCheckpoint(str(tmp_path), save_freq=2)
    with pytest.raises(RuntimeError, match="set_model"):
        cb.on_epoch_end(1)
    cb.set_model(lin)
    for epoch in range(4):
        cb.on_epoch_end(epoch)
    assert cb.saved == [str(tmp_path / "epoch_1"), str(tmp_path / "epoch_3")]
    state = ptt.load(str(tmp_path / "epoch_3.pdparams"))
    assert torch.equal(state["weight"], lin.weight.detach())
    best = tcb.ModelCheckpoint(str(tmp_path / "best"), monitor="loss")
    best.set_model(lin)
    for epoch, loss in enumerate(LOSSES[:3]):
        best.on_epoch_end(epoch, {"loss": loss})
    assert len(best.saved) == 2             # 3.0, then 2.5; not 2.6


def test_lr_scheduler_callback_steps_as_the_jax_one():
    ts = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    js = jlr.StepDecay(0.1, step_size=2, gamma=0.5)
    tc, jc = (tcb.LRScheduler(ts, by_epoch=False),
              jcb.LRScheduler(js, by_epoch=False))
    for step in (1, 4, 5, 9):
        tc.on_train_batch_end(step)
        jc.on_train_batch_end(step)
        assert ts.last_epoch == js.last_epoch
        np.testing.assert_allclose(ts.get_lr(), float(js.get_lr()))
    te = tcb.LRScheduler(tlr.StepDecay(0.1, step_size=1))
    te.on_epoch_end(0)
    assert te.scheduler.last_epoch == 1


def test_callback_sees_trainer_steps_as_batch_ends(tmp_path):
    seen = []

    class Record(tcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append((step, sorted(logs)))
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    tr = ptt.Trainer(model, ptt.optimizer.SGD(learning_rate=0.1),
                     ptt.TrainingArguments(output_dir=str(tmp_path),
                                           max_steps=4, logging_steps=2),
                     train_dataloader=[np.zeros((2, 8), np.int64)],
                     callbacks=[Record()])
    tr.train()
    assert [s for s, _ in seen] == [2, 4]
    assert seen[0][1] == ["loss", "mfu", "steps_per_sec", "tokens_per_sec"]
