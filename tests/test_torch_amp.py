"""The port's ``amp`` against the JAX package's: the GradScaler's dynamic
scale over a scripted run of non-finite steps (bit for bit: every move
is a multiplication by 2 or 0.5), its unscale and non-finite check, the
eager API, ``auto_cast`` / ``decorate``, and an fp16 ``Trainer`` (fp32
masters, a GradScaler that overflows first and backs off) against the
JAX trainer on the same weights and batches.

The fp16 losses: both models compute fp16 logits and an fp32 loss, with
fp16 roundings at other points (XLA's and torch's CPU kernels), so a
loss may differ by up to a step of fp16 relative to it: 2^-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import amp as jamp
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch import amp

RTOL_FP16_LOSS = 2.0 ** -10

FLAGS = [False, False, True, False, False, False, False, True, True,
         False, True, True, True, False, False, False, False, False]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(incr_every_n_steps=3, decr_every_n_nan_or_inf=2),
    dict(init_loss_scaling=8.0, incr_ratio=4.0, decr_ratio=0.25,
         incr_every_n_steps=2),
    dict(use_dynamic_loss_scaling=False)], ids=["defaults", "every-3-2",
                                                "ratios", "static"])
def test_scale_trajectory_is_the_jax_one_bit_for_bit(kw):
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jst, tst = js.init_state(), ts.init_state("cpu")
    for i, flag in enumerate(FLAGS):
        jst = js.update_state(jst, jnp.bool_(flag))
        tst = ts.update_state(tst, torch.tensor(flag))
        for k in ("scale", "growth_tracker", "nan_tracker"):
            assert np.asarray(jst[k]).item() == tst[k].item(), (i, k)
        assert tst["scale"].dtype == torch.float32
        assert tst["growth_tracker"].dtype == torch.int32


def test_unscale_and_found_inf_match_jax():
    rs = np.random.RandomState(2)
    grads = {"a": (rs.randn(5, 3) * 1000).astype(np.float16),
             "b": rs.randn(4).astype(np.float16)}
    js, ts = jamp.GradScaler(), amp.GradScaler()
    jst, tst = js.init_state(), ts.init_state("cpu")
    for bad in (False, True):
        g = {k: v.copy() for k, v in grads.items()}
        if bad:
            g["b"][1] = np.inf
        ju, jf = js.unscale({k: jnp.asarray(v) for k, v in g.items()}, jst)
        tu, tf = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()},
                            tst)
        assert bool(jf) == bool(tf) == bad
        for k in g:
            assert tu[k].dtype == torch.float32
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    # found from the largest |g|: products that overflow fp32 at a scale
    # below 1, a NaN, finite products at a scale of 2^-100, an inverse
    # scale that is itself inf (scale 2^-130), zeros
    cases = [(0.5, {"a": np.array([1.0, 2e38], np.float32)}, True),
             (2.0 ** -100, {"a": np.array([1e10, 1.0], np.float32)}, True),
             (1.0, {"a": np.array([np.nan, 1.0], np.float32)}, True),
             (2.0 ** -100, {"a": np.array([1e-3, -2.0], np.float32)}, False),
             (2.0 ** -130, {"a": np.array([1e-3, -2.0], np.float32)}, True),
             (8.0, {"a": np.zeros(3, np.float32)}, False)]
    for scale, g, want in cases:
        js = jamp.GradScaler(init_loss_scaling=scale)
        ts = amp.GradScaler(init_loss_scaling=scale)
        _, jf = js.unscale({k: jnp.asarray(v) for k, v in g.items()},
                           js.init_state())
        _, tf = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()},
                           ts.init_state("cpu"))
        assert bool(jf) == bool(tf) == want, (scale, g)
    sel = amp.GradScaler.select(torch.tensor(True),
                                {"x": torch.zeros(2)}, {"x": torch.ones(2)})
    assert torch.equal(sel["x"], torch.zeros(2))


def test_eager_scaler_step_and_state_dict():
    ts = amp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=1)
    assert float(ts.scale(torch.tensor(2.0))) == 8.0
    w = torch.nn.Linear(3, 2)
    opt = ptt.optimizer.SGD(learning_rate=0.1, parameters=w)
    before = w.weight.detach().clone()
    grads = {k: torch.full_like(p, float("inf"))
             for k, p in w.named_parameters()}
    ts.step(opt, layer=w, grads=grads)          # skipped, scale halves
    assert torch.equal(w.weight, before)
    assert ts.state_dict()["scale"] == 2.0
    grads = {k: torch.ones_like(p) for k, p in w.named_parameters()}
    ts.step(opt, layer=w, grads=grads)          # applied, scale grows
    assert not torch.equal(w.weight, before)
    sd = ts.state_dict()
    assert sd == {"scale": 4.0, "growth_tracker": 0, "nan_tracker": 0}
    other = amp.GradScaler()
    other.load_state_dict(sd)
    assert other.state_dict() == sd
    off = amp.GradScaler(enable=False)
    x = torch.tensor(3.0)
    assert off.scale(x) is x and not off.is_enable()


def test_auto_cast_and_decorate():
    from paddle_tpu_torch.nn import functional as F
    x, w = torch.randn(2, 4), torch.randn(3, 4)
    assert amp.amp_dtype() is None
    with amp.auto_cast(dtype="bfloat16"):
        assert amp.amp_dtype() == torch.bfloat16
        assert F.linear(x, w).dtype == torch.bfloat16
        with amp.auto_cast(enable=False):
            assert F.linear(x, w).dtype == torch.float32
    assert amp.amp_dtype() is None
    assert jamp.amp_dtype() is None
    model = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    opt = ptt.optimizer.AdamW()
    m2, o2 = amp.decorate(model, opt, level="O2", dtype="float16")
    assert m2 is model and o2 is opt and opt.multi_precision
    assert {p.dtype for p in model.parameters()} == {torch.float16}
    with pytest.raises(ValueError, match="unknown dtype"):
        amp.to_dtype("float8")


def test_fp16_trainer_loss_history_matches_jax(tmp_path):
    """8 AdamW steps (fp32 masters) of an fp16 llama_tiny from a GradScaler
    at 2^20: the first steps overflow and are skipped while the scale
    backs off, as in the JAX trainer; loss histories within one fp16 step
    and the same final scale."""
    pt.seed(3)
    jm = JaxLlama(jax_llama_tiny(dtype="float16"))
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(dtype=torch.float16),
                              device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    rs = np.random.RandomState(4)
    batches = [rs.randint(0, 256, (4, 16)).astype(np.int32)
               for _ in range(2)]
    kw = dict(max_steps=8, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-2,
                                            multi_precision=True),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     train_dataloader=[jnp.asarray(x) for x in batches],
                     scaler=jamp.GradScaler(init_loss_scaling=2.0 ** 20))
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2,
                                              multi_precision=True),
                      ptt.TrainingArguments(output_dir=str(tmp_path / "pt"),
                                            **kw),
                      train_dataloader=batches,
                      scaler=amp.GradScaler(init_loss_scaling=2.0 ** 20))
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    np.testing.assert_allclose(got, want, rtol=RTOL_FP16_LOSS, atol=0)
    assert float(ttr._scaler_state["scale"]) == \
        float(jtr._scaler_state["scale"]) < 2.0 ** 20
    assert got[-1] < got[0]
    for p in tm.parameters():
        assert p.dtype == torch.float16
