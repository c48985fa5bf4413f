"""The port's PP-OCR models (DBNet, SVTR) and their losses against the JAX
package's, fp32 on the CPU, on weights built in JAX from a seed,
perturbed by seeded numpy noise (BatchNorm's running statistics drawn
too) and carried across with ``load_jax_state_dict``.

Tolerances: ``ATOL`` for one forward (the zoo tests'), ``ATOL_CTC`` for
the CTC loss (a log-space recursion over the width), ``RTOL_LOSS`` /
``ATOL_PARAMS`` for the Trainer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import ppocr as jocr
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.models import ppocr

ATOL = 1e-4
ATOL_CTC = 1e-4
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def pair(jcls, tcls, jcfg, tcfg, seed, scale=0.05):
    pt.seed(seed)
    jm = jcls(jcfg)
    rs = np.random.RandomState(seed + 100)
    sd = {}
    for k, v in jm.state_dict().items():
        v = np.asarray(v)
        sd[k] = np.asarray(rs.uniform(0.5, 1.5, v.shape)
                           if k.endswith("_variance")
                           else v + scale * rs.randn(*v.shape), np.float32)
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tm = tcls(tcfg, device="cpu")
    ptt.load_jax_state_dict(tm, sd)
    return jm, tm, sd


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _db_targets(b, h, w, seed):
    """Seeded shrink/threshold maps and masks of [b, h, w]."""
    rs = np.random.RandomState(seed)
    shrink = (rs.rand(b, h, w) < 0.2).astype(np.float32)
    mask = (rs.rand(b, h, w) < 0.9).astype(np.float32)
    thresh = rs.uniform(0.3, 0.7, (b, h, w)).astype(np.float32)
    tmask = (rs.rand(b, h, w) < 0.5).astype(np.float32)
    return shrink, mask, thresh, tmask


@pytest.mark.parametrize("mode", ("eval", "train"))
def test_dbnet_maps_and_db_loss_match_jax(mode):
    """The probability, threshold and binary maps (the FPN's nearest
    upsamples, the heads' transposed convs), and ``db_loss`` on them with
    OHEM ranking by a descending sort."""
    jm, tm, _ = pair(jocr.DBNet, ppocr.DBNet, jocr.dbnet_tiny(),
                     ppocr.dbnet_tiny(), seed=1)
    getattr(jm, mode)()
    getattr(tm, mode)()
    x = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    ref = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got["maps"].shape) == (2, 3, 64, 64)
    _close(got["maps"], ref["maps"])
    targets = _db_targets(2, 64, 64, seed=3)
    want = float(jocr.db_loss(ref, *map(jnp.asarray, targets)))
    have = float(ppocr.db_loss(got, *map(torch.from_numpy, targets)))
    np.testing.assert_allclose(have, want, rtol=1e-4)


def test_svtr_logits_ctc_loss_and_decode_match_jax():
    """SVTR's logits (Local mixing masked by its band, Global full),
    ``ctc_rec_loss`` with label lengths, ``ctc_greedy_decode``'s ids and
    kept positions; the band is a non-persistent buffer, as in JAX."""
    jm, tm, _ = pair(jocr.SVTRNet, ppocr.SVTRNet, jocr.svtr_tiny(),
                     ppocr.svtr_tiny(), seed=4)
    assert "blocks.0.local_bias" not in tm.state_dict()
    assert hasattr(tm.blocks[0], "local_bias")
    x = np.random.RandomState(5).randn(3, 3, 16, 32).astype(np.float32)
    ref = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 8, 40) and got.dtype == torch.float32
    _close(got, ref)
    rs = np.random.RandomState(6)
    labels = rs.randint(1, 40, (3, 4)).astype(np.int32)
    lens = np.array([4, 2, 3], np.int32)
    np.testing.assert_allclose(
        float(ppocr.ctc_rec_loss(got, torch.from_numpy(labels),
                                 torch.from_numpy(lens))),
        float(jocr.ctc_rec_loss(ref, jnp.asarray(labels), jnp.asarray(lens))),
        atol=ATOL_CTC, rtol=1e-5)
    logits = rs.randn(3, 10, 5).astype(np.float32)
    logits[0, 3:5, 2] += 10            # a repeat, collapsed
    logits[1, :, 0] += 10              # all blank
    ids, keep = ppocr.ctc_greedy_decode(torch.from_numpy(logits))
    jids, jkeep = jocr.ctc_greedy_decode(jnp.asarray(logits))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep[1].any()


@pytest.mark.parametrize("name", ("dbnet", "svtr"))
def test_trainer_steps_match_jax(tmp_path, name):
    """``Trainer(loss_fn=...)``, SGD, 3 steps: DBNet under ``db_loss``
    (BatchNorm's running statistics untouched, as under the JAX Trainer)
    and SVTR under ``ctc_rec_loss``; losses and every parameter."""
    if name == "dbnet":
        jm, tm, sd = pair(jocr.DBNet, ppocr.DBNet, jocr.dbnet_tiny(),
                          ppocr.dbnet_tiny(), seed=7)
        # 64 x 64: the backbone's last stage keeps 2 x 2 maps, so its
        # train-mode statistics are over 8 values (over 2, a near-zero
        # variance amplifies fp32 rounding in the gradients)
        shrink, mask, thresh, tmask = _db_targets(2, 64, 64, seed=8)
        batch = dict(x=np.random.RandomState(9).randn(2, 3, 64, 64)
                     .astype(np.float32), shrink=shrink, mask=mask,
                     thresh=thresh, tmask=tmask)

        def jloss(fn, p, b):
            return jocr.db_loss(fn(p, b["x"]), b["shrink"], b["mask"],
                                b["thresh"], b["tmask"])

        def tloss(m, b):
            return ppocr.db_loss(m(b["x"]), b["shrink"], b["mask"],
                                 b["thresh"], b["tmask"])
        # the binary map's sigmoid(50 (P - T)) makes the gradients steep:
        # one step's gradients agree within 4e-5 of their largest, but at
        # lr 2e-2 three steps carry that past ATOL_PARAMS (the BERT tests'
        # convention: a small SGD step, in both packages alike)
        lr = 1e-3
    else:
        jm, tm, sd = pair(jocr.SVTRNet, ppocr.SVTRNet, jocr.svtr_tiny(),
                          ppocr.svtr_tiny(), seed=10)
        rs = np.random.RandomState(11)
        batch = dict(x=rs.randn(4, 3, 16, 32).astype(np.float32),
                     labels=rs.randint(1, 40, (4, 3)).astype(np.int32),
                     lens=np.array([3, 1, 2, 3], np.int32))

        def jloss(fn, p, b):
            return jocr.ctc_rec_loss(fn(p, b["x"]), b["labels"], b["lens"])

        def tloss(m, b):
            return ppocr.ctc_rec_loss(m(b["x"]), b["labels"], b["lens"])
        lr = 2e-2
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=lr),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     loss_fn=jloss,
                     train_dataloader=[{k: jnp.asarray(v)
                                        for k, v in batch.items()}])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=lr),
                      ptt.TrainingArguments(output_dir=str(tmp_path / "pt"),
                                            graceful_shutdown=False, **kw),
                      loss_fn=tloss,
                      train_dataloader=[{k: torch.from_numpy(v)
                                         for k, v in batch.items()}])
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)
    assert got[-1] < got[0]
    buffers = {k: v for k, v in sd.items() if k not in jtr._params}
    ref = type(tm)(tm.config, device="cpu")
    ptt.load_jax_state_dict(ref, {**buffers, **{
        k: np.asarray(v) for k, v in jtr._params.items()}})
    want = dict(ref.named_parameters())
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k].detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0, err_msg=k)
    for k, v in buffers.items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v)
