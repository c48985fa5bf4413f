"""The port's BERT-family encoders (BERT, ERNIE) against the JAX package's,
on the same weights.

The JAX model is built from its seed, its ``state_dict()`` crosses as
numpy through ``load_jax_state_dict``, and both run fp32 on the CPU:
hidden states, the pooled output, the MLM and NSP logits under a padding
mask and token types, ERNIE's task types, both classifiers,
``pretraining_loss``, and ``Trainer(loss_fn=...)`` steps at
``hidden_dropout_prob=0`` (dropout has no bitwise counterpart of a JAX
key: parity holds at p = 0 or in eval mode; in training the port's masks
come from the model's generator, repeatably). A bf16 model keeps the JAX
package's dtypes: fp32 heads, ``mlm_bias`` and logits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import BertForPretraining as JaxBertPT
from paddle_tpu.models import BertForSequenceClassification as JaxBertCls
from paddle_tpu.models import ErnieForMaskedLM as JaxErnieMLM
from paddle_tpu.models import ErnieForSequenceClassification as JaxErnieCls
from paddle_tpu.models import bert_tiny as jax_bert_tiny
from paddle_tpu.models import ernie_tiny as jax_ernie_tiny
from paddle_tpu.models.bert import pretraining_loss as jax_pretraining_loss
from paddle_tpu.nn import functional as JF
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertForSequenceClassification,
                                     ErnieForMaskedLM,
                                     ErnieForSequenceClassification,
                                     bert_tiny, ernie_tiny, pretraining_loss)
from paddle_tpu_torch.nn import functional as F

# fp32 outputs: the same math, summed in another order by XLA and torch
ATOL = 1e-4
# loss histories over a few SGD steps, and the parameters after them
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5

FAMILIES = {
    "bert-pretraining": (JaxBertPT, BertForPretraining, jax_bert_tiny,
                         bert_tiny),
    "bert-cls": (JaxBertCls, BertForSequenceClassification, jax_bert_tiny,
                 bert_tiny),
    "ernie-mlm": (JaxErnieMLM, ErnieForMaskedLM, jax_ernie_tiny, ernie_tiny),
    "ernie-cls": (JaxErnieCls, ErnieForSequenceClassification,
                  jax_ernie_tiny, ernie_tiny),
}


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sd(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _pair(family, seed=0, eval_mode=True, **overrides):
    jcls, tcls, jcfg, tcfg = FAMILIES[family]
    overrides.setdefault("hidden_dropout_prob", 0.0)
    pt.seed(seed)
    jm = jcls(jcfg(**overrides))
    tm = tcls(tcfg(**overrides), device="cpu")
    if eval_mode:
        jm.eval()
        tm.eval()
    ptt.load_jax_state_dict(tm, _sd(jm))
    return jm, tm


def _inputs(b=2, s=16, vocab=256, seed=0):
    """ids, token types (a second segment from s // 2), a padding mask
    (row 1 padded from 11) and task types."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s)).astype(np.int32)
    types = np.zeros((b, s), np.int32)
    types[:, s // 2:] = 1
    mask = np.ones((b, s), np.int32)
    mask[1, 11:] = 0
    tasks = rs.randint(0, 3, (b, s)).astype(np.int32)
    return ids, types, mask, tasks


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def test_bert_encoder_and_heads_match_jax():
    """Hidden states, the pooled output, the MLM and NSP logits under a
    padding mask and two token types."""
    jm, tm = _pair("bert-pretraining", seed=1)
    ids, types, mask, _ = _inputs(seed=2)
    jseq, jpool = jm.bert(jnp.asarray(ids), jnp.asarray(types),
                          jnp.asarray(mask))
    jmlm, jnsp = jm(jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        seq, pool = tm.bert(*_t(ids, types, mask))
        mlm, nsp = tm(*_t(ids, types, mask))
    for got, ref in ((seq, jseq), (pool, jpool), (mlm, jmlm), (nsp, jnsp)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


def test_ernie_task_types_match_jax():
    """With ``use_task_id`` on, given task types and none (task 0's
    embedding added, as in the reference) both match; the task stream
    changes the output."""
    jm, tm = _pair("ernie-mlm", seed=3)
    ids, types, mask, tasks = _inputs(seed=4)
    outs = []
    for task in (tasks, None):
        ref = jm(jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask),
                 task_type_ids=None if task is None else jnp.asarray(task))
        with torch.no_grad():
            got = tm(*_t(ids, types, mask), task_type_ids=None
                     if task is None else _t(task)[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("family", ("bert-cls", "ernie-cls"))
def test_classifiers_match_jax(family):
    jm, tm = _pair(family, seed=5)
    ids, types, mask, _ = _inputs(seed=6)
    ref = jm(jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(*_t(ids, types, mask))
    assert tuple(got.shape) == (2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_pretraining_loss_matches_jax():
    rs = np.random.RandomState(7)
    mlm = rs.randn(2, 8, 32).astype(np.float32)
    labels = rs.randint(0, 32, (2, 8)).astype(np.int32)
    labels[:, ::3] = -100
    nsp = rs.randn(2, 2).astype(np.float32)
    nsp_labels = np.array([0, 1], np.int32)
    for args in ((mlm, labels), (mlm, labels, nsp, nsp_labels)):
        ref = float(jax_pretraining_loss(*map(jnp.asarray, args)))
        got = float(pretraining_loss(*[torch.from_numpy(a) for a in args]))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_positions_and_types_clamp_as_in_jax():
    """Position and token-type ids past their tables read the last row,
    as the JAX gather clamps them."""
    jm, tm = _pair("bert-pretraining", seed=8)
    ids, _, mask, _ = _inputs(s=16, seed=9)
    types = np.full_like(ids, 5)
    pos = np.tile(np.arange(56, 72, dtype=np.int32), (2, 1))
    jseq, _ = jm.bert(jnp.asarray(ids), jnp.asarray(types),
                      jnp.asarray(mask), positions=jnp.asarray(pos))
    with torch.no_grad():
        seq, _ = tm.bert(*_t(ids, types, mask), positions=_t(pos)[0])
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=ATOL,
                               rtol=0)


def test_bf16_keeps_the_jax_dtypes():
    """In bf16 the encoder and the MLM transform are bf16, while
    ``mlm_bias``, the NSP head and the classifier stay fp32 and every
    head's output is fp32, tensor by tensor as the JAX state dict has
    them."""
    for family in ("bert-pretraining", "ernie-cls"):
        jcls, tcls, jcfg, tcfg = FAMILIES[family]
        pt.seed(10)
        jm = jcls(jcfg(dtype=jnp.bfloat16))
        tm = tcls(tcfg(dtype=torch.bfloat16), device="cpu")
        tm.eval()
        jdt = {k: str(np.asarray(v).dtype) for k, v in
               jm.state_dict().items()}
        tdt = {k: str(v.dtype).replace("torch.", "")
               for k, v in tm.state_dict().items()}
        assert tdt == jdt
        ids, types, mask, _ = _inputs(seed=11)
        with torch.no_grad():
            out = tm(*_t(ids, types, mask))
        for o in (out if isinstance(out, tuple) else (out,)):
            assert o.dtype == torch.float32 and torch.isfinite(o).all()


def test_dropout_draws_from_the_model_generator():
    """In training, dropout 0.1 masks from the generator the model was
    built with: the same seed gives the same output, another seed
    another; eval mode is the identity and matches JAX's eval output."""
    jm, _ = _pair("ernie-cls", seed=12, hidden_dropout_prob=0.1)
    ids, types, mask, _ = _inputs(seed=13)
    outs = []
    for seed in (1, 1, 2):
        tm = ErnieForSequenceClassification(
            ernie_tiny(hidden_dropout_prob=0.1), device="cpu",
            generator=ptt.make_generator(seed, "cpu"))
        ptt.load_jax_state_dict(tm, _sd(jm))
        with torch.no_grad():
            outs.append(tm(*_t(ids, types, mask)))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    tm.eval()
    with torch.no_grad():
        got = tm(*_t(ids, types, mask))
    ref = jm(jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _losses(family):
    """(JAX loss_fn(fn, params, batch), port loss_fn(model, batch)) of a
    family over dict batches of ids, token types, a padding mask and
    labels (MLM labels with ignored positions, NSP or class labels)."""
    def unpack(b, conv):
        return (conv(b["ids"]), conv(b["types"]), conv(b["mask"]))

    if family == "bert-pretraining":
        def jloss(fn, p, b):
            mlm, nsp = fn(p, *unpack(b, jnp.asarray))
            return jax_pretraining_loss(mlm, b["mlm_labels"], nsp,
                                        b["labels"])

        def tloss(m, b):
            mlm, nsp = m(*unpack(b, torch.as_tensor))
            return pretraining_loss(mlm, b["mlm_labels"], nsp, b["labels"])
    elif family == "ernie-mlm":
        def jloss(fn, p, b):
            return JF.cross_entropy(fn(p, *unpack(b, jnp.asarray)),
                                    b["mlm_labels"], ignore_index=-100)

        def tloss(m, b):
            return F.cross_entropy(m(*unpack(b, torch.as_tensor)),
                                   b["mlm_labels"], ignore_index=-100)
    else:
        def jloss(fn, p, b):
            return JF.cross_entropy(fn(p, *unpack(b, jnp.asarray)),
                                    b["labels"])

        def tloss(m, b):
            return F.cross_entropy(m(*unpack(b, torch.as_tensor)),
                                   b["labels"])
    return jloss, tloss


@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_trainer_steps_match_jax(tmp_path, family):
    """``Trainer(loss_fn=...)`` in both packages from the same weights and
    batch, SGD for 3 steps at ``hidden_dropout_prob=0`` (in training
    mode): the loss histories within 1e-4 relative, every parameter
    after them within 1e-5."""
    jm, tm = _pair(family, seed=14, eval_mode=False)
    rs = np.random.RandomState(15)
    ids, types, mask, _ = _inputs(b=4, seed=16)
    mlm = np.where(rs.rand(4, 16) < 0.3, ids, -100).astype(np.int32)
    batches = [dict(ids=ids, types=types, mask=mask, mlm_labels=mlm,
                    labels=rs.randint(0, 2, 4).astype(np.int32))]
    jloss, tloss = _losses(family)
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.001),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     loss_fn=jloss,
                     train_dataloader=[{k: jnp.asarray(v) for k, v in
                                        b.items()} for b in batches])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.001),
                      ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                            graceful_shutdown=False, **kw),
                      loss_fn=tloss,
                      train_dataloader=[{k: torch.from_numpy(v).long()
                                         for k, v in b.items()}
                                        for b in batches])
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)
    assert got[-1] < got[0]
    ref = FAMILIES[family][1](FAMILIES[family][3](), device="cpu")
    ptt.load_jax_state_dict(ref, {k: np.asarray(v)
                                  for k, v in jtr._params.items()})
    want = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0, err_msg=name)
