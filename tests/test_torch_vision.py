"""The port's ResNet, ViT and CLIP against the JAX package's, on the same
weights, fp32 on the CPU; and through both Trainers.

Each JAX model is built from its seed, its parameters perturbed by seeded
numpy noise (BatchNorm's running statistics drawn too, so eval mode reads
them), set back into it, and its ``state_dict()`` carried across with
``load_jax_state_dict``. ``Trainer(loss_fn=...)`` runs 3 SGD steps in
both packages on one batch: the loss histories and every parameter after
them agree, and BatchNorm's running statistics stay where they were in
both (the JAX step binds no buffers). CLIP's contrastive loss at dp 2
(with each tower split over tp 2) runs in one CPU gloo world of 4 against
the JAX functions under ``shard_map`` on a 2-device CPU mesh, with
``SyncBatchNorm`` on dp 2 held to the global batch's statistics in the
same world.

Tolerances are the zoo tests': ``ATOL`` for outputs, ``RTOL_LOSS`` for
loss histories, ``ATOL_PARAMS`` for parameters after the steps."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.models import clip as jclip
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import vit as jvit
from paddle_tpu.nn import functional as JF
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu.utils.jax_compat import shard_map
from paddle_tpu_torch.convert import jax_state_dict
from paddle_tpu_torch.models import clip, resnet, vit
from paddle_tpu_torch.nn import functional as F
from torch_dist_workers import start_world

ATOL = 1e-4
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_sd(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def jittered(jm, seed, scale=0.05):
    """The JAX model's state dict plus seeded noise on every floating
    tensor (a BatchNorm variance drawn in [0.5, 1.5)), set back into the
    JAX model; returned as numpy."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in _np_sd(jm).items():
        if k.endswith("_variance"):
            v = rs.uniform(0.5, 1.5, v.shape)
        elif np.issubdtype(v.dtype, np.floating):
            v = v + scale * rs.randn(*v.shape)
        sd[k] = np.asarray(v, np.float32)
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    return sd


def pair(jcls, tcls, jcfg, tcfg, seed):
    pt.seed(seed)
    jm = jcls(jcfg)
    sd = jittered(jm, seed + 100)
    tm = tcls(tcfg, device="cpu")
    ptt.load_jax_state_dict(tm, sd)
    return jm, tm, sd


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _images(b, c, h, w, seed):
    return np.random.RandomState(seed).randn(b, c, h, w).astype(np.float32)


# ------------------------------------------------------------------ ResNet
@pytest.mark.parametrize("variant", ("b", "d"))
def test_resnet_matches_jax(variant):
    """vB and vD (deep stem, the average-pool shortcut; BottleneckBlock at
    depth 50 for vD): logits and the four feature maps in train mode (the
    batch's statistics) and in eval mode (the running ones), and the
    running statistics an eager train-mode forward leaves, as the JAX
    layers rebind them."""
    over = dict(variant=variant)
    if variant == "d":
        over.update(depth=50, stem_width=8)
    jm, tm, _ = pair(jresnet.ResNet, resnet.ResNet,
                     jresnet.resnet_tiny(**over), resnet.resnet_tiny(**over),
                     seed=1)
    # 2 x 2 maps at the last stage: train-mode statistics over 16 values
    # (over 2, a near-zero variance amplifies fp32 rounding past ATOL)
    x = _images(4, 3, 64, 64, seed=2)
    for mode in ("eval", "train"):
        getattr(jm, mode)()
        getattr(tm, mode)()
        jfeats = jm(jnp.asarray(x), return_feats=True)
        with torch.no_grad():
            feats = tm(torch.from_numpy(x), return_feats=True)
        assert [tuple(f.shape) for f in feats] == [f.shape for f in jfeats]
        for f, jf in zip(feats, jfeats):
            _close(f, jf)
        ref = jm(jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert got.dtype == torch.float32
        _close(got, ref)
    jbuf = {k: v for k, v in _np_sd(jm).items() if "._" in k}
    tbuf = {k: v.numpy() for k, v in tm.state_dict().items() if "._" in k}
    assert set(jbuf) == set(tbuf) and jbuf
    for k in jbuf:
        np.testing.assert_allclose(tbuf[k], jbuf[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_resnet_presets_match_jax_shapes():
    """``resnet18/34/50/50_vd`` build the JAX package's tensors (names and
    shapes) and stage widths."""
    pt.seed(3)
    for name in ("resnet18", "resnet34", "resnet50", "resnet50_vd"):
        jm = getattr(jresnet, name)(num_classes=10)
        tm = getattr(resnet, name)(device="cpu", num_classes=10)
        assert {k: tuple(v.shape) for k, v in jax_state_dict(tm).items()} \
            == {k: tuple(v.shape) for k, v in jm.state_dict().items()}
        assert tm.out_channels == jm.out_channels


# --------------------------------------------------------------------- ViT
VIT_CASES = (dict(), dict(global_pool=True),
             dict(pre_norm=True, hidden_act="quick_gelu"),
             dict(use_class_token=False))


@pytest.mark.parametrize("over", VIT_CASES,
                         ids=("cls", "global-pool", "pre-norm-quick-gelu",
                              "no-cls-token"))
def test_vit_matches_jax(over):
    jm, tm, _ = pair(jvit.ViTForImageClassification,
                     vit.ViTForImageClassification, jvit.vit_tiny(**over),
                     vit.vit_tiny(**over), seed=4)
    x = _images(2, 3, 32, 32, seed=5)
    with torch.no_grad():
        hidden = tm.vit(torch.from_numpy(x))
        got = tm(torch.from_numpy(x))
    _close(hidden, jm.vit(jnp.asarray(x)))
    _close(got, jm(jnp.asarray(x)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)


def test_vision_bf16_keeps_the_jax_dtypes():
    """In bf16 the encoders (ResNet whole, its BatchNorm buffers too) are
    bf16 while ViT's classifier head, CLIP's projections and logit scale
    stay fp32, tensor by tensor as the JAX state dicts have them; the
    logits are fp32."""
    bf = dict(dtype=torch.bfloat16)
    jbf = dict(dtype=jnp.bfloat16)
    cases = ((jresnet.ResNet, resnet.ResNet, jresnet.resnet_tiny(**jbf),
              resnet.resnet_tiny(**bf)),
             (jvit.ViTForImageClassification, vit.ViTForImageClassification,
              jvit.vit_tiny(**jbf), vit.vit_tiny(**bf)))
    for jcls, tcls, jcfg, tcfg in cases:
        pt.seed(6)
        jm, tm = jcls(jcfg), tcls(tcfg, device="cpu")
        assert {k: str(v.dtype).replace("torch.", "")
                for k, v in tm.state_dict().items()} == \
            {k: str(np.asarray(v).dtype) for k, v in jm.state_dict().items()}
        tm.eval()
        with torch.no_grad():
            out = tm(torch.from_numpy(_images(2, 3, 32, 32, 7)).bfloat16())
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
    jcfg = jclip.clip_tiny()
    jcfg.text.dtype = jcfg.vision.dtype = jnp.bfloat16
    tcfg = clip.clip_tiny()
    tcfg.text.dtype = tcfg.vision.dtype = torch.bfloat16
    jm, tm = jclip.CLIPModel(jcfg), clip.CLIPModel(tcfg, device="cpu")
    assert {k: str(v.dtype).replace("torch.", "")
            for k, v in tm.state_dict().items()} == \
        {k: str(np.asarray(v).dtype) for k, v in jm.state_dict().items()}


# -------------------------------------------------------------------- CLIP
def _clip_inputs(b, seed, vocab=128, s=16):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, vocab - 1, (b, s)).astype(np.int32)
    ids[np.arange(b), rs.randint(4, s, b)] = 5      # a custom eos id
    ids[np.arange(b), rs.randint(4, s, b)] = vocab - 1   # the highest id
    return ids, _images(b, 3, 16, 16, seed + 1)


@pytest.mark.parametrize("eos", (None, 5))
def test_clip_towers_and_logits_match_jax(eos):
    """Both towers' hidden states and pooled features (the highest id, or
    the first ``eos_token_id``), the projected features and both logits."""
    jcfg, tcfg = jclip.clip_tiny(), clip.clip_tiny()
    jcfg.text.eos_token_id = tcfg.text.eos_token_id = eos
    jm, tm, _ = pair(jclip.CLIPModel, clip.CLIPModel, jcfg, tcfg, seed=8)
    ids, px = _clip_inputs(4, seed=9)
    jh, jp = jm.text_model(jnp.asarray(ids))
    with torch.no_grad():
        h, p = tm.text_model(torch.from_numpy(ids).long())
        ti = tm.encode_text(torch.from_numpy(ids).long())
        vi = tm.encode_image(torch.from_numpy(px))
        lpi, lpt = tm(torch.from_numpy(ids).long(), torch.from_numpy(px))
    _close(h, jh)
    _close(p, jp)
    _close(ti, jm.encode_text(jnp.asarray(ids)))
    _close(vi, jm.encode_image(jnp.asarray(px)))
    jlpi, jlpt = jm(jnp.asarray(ids), jnp.asarray(px))
    _close(lpi, jlpi)
    _close(lpt, jlpt)
    np.testing.assert_allclose(
        float(clip.clip_contrastive_loss(lpi, lpt)),
        float(jclip.clip_contrastive_loss(jlpi, jlpt)), rtol=1e-5)


# ----------------------------------------------------------------- Trainer
FAMILIES = ("resnet", "vit", "clip")


def _family(name):
    """(JAX pair, JAX loss_fn, port loss_fn, batch)."""
    rs = np.random.RandomState(10)
    if name == "clip":
        jm, tm, sd = pair(jclip.CLIPModel, clip.CLIPModel,
                          jclip.clip_tiny(), clip.clip_tiny(), seed=11)
        ids, px = _clip_inputs(4, seed=12)
        batch = dict(ids=ids, px=px)

        def jloss(fn, p, b):
            return jclip.clip_contrastive_loss(*fn(p, b["ids"], b["px"]))

        def tloss(m, b):
            return clip.clip_contrastive_loss(*m(b["ids"].long(), b["px"]))
        return jm, tm, sd, jloss, tloss, batch
    if name == "resnet":
        jm, tm, sd = pair(jresnet.ResNet, resnet.ResNet,
                          jresnet.resnet_tiny(), resnet.resnet_tiny(),
                          seed=13)
    else:
        jm, tm, sd = pair(jvit.ViTForImageClassification,
                          vit.ViTForImageClassification, jvit.vit_tiny(),
                          vit.vit_tiny(), seed=14)
    batch = dict(px=_images(4, 3, 32, 32, 15),
                 labels=rs.randint(0, 10, 4).astype(np.int32))

    def jloss(fn, p, b):
        return JF.cross_entropy(fn(p, b["px"]), b["labels"])

    def tloss(m, b):
        return F.cross_entropy(m(b["px"]), b["labels"])
    return jm, tm, sd, jloss, tloss, batch


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_steps_match_jax(tmp_path, name):
    """``Trainer(loss_fn=...)``, SGD, 3 steps on one batch in training
    mode: the losses, every parameter after them, and BatchNorm's running
    statistics untouched in both packages."""
    jm, tm, sd, jloss, tloss, batch = _family(name)
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.01),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     loss_fn=jloss,
                     train_dataloader=[{k: jnp.asarray(v)
                                        for k, v in batch.items()}])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.01),
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
        np.testing.assert_array_equal(np.asarray(jm.state_dict()[k]), v)
    assert name != "resnet" or buffers


# ------------------------------------------------------------- CLIP at dp 2
DP = 2


def _dp_payload():
    pt.seed(16)
    jm = jclip.CLIPModel(jclip.clip_tiny())
    params = jittered(jm, 17)
    ids, px = _clip_inputs(8, seed=18)
    return jm, dict(params=params, ids=ids, px=px,
                    mesh={"dp": DP, "tp": 2}, bn_x=_images(6, 3, 5, 4, 19))


def _jax_dp_reference(jm, p):
    """The JAX contrastive loss at dp 2 under ``shard_map``: each shard's
    features against the gathered global batch, labels offset by the
    shard's index. Per-shard losses, and the gradients of their sum."""
    mesh = jenv.init_parallel_env({"dp": DP}, devices=jax.devices()[:DP])
    try:
        _, params = jm.functional()
        names = ("logit_scale", "text_projection", "visual_projection")

        def per_shard(sub, ids, px):
            with jm.bound(sub):
                t = JF.normalize(jm.encode_text(ids), axis=-1)
                v = JF.normalize(jm.encode_image(px), axis=-1)
                scale = jnp.exp(jnp.minimum(jm.logit_scale, math.log(100.0)))
            tg = jclip.gather_features(t, "dp")
            vg = jclip.gather_features(v, "dp")
            loss = jclip.clip_contrastive_loss(scale * v @ tg.T,
                                               scale * t @ vg.T,
                                               dp_axis="dp")
            return loss[None]
        smap = shard_map(per_shard, mesh=mesh, in_specs=(P(), P("dp"),
                                                         P("dp")),
                         out_specs=P("dp"), check_vma=False)
        ids, px = jnp.asarray(p["ids"]), jnp.asarray(p["px"])

        def total(q):
            losses = smap(q, ids, px)
            return losses.sum(), losses
        (_, losses), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(dict(params))
        return np.asarray(losses), {k: np.asarray(grads[k]) for k in names}
    finally:
        jenv.init_parallel_env({})


def test_clip_contrastive_loss_at_dp2_matches_jax(tmp_path):
    """Four gloo ranks on {"dp": 2, "tp": 2}, each dp pair with half the
    batch and each tower's heads split over tp: its features gathered
    over dp, its loss with the labels offset by its dp index; the ranks'
    losses equal the JAX shards', and the gradients of one tp rank of
    each dp pair (the all-gather's backward sums the cotangents over dp;
    the projections are replicated over tp) add up to the JAX gradient
    of the summed loss. In the same world, ``SyncBatchNorm`` in training
    on dp 2 normalises by the global batch's statistics and moves its
    running ones by them, as the JAX layer does on a global array."""
    jm, p = _dp_payload()
    handle = start_world("clip_dp", DP * 2, tmp_path, p)
    want_losses, want_grads = _jax_dp_reference(jm, p)
    ranks = handle.result()
    np.testing.assert_allclose([r["loss"] for r in ranks],
                               [want_losses[r["dp"]] for r in ranks],
                               rtol=1e-5, atol=1e-6)
    for k, g in want_grads.items():
        np.testing.assert_allclose(
            sum(r["grads"][k] for r in ranks if r["tp"] == 0), g,
            atol=1e-5, rtol=1e-4, err_msg=k)
    x = p["bn_x"]
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    y = (x - mean[None, :, None, None]) / np.sqrt(
        var[None, :, None, None] + 1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["y"], np.split(y, DP)[r["dp"]],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["bn"]["mean"], 0.1 * mean, atol=1e-6)
        np.testing.assert_allclose(r["bn"]["var"], 0.9 + 0.1 * var,
                                   atol=1e-6)
