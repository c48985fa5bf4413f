"""The port's convolutions, pools, Batch/Group/Instance norms,
``interpolate`` and ``ctc_loss`` (``paddle_tpu_torch.nn.functional`` and
the layers of ``nn/conv.py`` and ``nn/norm.py``) against the JAX
package's, on the same seeded numpy inputs, fp32 on the CPU.

Tolerances: ``ATOL`` for one conv, pool or norm (the same sums, ordered
otherwise by XLA and torch), ``ATOL_CTC`` for the CTC loss and its
gradient (a 16-step log-space recursion)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

ATOL = 1e-5
ATOL_CTC = 1e-4


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


CONV2D = (  # stride, padding, dilation, groups
    (1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (2, (1, 2), 1, 2),
    (1, "SAME", 1, 1), (2, "SAME", 1, 4), (3, "SAME", 2, 1),
    (2, "VALID", 1, 1))


@pytest.mark.parametrize("stride,padding,dilation,groups", CONV2D)
def test_conv2d_matches_jax(stride, padding, dilation, groups):
    x = _rand(2, 4, 11, 9, seed=1)
    w = _rand(8, 4 // groups, 3, 3, seed=2)
    b = _rand(8, seed=3)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                    padding, dilation, groups)
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride, padding, dilation, groups)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("n", (1, 3))
def test_conv1d_conv3d_match_jax(n):
    x = _rand(2, 3, *(7,) * n, seed=4)
    w = _rand(6, 3, *(3,) * n, seed=5)
    jfn, tfn = (JF.conv1d, F.conv1d) if n == 1 else (JF.conv3d, F.conv3d)
    for stride, padding in ((1, 1), (2, "SAME")):
        ref = jfn(jnp.asarray(x), jnp.asarray(w), None, stride, padding)
        got = tfn(torch.from_numpy(x), torch.from_numpy(w), None, stride,
                  padding)
        _close(got, ref)


CONV_T = (  # stride, padding, output_padding, dilation, groups
    (2, 0, 0, 1, 1), (2, 1, 1, 1, 1), (3, 1, 2, 1, 1), (1, 0, 0, 2, 1),
    (2, 1, 0, 1, 2), (2, 0, 1, 1, 4))


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups",
                         CONV_T)
def test_conv2d_transpose_matches_jax(stride, padding, output_padding,
                                      dilation, groups):
    """The Paddle weight layout [in, out / groups, kh, kw]; output padding
    and groups (the JAX function's group rebuild), as it stands."""
    x = _rand(2, 4, 5, 6, seed=6)
    w = _rand(4, 8 // groups, 3, 2, seed=7)
    b = _rand(8, seed=8)
    args = (stride, padding, output_padding, dilation, groups)
    ref = JF.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              *args)
    got = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), *args)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)
    ref1 = JF.conv1d_transpose(jnp.asarray(x[:, :, 0]), jnp.asarray(w[..., 0]),
                               None, *args)
    got1 = F.conv1d_transpose(torch.from_numpy(x[:, :, 0]),
                              torch.from_numpy(w[..., 0]), None, *args)
    _close(got1, ref1)


def test_conv_bias_added_after_the_rounding_and_dtypes_checked():
    """In bf16 the product is rounded before the bias is added (an fp32
    bias promotes the sum to fp32, as in jnp); mixed operand dtypes
    outside ``auto_cast`` raise, as ``lax.conv`` does; inside it they are
    cast."""
    x = torch.from_numpy(_rand(1, 2, 5, 5, seed=9)).bfloat16()
    w = torch.from_numpy(_rand(3, 2, 3, 3, seed=10)).bfloat16()
    b = torch.from_numpy(_rand(3, seed=11) * 1e3)
    got = F.conv2d(x, w, b, padding=1)
    want = torch.nn.functional.conv2d(x, w, padding=1).float() \
        + b.reshape(1, 3, 1, 1)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="same dtypes"):
        F.conv2d(x.float(), w)
    with pytest.raises(TypeError, match="same dtypes"):
        F.conv2d_transpose(x.float(), w.transpose(0, 1))
    with ptt.amp.auto_cast(dtype="bfloat16"):
        assert F.conv2d(x.float(), w.float()).dtype == torch.bfloat16


POOLS = (  # kernel, stride, padding
    (2, None, 0), (3, 2, 1), ((3, 2), (2, 1), (1, 0)), (3, 1, 1))


@pytest.mark.parametrize("kernel,stride,padding", POOLS)
def test_pools_match_jax(kernel, stride, padding):
    x = _rand(2, 3, 9, 8, seed=12)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(F.max_pool2d(tx, kernel, stride, padding),
           JF.max_pool2d(jx, kernel, stride, padding))
    for exclusive in (True, False):
        _close(F.avg_pool2d(tx, kernel, stride, padding, exclusive),
               JF.avg_pool2d(jx, kernel, stride, padding, exclusive))


def test_adaptive_pools_match_and_refuse_as_jax():
    x = _rand(2, 3, 8, 12, seed=13)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for size in (1, (2, 3), (4, 4)):
        _close(F.adaptive_avg_pool2d(tx, size),
               JF.adaptive_avg_pool2d(jx, size))
        _close(F.adaptive_max_pool2d(tx, size),
               JF.adaptive_max_pool2d(jx, size))
    _close(F.global_avg_pool2d(tx), JF.global_avg_pool2d(jx))
    # a size that does not divide: the JAX assert, a ValueError here
    # (torch's own adaptive pools would accept it)
    for jfn, tfn in ((JF.adaptive_avg_pool2d, F.adaptive_avg_pool2d),
                     (JF.adaptive_max_pool2d, F.adaptive_max_pool2d)):
        with pytest.raises(AssertionError):
            jfn(jx, (3, 5))
        with pytest.raises(ValueError, match="divisible"):
            tfn(tx, (3, 5))


S15, S05, S06 = ("scale", (1.5, 1.5)), ("scale", (0.5, 0.5)), \
    ("scale", (0.6, 0.6))
INTERP = (  # mode, align_corners, ("size", (h, w)) or ("scale", factor)
    ("nearest", False, ("scale", 2)), ("nearest", False, S15),
    ("nearest", False, S05), ("nearest", False, ("size", (9, 5))),
    ("nearest", True, S15),
    ("bilinear", False, ("scale", 2)), ("bilinear", False, S15),
    ("bilinear", False, S05), ("bilinear", False, ("size", (5, 13))),
    ("bicubic", False, ("scale", 2)), ("bicubic", False, S15),
    ("bicubic", False, S06),
    ("bilinear", True, ("scale", 2)), ("bilinear", True, S15),
    ("bilinear", True, S05))


@pytest.mark.parametrize("mode,align_corners,target", INTERP)
def test_interpolate_matches_jax(mode, align_corners, target):
    """Each mode at an upscale, a non-integer scale and a downscale:
    ``nearest`` is half-pixel (torch's ``nearest-exact``), ``bilinear``
    antialiases when it downsamples, ``align_corners`` samples the corner
    grid."""
    x = _rand(2, 3, 8, 10, seed=14)
    kw = dict(size=target[1]) if target[0] == "size" else \
        dict(scale_factor=target[1])
    ref = JF.interpolate(jnp.asarray(x), mode=mode,
                         align_corners=align_corners, **kw)
    got = F.interpolate(torch.from_numpy(x), mode=mode,
                        align_corners=align_corners, **kw)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


def test_nearest_is_half_pixel_not_torch_nearest():
    """At 1.5x torch's ``nearest`` picks other source pixels than
    ``jax.image.resize``; the port gives the JAX ones."""
    x = torch.arange(6.0).reshape(1, 1, 1, 6)
    got = F.interpolate(x, size=(1, 9), mode="nearest")
    ref = np.asarray(JF.interpolate(jnp.asarray(x.numpy()), size=(1, 9)))
    np.testing.assert_array_equal(got.numpy(), ref)
    torch_nearest = torch.nn.functional.interpolate(x, size=(1, 9))
    assert not torch.equal(got, torch_nearest)


def test_batch_norm_training_and_running_stats_match_jax():
    """The batch's fp32 mean and biased variance normalise; the running
    statistics move by Paddle's momentum convention; eval normalises by
    them."""
    x = _rand(4, 3, 5, 6, seed=15) * 3 + 1
    rm, rv = _rand(3, seed=16), np.abs(_rand(3, seed=17)) + 0.5
    w, b = _rand(3, seed=18), _rand(3, seed=19)
    j = [jnp.asarray(a) for a in (x, rm, rv, w, b)]
    t = [torch.from_numpy(a) for a in (x, rm, rv, w, b)]
    ref = JF.batch_norm(j[0], j[1], j[2], j[3], j[4], training=True,
                        momentum=0.8)
    got = F.batch_norm(t[0], t[1], t[2], t[3], t[4], training=True,
                       momentum=0.8)
    for g, r in zip(got, ref):
        _close(g, r)
    _close(F.batch_norm(*t, training=False),
           JF.batch_norm(*j, training=False))
    # 1-D (BatchNorm1D on [N, C, L]) and 3-D inputs share the math
    x3 = _rand(4, 3, 7, seed=20)
    _close(F.batch_norm(torch.from_numpy(x3), t[1], t[2], training=True)[0],
           JF.batch_norm(jnp.asarray(x3), j[1], j[2], training=True)[0])


def test_group_and_instance_norm_match_jax():
    x = _rand(2, 8, 5, 4, seed=21) * 2 + 0.5
    w, b = _rand(8, seed=22), _rand(8, seed=23)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for groups in (1, 2, 8):
        _close(F.group_norm(tx, groups, torch.from_numpy(w),
                            torch.from_numpy(b), 1e-6),
               JF.group_norm(jx, groups, jnp.asarray(w), jnp.asarray(b),
                             1e-6))
    _close(F.group_norm(tx, 4), JF.group_norm(jx, 4))
    _close(F.instance_norm(tx, torch.from_numpy(w), torch.from_numpy(b)),
           JF.instance_norm(jx, jnp.asarray(w), jnp.asarray(b)))


def test_group_norm_rounds_before_the_affine():
    """bf16 input with fp32 weights: normalised in fp32, rounded to bf16,
    then the affine promotes to fp32, as in jnp."""
    x = torch.from_numpy(_rand(2, 4, 3, 3, seed=24)).bfloat16()
    w = torch.from_numpy(_rand(4, seed=25))
    got = F.group_norm(x, 2, w)
    g = x.float().reshape(2, 2, 2, 3, 3)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = (g - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    norm = ((g - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape).bfloat16()
    assert got.dtype == torch.float32
    assert torch.equal(got, norm * w.reshape(1, 4, 1, 1))


def test_activations_and_normalize_match_jax():
    x = _rand(3, 7, seed=26) * 3
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(F.sigmoid(tx), JF.sigmoid(jx))
    _close(F.quick_gelu(tx), JF.quick_gelu(jx))
    for p, axis in ((2, 1), (2, -1), (1, 0)):
        _close(F.normalize(tx, p=p, axis=axis), JF.normalize(jx, p=p,
                                                             axis=axis))
    zero = torch.zeros(2, 3)
    assert torch.equal(F.normalize(zero, axis=-1), zero)


@pytest.mark.parametrize("reduction", ("mean", "sum", "none"))
def test_ctc_loss_matches_jax_with_lengths(reduction):
    """Input and label lengths (an empty label among them), the loss and
    its gradient against the logits."""
    rs = np.random.RandomState(27)
    b, t, c, nl = 4, 16, 7, 5
    logits = rs.randn(b, t, c).astype(np.float32)
    labels = rs.randint(1, c, (b, nl)).astype(np.int32)
    labels[1, 2] = labels[1, 1]            # a repeat needs a blank between
    in_lens = np.array([16, 12, 16, 9], np.int32)
    lab_lens = np.array([5, 3, 0, 4], np.int32)

    def jloss(lg):
        out = JF.ctc_loss(lg, jnp.asarray(labels), jnp.asarray(in_lens),
                          jnp.asarray(lab_lens), reduction=reduction)
        return out.sum()
    ref, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = F.ctc_loss(tl, torch.from_numpy(labels), torch.from_numpy(in_lens),
                     torch.from_numpy(lab_lens), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.sum().item(), float(ref), atol=ATOL_CTC,
                               rtol=1e-5)
    _close(tl.grad, jgrad, atol=ATOL_CTC)
    # with no lengths given: every frame and every label counts
    np.testing.assert_allclose(
        F.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(JF.ctc_loss(jnp.asarray(logits), jnp.asarray(labels))),
        atol=ATOL_CTC, rtol=1e-5)


def _jax_layer_sd(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def test_conv_and_pool_layers_match_jax():
    """``Conv1D``/``Conv2D``/``Conv3D``/``Conv2DTranspose`` carry the JAX
    weights untransposed; the pool layers wrap the functions. The
    initializers' bounds are the JAX ones (Kaiming-uniform on fan_in =
    in / groups x kernel, the bias U(+-1/sqrt(fan_in)))."""
    pt.seed(28)
    gen = ptt.make_generator(0, "cpu")
    cases = (
        (jnn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2),
         nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2, generator=gen,
                   device="cpu"), (2, 4, 9, 9)),
        (jnn.Conv1D(3, 5, 3, padding="SAME", bias_attr=False),
         nn.Conv1D(3, 5, 3, padding="SAME", bias_attr=False, generator=gen,
                   device="cpu"), (2, 3, 8)),
        (jnn.Conv3D(2, 4, 2), nn.Conv3D(2, 4, 2, generator=gen,
                                        device="cpu"), (1, 2, 4, 4, 4)),
        (jnn.Conv2DTranspose(4, 6, 2, stride=2, output_padding=1),
         nn.Conv2DTranspose(4, 6, 2, stride=2, output_padding=1,
                            generator=gen, device="cpu"), (2, 4, 5, 5)),
    )
    for i, (jl, tl, shape) in enumerate(cases):
        sd = _jax_layer_sd(jl)
        assert {k: v.shape for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in tl.state_dict().items()}
        ptt.load_jax_state_dict(tl, sd)
        x = _rand(*shape, seed=29 + i)
        with torch.no_grad():
            _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
    conv = nn.Conv2D(8, 16, 3, groups=2, generator=gen, device="cpu")
    bound = np.sqrt(2.0) * np.sqrt(3.0 / (4 * 9))
    assert float(conv.weight.abs().max()) <= bound
    assert float(conv.bias.abs().max()) <= 1 / np.sqrt(4 * 9)
    x = _rand(2, 3, 8, 8, seed=33)
    for jl, tl in ((jnn.MaxPool2D(3, 2, 1), nn.MaxPool2D(3, 2, 1)),
                   (jnn.AvgPool2D(2, 2), nn.AvgPool2D(2, 2)),
                   (jnn.AdaptiveAvgPool2D(2), nn.AdaptiveAvgPool2D(2)),
                   (jnn.AdaptiveMaxPool2D((4, 2)),
                    nn.AdaptiveMaxPool2D((4, 2)))):
        _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))


def test_norm_layers_match_jax_and_keep_buffers_under_the_trainer(tmp_path):
    """``BatchNorm2D`` (buffers ``_mean`` and ``_variance``): an eager
    train-mode forward moves the running statistics, as the JAX layer's
    does; ``Trainer`` steps leave them where they were, as the JAX
    Trainer's step does (``model.functional()`` binds no buffers and
    ``Layer.bound`` restores them), while the batch's statistics still
    normalise. ``GroupNorm`` (no affine too) and ``InstanceNorm2D``."""
    pt.seed(34)
    jbn = jnn.BatchNorm2D(3, momentum=0.7)
    tbn = nn.BatchNorm2D(3, momentum=0.7, device="cpu")
    sd = _jax_layer_sd(jbn)
    assert set(sd) == {"weight", "bias", "_mean", "_variance"}
    sd["weight"] = _rand(3, seed=35)
    sd["_mean"] = _rand(3, seed=36)
    jbn.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    ptt.load_jax_state_dict(tbn, sd)
    x = _rand(4, 3, 5, 5, seed=37) + 2
    with torch.no_grad():
        _close(tbn(torch.from_numpy(x)), jbn(jnp.asarray(x)))
    for name in ("_mean", "_variance"):
        _close(getattr(tbn, name), getattr(jbn, name))
        assert not np.allclose(getattr(tbn, name).numpy(), sd[name])
    tbn.eval()
    jbn.eval()
    _close(tbn(torch.from_numpy(x)), jbn(jnp.asarray(x)))
    for jl, tl in ((jnn.GroupNorm(2, 4), nn.GroupNorm(2, 4, device="cpu")),
                   (jnn.GroupNorm(4, 4, weight_attr=False, bias_attr=False),
                    nn.GroupNorm(4, 4, weight_attr=False, bias_attr=False,
                                 device="cpu")),
                   (jnn.InstanceNorm2D(4), nn.InstanceNorm2D(4,
                                                             device="cpu"))):
        sd = _jax_layer_sd(jl)
        assert set(sd) == set(tl.state_dict())
        ptt.load_jax_state_dict(tl, sd)
        xg = _rand(2, 4, 3, 5, seed=38)
        _close(tl(torch.from_numpy(xg)), jl(jnp.asarray(xg)))
    # the Trainer: the JAX step's losses, and the buffers where they were
    from paddle_tpu.trainer import Trainer as JaxTrainer
    from paddle_tpu.trainer import TrainingArguments as JaxArgs
    pt.seed(39)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4))
    tm = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1,
                                 generator=ptt.make_generator(0, "cpu"),
                                 device="cpu"),
                       nn.BatchNorm2D(4, device="cpu"))
    sd = _jax_layer_sd(jm)
    sd["1._mean"] = _rand(4, seed=40)
    sd["1._variance"] = np.abs(_rand(4, seed=41)) + 0.5
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    ptt.load_jax_state_dict(tm, sd)
    xb = _rand(4, 3, 6, 6, seed=42)
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.05),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     loss_fn=lambda fn, p, b: jnp.mean(fn(p, b) ** 2),
                     train_dataloader=[jnp.asarray(xb)])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.05),
                      ptt.TrainingArguments(output_dir=str(tmp_path / "pt"),
                                            graceful_shutdown=False, **kw),
                      loss_fn=lambda m, b: (m(b) ** 2).mean(),
                      train_dataloader=[torch.from_numpy(xb)])
    ttr.train()
    np.testing.assert_allclose([v for _, v in ttr.logger.history["loss"]],
                               [v for _, v in jtr.logger.history["loss"]],
                               rtol=1e-5)
    for name in ("1._mean", "1._variance"):
        np.testing.assert_array_equal(tm.state_dict()[name].numpy(),
                                      sd[name])
        np.testing.assert_array_equal(np.asarray(jm.state_dict()[name]),
                                      sd[name])


def test_sync_batch_norm_is_batch_norm_at_a_world_of_one():
    """``SyncBatchNorm`` at a world of one is ``BatchNorm``; its
    ``convert_sync_batchnorm`` returns the layer (the JAX package's GSPMD
    statistics are global; the port's dp > 1 raises, see the multi-rank
    refusal test)."""
    tbn = nn.SyncBatchNorm(3, device="cpu")
    assert nn.SyncBatchNorm.convert_sync_batchnorm(tbn) is tbn
    assert nn.BatchNorm is nn.BatchNorm2D is nn.BatchNorm1D is nn.BatchNorm3D
    x = torch.from_numpy(_rand(4, 3, 5, seed=43))
    ref = nn.BatchNorm1D(3, device="cpu")
    with torch.no_grad():
        assert torch.equal(tbn(x), ref(x))
