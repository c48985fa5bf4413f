"""The port's DiT, MMDiT, AutoencoderKL, schedulers, ``sample_loop`` and
pipelines against the JAX package's, fp32 on the CPU.

Weights: each JAX model is built from its seed and its parameters
perturbed by seeded numpy noise (adaLN-Zero would otherwise make every
block the identity and every output zero), then carried across with
``load_jax_state_dict``.

Randomness: JAX draws x_T and the DDPM/DDIM noise from threefry keys,
which torch has no counterpart of. So x_T is drawn from a seeded
``torch.Generator`` in the order the port's ``sample_loop`` draws it, the
JAX reference loop (its own ``timesteps`` and ``step``) starts from that
x_T, and the deterministic samplers (DDIM at eta 0, flow matching) are
compared latent for latent; DDPM and DDIM at eta > 0 are compared by
their step means (``key=None`` / ``noise=None``) and their noise term by
its mean and variance. The JAX pipelines run with their x_T draw replaced
by the same array.

Tolerances: ``ATOL`` for one forward (the zoo tests'), ``ATOL_LOOP`` for
latents after several steps (each step's forward error carried on),
``RTOL_LOSS`` / ``ATOL_PARAMS`` for the Trainer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.diffusion import pipelines as jpipes
from paddle_tpu.diffusion import schedulers as jsched
from paddle_tpu.models import dit as jdit
from paddle_tpu.models import vae as jvae
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.diffusion import pipelines, schedulers
from paddle_tpu_torch.models import dit, vae

ATOL = 1e-4
ATOL_LOOP = 2e-4
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
    sd = {k: np.asarray(np.asarray(v) + scale * rs.randn(*np.shape(v)),
                        np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    tm = tcls(tcfg, device="cpu")
    ptt.load_jax_state_dict(tm, sd)
    return jm, tm, sd


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ models
def test_embeddings_match_jax():
    """Timestep features (cos before sin; fp32 cos and sin of arguments up
    to 999 differ by an ulp of the argument between XLA and torch) and the
    2-D sin-cos table."""
    t = np.array([0, 1, 17, 999], np.int32)
    _close(dit.timestep_embedding(torch.from_numpy(t), 256),
           jdit.timestep_embedding(jnp.asarray(t), 256))
    _close(dit.sincos_pos_embed_2d(4, 64), jdit.sincos_pos_embed_2d(4, 64),
           atol=1e-6)


def test_dit_matches_jax_with_the_null_class_mask():
    """Outputs (learned sigma: twice the channels) with labels, and with a
    drop mask that swaps rows to the null class; ``pos_embed`` is frozen
    (``requires_grad`` False) and carried as the JAX table."""
    jm, tm, _ = pair(jdit.DiT, dit.DiT, jdit.dit_tiny(), dit.dit_tiny(),
                     seed=1)
    assert not tm.pos_embed.requires_grad
    x = _rand(4, 4, 8, 8, seed=2)
    t = np.array([1, 250, 600, 999], np.int32)
    y = np.array([0, 3, 7, 9], np.int32)
    drop = np.array([False, True, False, True])
    for mask in (None, drop):
        ref = jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                 None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(y).long(),
                     None if mask is None else torch.from_numpy(mask))
        assert tuple(got.shape) == (4, 8, 8, 8)
        _close(got, ref)


def test_mmdit_matches_jax():
    """The joint blocks (the last text stream attention-only), pooled and
    sequence conditioning."""
    jm, tm, _ = pair(jdit.MMDiT, dit.MMDiT, jdit.mmdit_tiny(),
                     dit.mmdit_tiny(), seed=3)
    x = _rand(2, 4, 8, 8, seed=4)
    t = np.array([10, 700], np.int32)
    ctx, pooled = _rand(2, 5, 48, seed=5), _rand(2, 32, seed=6)
    ref = jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
             jnp.asarray(pooled))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 torch.from_numpy(ctx), torch.from_numpy(pooled))
    _close(got, ref)
    assert "blocks.1.txt.proj.weight" not in tm.state_dict()


def test_vae_encode_decode_kl_match_jax():
    """The posterior's mean, std and KL, the decode of its mode, the
    forward, and a sample drawn from a generator (its noise term has the
    posterior's std)."""
    jm, tm, _ = pair(jvae.AutoencoderKL, vae.AutoencoderKL, jvae.vae_tiny(),
                     vae.vae_tiny(), seed=7)
    x = _rand(2, 3, 16, 16, seed=8)
    jpost = jm.encode(jnp.asarray(x))
    with torch.no_grad():
        post = tm.encode(torch.from_numpy(x))
        _close(post.mean, jpost.mean)
        _close(post.std, jpost.std)
        _close(post.kl(), jpost.kl(), atol=1e-3)
        _close(tm.decode(post.mode()), jm.decode(jpost.mode()))
        recon, _ = tm(torch.from_numpy(x))
        _close(recon, jm(jnp.asarray(x))[0])
        gen = torch.Generator().manual_seed(9)
        z = post.sample(gen)
        noise = torch.randn(post.mean.shape,
                            generator=torch.Generator().manual_seed(9))
        torch.testing.assert_close(z, post.mean + post.std * noise)
    np.testing.assert_allclose(
        float(vae.vae_loss(recon, torch.from_numpy(x), post)),
        float(jvae.vae_loss(jm(jnp.asarray(x))[0], jnp.asarray(x), jpost)),
        rtol=1e-5)


def test_bf16_backbone_outside_auto_cast_raises_as_in_jax():
    """fp32 latents into a bf16 DiT: ``lax.conv`` refuses the mixed
    dtypes in JAX and the port raises the same ``TypeError``; under
    ``auto_cast`` both run."""
    pt.seed(10)
    jm = jdit.DiT(jdit.dit_tiny(dtype=jnp.bfloat16))
    tm = dit.DiT(dit.dit_tiny(dtype=torch.bfloat16), device="cpu")
    x, t, y = _rand(2, 4, 8, 8, seed=11), np.array([1, 2]), np.array([3, 4])
    with pytest.raises(TypeError, match="same dtypes"):
        jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with pytest.raises(TypeError, match="same dtypes"):
        tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    with ptt.amp.auto_cast(dtype="bfloat16"):
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(y))
    assert torch.isfinite(out.float()).all()


# -------------------------------------------------------------- schedulers
SCHEDULES = ("linear", "scaled_linear", "squaredcos_cap_v2")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_scheduler_tables_and_training_terms_match_jax(schedule):
    js = jsched.DDPMScheduler(beta_schedule=schedule,
                              prediction_type="v_prediction")
    ts = schedulers.DDPMScheduler(beta_schedule=schedule,
                                  prediction_type="v_prediction")
    # the cosine schedule's 1 - f[t + 1] / f[t] cancels: an ulp of fp32
    # cos (XLA's and torch's differ) shows as up to 4e-7 there
    _close(ts.betas, js.betas, atol=1e-6)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), rtol=2e-5)
    x0, noise = _rand(3, 4, 5, 5, seed=12), _rand(3, 4, 5, 5, seed=13)
    t = np.array([0, 499, 999], np.int32)
    jargs = (jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    targs = (torch.from_numpy(x0), torch.from_numpy(noise),
             torch.from_numpy(t))
    for fn in ("add_noise", "velocity", "training_target"):
        _close(getattr(ts, fn)(*targs), getattr(js, fn)(*jargs), atol=1e-5)
    jf, tf = jsched.FlowMatchScheduler(shift=3.0), \
        schedulers.FlowMatchScheduler(shift=3.0)
    for fn in ("add_noise", "training_target"):
        _close(getattr(tf, fn)(*targs), getattr(jf, fn)(*jargs), atol=1e-6)


@pytest.mark.parametrize("n", (1, 4, 7, 50))
def test_timestep_grids_equal_jax(n):
    for jcls, tcls in ((jsched.DDIMScheduler, schedulers.DDIMScheduler),
                       (jsched.FlowMatchScheduler,
                        schedulers.FlowMatchScheduler)):
        np.testing.assert_array_equal(tcls().timesteps(n).numpy(),
                                      np.asarray(jcls().timesteps(n)))


def test_steps_match_jax_means_and_noise_terms():
    """DDPM and DDIM (eta 0 and 0.7, the prev_t < 0 final step): the step
    without noise equals the JAX step without a key; with standard normal
    noise the added term is the JAX step's sigma times it (its mean 0 and
    variance the posterior's over a large draw)."""
    rs = np.random.RandomState(14)
    x, eps = rs.randn(2, 4, 6, 6).astype(np.float32), \
        rs.randn(2, 4, 6, 6).astype(np.float32)
    t = np.array([500, 20], np.int32)
    prev = np.array([480, -1], np.int32)
    jx, jeps, jt = jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t)
    tx, teps, tt = map(torch.from_numpy, (x, eps, t))
    jd, td = jsched.DDPMScheduler(), schedulers.DDPMScheduler()
    _close(td.step(teps, tt, tx), jd.step(jeps, jt, jx), atol=1e-5)
    for eta in (0.0, 0.7):
        jdi = jsched.DDIMScheduler(eta=eta)
        tdi = schedulers.DDIMScheduler(eta=eta)
        _close(tdi.step(teps, tt, tx, prev_t=torch.from_numpy(prev)),
               jdi.step(jeps, jt, jx, prev_t=jnp.asarray(prev)), atol=1e-5)
    # the noise term: N draws of the JAX step with keys against the port's
    # with generator noise, at one t (no final step: all rows add noise)
    big = 4096
    tb = np.full(big, 500, np.int32)
    xs = np.zeros((big, 1, 1, 1), np.float32)
    gen = torch.Generator().manual_seed(15)
    for jsc, tsc, kw in ((jd, td, {}),
                         (jsched.DDIMScheduler(eta=0.7),
                          schedulers.DDIMScheduler(eta=0.7),
                          dict(prev_t=np.full(big, 480, np.int32)))):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        jmean = np.asarray(jsc.step(jnp.zeros_like(xs), jnp.asarray(tb),
                                    jnp.asarray(xs), **jkw))
        jdraw = np.asarray(jsc.step(jnp.zeros_like(xs), jnp.asarray(tb),
                                    jnp.asarray(xs),
                                    key=jax.random.PRNGKey(16), **jkw))
        noise = torch.randn(xs.shape, generator=gen)
        tmean = tsc.step(torch.zeros(xs.shape), torch.from_numpy(tb),
                         torch.from_numpy(xs), **tkw).numpy()
        tdraw = tsc.step(torch.zeros(xs.shape), torch.from_numpy(tb),
                         torch.from_numpy(xs), noise=noise, **tkw).numpy()
        np.testing.assert_allclose(tmean, jmean, atol=1e-6)
        jterm, tterm = (jdraw - jmean).ravel(), (tdraw - tmean).ravel()
        # 4096 draws: the sample std is within ~4 % of sigma
        assert abs(tterm.std() / jterm.std() - 1) < 0.08
        assert abs(tterm.mean()) < 0.1 * jterm.std()


def _jax_loop(scheduler, model_fn, x_t, n):
    """The JAX reverse process from a given x_T, with the JAX scheduler's
    own ``timesteps`` and ``step`` (no key: the deterministic samplers)."""
    x = jnp.asarray(x_t)
    ts = scheduler.timesteps(n)
    prev = jnp.concatenate([ts[1:], jnp.array([-1], ts.dtype)])
    b = x.shape[0]
    for t, p in zip(ts, prev):
        tb = jnp.full((b,), t, jnp.int32)
        out = model_fn(x, tb)
        pb = jnp.full((b,), p)
        x = scheduler.step(out, tb, x, prev_t=pb)
    return x


@pytest.mark.parametrize("kind", ("ddim", "flow"))
def test_sample_loop_matches_jax_from_the_same_x_t(kind):
    """``sample_loop`` on a DiT (DDIM at eta 0) or an MMDiT (flow matching,
    shift 3) from the x_T its generator draws first, against the JAX loop
    from that x_T."""
    n = 4
    if kind == "ddim":
        jm, tm, _ = pair(jdit.DiT, dit.DiT, jdit.dit_tiny(), dit.dit_tiny(),
                         seed=17)
        jsc, tsc = jsched.DDIMScheduler(), schedulers.DDIMScheduler()
        y = np.array([2, 5])

        def jfn(x, t):
            return jm(x, t, jnp.asarray(y))[:, :4]

        def tfn(x, t):
            return tm(x, t, torch.from_numpy(y))[:, :4]
    else:
        jm, tm, _ = pair(jdit.MMDiT, dit.MMDiT, jdit.mmdit_tiny(),
                         dit.mmdit_tiny(), seed=18)
        jsc = jsched.FlowMatchScheduler(shift=3.0)
        tsc = schedulers.FlowMatchScheduler(shift=3.0)
        ctx, pooled = _rand(2, 5, 48, seed=19), _rand(2, 32, seed=20)

        def jfn(x, t):
            return jm(x, t, jnp.asarray(ctx), jnp.asarray(pooled))

        def tfn(x, t):
            return tm(x, t, torch.from_numpy(ctx), torch.from_numpy(pooled))
    shape = (2, 4, 8, 8)
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(21))
    with torch.no_grad():
        got = schedulers.sample_loop(tsc, tfn, shape, n,
                                     torch.Generator().manual_seed(21))
    _close(got, _jax_loop(jsc, jfn, x_t.numpy(), n), atol=ATOL_LOOP)


def test_sample_loop_draws_noise_for_ddpm():
    """DDPM draws x_T then one block of every step's noise: the loop from
    the generator equals the loop fed those draws step by step."""
    sc = schedulers.DDPMScheduler()
    shape, n = (2, 3, 4, 4), 3

    def fn(x, t):
        return 0.5 * x
    got = schedulers.sample_loop(sc, fn, shape, n,
                                 torch.Generator().manual_seed(22))
    gen = torch.Generator().manual_seed(22)
    x = torch.randn(shape, generator=gen)
    noise = torch.randn((n,) + shape, generator=gen)
    for i, t in enumerate(sc.timesteps(n)):
        x = sc.step(fn(x, None), t.expand(2), x, noise=noise[i])
    torch.testing.assert_close(got, x, rtol=0, atol=0)


def test_diffusion_loss_drops_the_learned_sigma_half():
    jm, tm, _ = pair(jdit.DiT, dit.DiT, jdit.dit_tiny(), dit.dit_tiny(),
                     seed=23)
    x0, noise = _rand(2, 4, 8, 8, seed=24), _rand(2, 4, 8, 8, seed=25)
    t, y = np.array([3, 800]), np.array([1, 2])
    ref = jsched.diffusion_loss(jsched.DDPMScheduler(), jm, jnp.asarray(x0),
                                jnp.asarray(t), jnp.asarray(noise),
                                jnp.asarray(y))
    with torch.no_grad():
        got = schedulers.diffusion_loss(
            schedulers.DDPMScheduler(), tm, torch.from_numpy(x0),
            torch.from_numpy(t), torch.from_numpy(noise),
            torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# --------------------------------------------------------------- pipelines
class _FixedDraw:
    """Stands in for the ``jax`` module inside the JAX schedulers: its
    ``random.normal`` returns ``x_t`` (the JAX pipelines' first draw),
    everything else is jax's."""

    def __init__(self, x_t):
        outer = self

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape, dtype=jnp.float32):
                assert tuple(shape) == outer.x_t.shape
                return jnp.asarray(outer.x_t, dtype)
        self.x_t = x_t
        self.random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


PIPES = ("dit", "sd3")


@pytest.mark.parametrize("kind", PIPES)
def test_pipelines_match_jax(kind, monkeypatch):
    """``DiTPipeline`` (DDIM, guidance 4) and ``StableDiffusion3Pipeline``
    (flow matching, guidance 7), 3 steps, decoded by the same VAE, against
    the JAX pipelines from the same x_T. A second call at a new guidance
    scale reuses the program (one cached) and moves the images; a new
    step count builds another."""
    n = 3
    pt.seed(26)
    _, tvae, _ = pair(jvae.AutoencoderKL, vae.AutoencoderKL,
                      jvae.vae_tiny(), vae.vae_tiny(), seed=27)
    jvae_m = jvae.AutoencoderKL(jvae.vae_tiny())
    jvae_m.set_state_dict({k: jnp.asarray(v.detach().numpy())
                           for k, v in ptt.convert.jax_state_dict(tvae)
                           .items()})
    if kind == "dit":
        jm, tm, _ = pair(jdit.DiT, dit.DiT, jdit.dit_tiny(), dit.dit_tiny(),
                         seed=28)
        jp = jpipes.DiTPipeline(jm, jvae_m)
        tp = pipelines.DiTPipeline(tm, tvae)
        args, scale = ([1, 7],), 4.0
        jargs = (jnp.asarray([1, 7]),)
    else:
        jm, tm, _ = pair(jdit.MMDiT, dit.MMDiT, jdit.mmdit_tiny(),
                         dit.mmdit_tiny(), seed=29)
        jp = jpipes.StableDiffusion3Pipeline(jm, jvae_m)
        tp = pipelines.StableDiffusion3Pipeline(tm, tvae)
        ctx, pooled = _rand(2, 5, 48, seed=30), _rand(2, 32, seed=31)
        args = (torch.from_numpy(ctx), torch.from_numpy(pooled))
        jargs = (jnp.asarray(ctx), jnp.asarray(pooled))
        scale = 7.0
    shape = (2, 4, 8, 8)
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(32))
    monkeypatch.setattr(jsched, "jax", _FixedDraw(x_t.numpy()))
    ref = jp(*jargs, num_inference_steps=n, guidance_scale=scale)
    got = tp(*args, num_inference_steps=n, guidance_scale=scale,
             generator=torch.Generator().manual_seed(32))
    assert tuple(got.shape) == (2, 3, 16, 16)
    _close(got, ref, atol=ATOL_LOOP)
    again = tp(*args, num_inference_steps=n, guidance_scale=scale + 2.0,
               generator=torch.Generator().manual_seed(32))
    assert len(tp._programs) == 1
    assert not torch.allclose(again, got)
    _close(again, jp(*jargs, num_inference_steps=n,
                     guidance_scale=scale + 2.0), atol=ATOL_LOOP)
    tp(*args, num_inference_steps=2,
       generator=torch.Generator().manual_seed(32))
    assert len(tp._programs) == 2


def test_pipeline_program_cache_follows_the_scheduler():
    """Swapping ``pipe.scheduler`` takes effect at the next call (a new
    program keyed by its identity), as the JAX engines are keyed; a DDPM
    scheduler's steps read their noise from the program's buffer."""
    pt.seed(33)
    tm = dit.DiT(dit.dit_tiny(), device="cpu")
    pipe = pipelines.DiTPipeline(tm)
    a = pipe([1, 2], num_inference_steps=2,
             generator=torch.Generator().manual_seed(34))
    pipe.scheduler = schedulers.DDPMScheduler()
    b = pipe([1, 2], num_inference_steps=2,
             generator=torch.Generator().manual_seed(34))
    assert len(pipe._programs) == 2 and not torch.equal(a, b)
    # zero-initialised DiT: eps = 0, so DDPM's steps are its posterior
    # mean plus the noise drawn after x_T
    gen = torch.Generator().manual_seed(34)
    x = torch.randn(a.shape, generator=gen)
    noise = torch.randn((2,) + tuple(a.shape), generator=gen)
    sc = pipe.scheduler
    for i, t in enumerate(sc.timesteps(2)):
        x = sc.step(torch.zeros_like(x), t.expand(2), x, noise=noise[i])
    torch.testing.assert_close(b, x)


# ----------------------------------------------------------------- Trainer
@pytest.mark.parametrize("name", ("dit", "vae"))
def test_trainer_steps_match_jax(tmp_path, name):
    """``Trainer(loss_fn=...)``, SGD, 3 steps: DiT under
    ``diffusion_loss`` (DDPM targets, the sigma half dropped; the frozen
    ``pos_embed`` untouched) and the VAE under ``vae_loss``; losses and
    every parameter after the steps."""
    if name == "dit":
        jm, tm, sd = pair(jdit.DiT, dit.DiT, jdit.dit_tiny(), dit.dit_tiny(),
                          seed=35)
        batch = dict(x0=_rand(4, 4, 8, 8, seed=36),
                     noise=_rand(4, 4, 8, 8, seed=37),
                     t=np.array([5, 300, 600, 990], np.int32),
                     y=np.array([0, 1, 2, 3], np.int32))
        js, ts = jsched.DDPMScheduler(), schedulers.DDPMScheduler()

        def jloss(fn, p, b):
            return jsched.diffusion_loss(
                js, lambda x, t, y: fn(p, x, t, y), b["x0"], b["t"],
                b["noise"], b["y"])

        def tloss(m, b):
            return schedulers.diffusion_loss(ts, m, b["x0"], b["t"].long(),
                                             b["noise"], b["y"].long())
    else:
        jm, tm, sd = pair(jvae.AutoencoderKL, vae.AutoencoderKL,
                          jvae.vae_tiny(), vae.vae_tiny(), seed=38)
        batch = dict(x=_rand(2, 3, 16, 16, seed=39))

        def jloss(fn, p, b):
            recon, post = fn(p, b["x"])
            return jvae.vae_loss(recon, b["x"], post)

        def tloss(m, b):
            recon, post = m(b["x"])
            return vae.vae_loss(recon, b["x"], post)
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.05),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     loss_fn=jloss,
                     train_dataloader=[{k: jnp.asarray(v)
                                        for k, v in batch.items()}])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.05),
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
    ref = type(tm)(tm.config, device="cpu")
    ptt.load_jax_state_dict(ref, {**sd, **{k: np.asarray(v) for k, v in
                                           jtr._params.items()}})
    want = dict(ref.named_parameters())
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k].detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0, err_msg=k)
    if name == "dit":
        np.testing.assert_array_equal(tm.pos_embed.numpy(), sd["pos_embed"])
