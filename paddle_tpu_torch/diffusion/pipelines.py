"""Diffusion pipelines (counterpart of ``paddle_tpu/diffusion/pipelines.py``:
``DiTPipeline``, ``StableDiffusion3Pipeline``).

The JAX package makes the whole reverse process one jitted program (a
``lax.scan``). The port's form of it is one CUDA graph for a denoising
step, replayed once a step: the step reads the latents, the grid of
timesteps, the step index, the guidance scale, the conditioning and (for
a scheduler that draws noise) the steps' noise from fixed device
buffers, runs the classifier-free-guidance doubling, the backbone and the
scheduler step, and writes the latents and the index back in place
(``_DenoiseProgram`` over ``generation.graphs``: captured on its first
call, as ``generate()``'s decode step is). No host read happens inside
the loop. On the CPU the same step runs eagerly, and on a card inside
``generation.eager_steps()`` too: the graphed loop equals that eager
loop bit for bit.

Programs are cached per pipeline instance, keyed as the JAX engines are
(the step count and the scheduler's identity; the program holds its
scheduler, so the identity stays its own) and by the batch's shapes and
the ``amp.auto_cast`` dtype the step was captured under. Dropping the
pipeline frees them; replacing or moving the backbone's weights drops
them (``graphs.ExecCache``). A new guidance scale is a new value in its
buffer, not a new graph.

Randomness: x_T (and, for DDPM or DDIM with eta > 0, one block of every
step's noise after it) is drawn from the ``torch.Generator`` passed as
``generator``, or from a seed-0 generator, as the JAX pipelines default
to ``PRNGKey(0)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..amp import amp_dtype
from ..generation.graphs import DecodeProgram, ExecCache, buffer_bytes
from ..utils.rng import make_generator
from .schedulers import DDIMScheduler, FlowMatchScheduler, scheduler_step


def _guide(cond, uncond, scale):
    """uncond + scale * (cond - uncond), with the fp32 scale promoting the
    difference as ``jnp`` promotes against a float32 scalar (torch would
    keep a 0-d fp32 tensor against bf16 in bf16)."""
    dt = torch.promote_types(cond.dtype, scale.dtype)
    return uncond.to(dt) + scale * (cond - uncond).to(dt)


class _DenoiseProgram(DecodeProgram):
    """The denoising loop of one pipeline call shape over fixed device
    buffers; ``_step`` is one step (see the module docstring)."""

    def __init__(self, guided, scheduler, shape, n_steps, cond, device):
        super().__init__(device)
        self.guided, self.scheduler, self.n_steps = guided, scheduler, n_steps
        ts = scheduler.timesteps(n_steps).long()
        self.ts = ts.to(device)
        self.prev_ts = torch.cat([ts[1:], ts.new_full((1,), -1)]).to(device)
        self.idx = torch.zeros(1, dtype=torch.long, device=device)
        self.x = torch.zeros(shape, dtype=torch.float32, device=device)
        self.scale = torch.zeros((), dtype=torch.float32, device=device)
        self.noise = torch.zeros((n_steps,) + tuple(shape),
                                 dtype=torch.float32, device=device) \
            if scheduler.draws_noise else None
        self.cond = tuple(torch.zeros_like(c) for c in cond)
        self.nbytes = buffer_bytes(self.x, self.noise, self.cond)

    def _run(self, x_t, noise, scale, cond):
        self.x.copy_(x_t)
        if noise is not None:
            self.noise.copy_(noise)
        self.scale.fill_(scale)
        for dst, src in zip(self.cond, cond):
            dst.copy_(src)
        self.idx.zero_()
        self.run_steps(self.n_steps)
        return self.x.clone()

    def _step(self):
        b = self.x.shape[0]
        t = self.ts.index_select(0, self.idx).expand(b)
        prev_t = self.prev_ts.index_select(0, self.idx).expand(b)
        out = self.guided(self.x, t, self.scale, *self.cond)
        noise = None if self.noise is None \
            else self.noise.index_select(0, self.idx)[0]
        self.x.copy_(scheduler_step(self.scheduler, out, t, prev_t, self.x,
                                    noise))
        self.idx.add_(1)


class _PipelineBase:
    def __init__(self, backbone, vae):
        self.vae = vae
        if vae is not None:
            vae.eval()
        self.device = next(backbone.parameters()).device
        self._programs = ExecCache(backbone)

    def _sample(self, shape, num_steps, guidance_scale, generator, cond):
        """The latents after ``num_steps`` denoising steps from a fresh
        x_T (drawn, with the steps' noise, from ``generator``)."""
        gen = generator or make_generator(0, self.device)
        sched = self.scheduler
        x_t = torch.randn(shape, generator=gen, device=self.device)
        noise = torch.randn((num_steps,) + tuple(shape), generator=gen,
                            device=self.device) \
            if sched.draws_noise else None
        key = (num_steps, id(sched), tuple(shape),
               tuple((tuple(c.shape), c.dtype) for c in cond), amp_dtype())
        prog = self._programs.get(key, lambda: _DenoiseProgram(
            self._guided, sched, shape, num_steps, cond, self.device))
        return prog.run(x_t, noise, float(guidance_scale), cond)

    def _decode(self, latents):
        if self.vae is None:
            return latents
        return self.vae.decode(latents / self.vae.config.scaling_factor)


class DiTPipeline(_PipelineBase):
    """Class-conditional latent diffusion: DiT + AutoencoderKL + DDIM."""

    def __init__(self, dit, vae=None,
                 scheduler: Optional[DDIMScheduler] = None):
        super().__init__(dit, vae)
        self.dit = dit
        self.scheduler = scheduler or DDIMScheduler(num_train_timesteps=1000)

    def _guided(self, x, t, scale, labels2, null_mask):
        b = x.shape[0]
        out = self.dit(torch.cat([x, x]), torch.cat([t, t]), labels2,
                       null_mask)
        eps = out[:, :self.dit.config.in_channels]   # drop learned sigma
        return _guide(eps[:b], eps[b:], scale)

    @torch.no_grad()
    def __call__(self, class_labels, num_inference_steps: int = 50,
                 guidance_scale: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        """Decoded images [b, c, h, w] (the latents when there is no VAE)."""
        labels = torch.as_tensor(class_labels, device=self.device).long()
        b = labels.shape[0]
        cfg = self.dit.config
        shape = (b, cfg.in_channels, cfg.input_size, cfg.input_size)
        null_mask = torch.cat([torch.zeros(b, dtype=torch.bool),
                               torch.ones(b, dtype=torch.bool)]) \
            .to(self.device)
        latents = self._sample(shape, num_inference_steps, guidance_scale,
                               generator,
                               (torch.cat([labels, labels]), null_mask))
        return self._decode(latents)


class StableDiffusion3Pipeline(_PipelineBase):
    """SD3 text-to-image: MMDiT + flow matching + VAE, from precomputed
    (context, pooled) text embeddings (the text encoders are outside the
    pipeline, as in the JAX one)."""

    def __init__(self, mmdit, vae=None,
                 scheduler: Optional[FlowMatchScheduler] = None):
        super().__init__(mmdit, vae)
        self.mmdit = mmdit
        self.scheduler = scheduler or FlowMatchScheduler(shift=3.0)

    def _guided(self, x, t, scale, ctx2, pool2):
        b = x.shape[0]
        v = self.mmdit(torch.cat([x, x]), torch.cat([t, t]), ctx2, pool2)
        return _guide(v[:b], v[b:], scale)

    @torch.no_grad()
    def __call__(self, context, pooled, neg_context=None, neg_pooled=None,
                 num_inference_steps: int = 28, guidance_scale: float = 7.0,
                 generator: Optional[torch.Generator] = None):
        if neg_context is None:
            neg_context = torch.zeros_like(context)
        if neg_pooled is None:
            neg_pooled = torch.zeros_like(pooled)
        cfg = self.mmdit.config
        shape = (context.shape[0], cfg.in_channels, cfg.input_size,
                 cfg.input_size)
        latents = self._sample(shape, num_inference_steps, guidance_scale,
                               generator,
                               (torch.cat([context, neg_context]),
                                torch.cat([pooled, neg_pooled])))
        return self._decode(latents)
