"""Diffusion noise schedulers (counterpart of
``paddle_tpu/diffusion/schedulers.py``: ``make_betas``, ``DDPMScheduler``,
``DDIMScheduler``, ``FlowMatchScheduler``, ``diffusion_loss``,
``sample_loop``).

The schedulers are frozen dataclasses whose fp32 tables (betas,
alphas-cumprod) are computed once; ``step`` is a function of (model
output, t, sample) on device tensors. A table is read on ``t``'s device
(a copy kept per device, made on first use), indexed there by ``t``, so
a step holds no host read and runs inside a captured CUDA graph (the
pipelines' denoising step).

Randomness: where the JAX functions take PRNG keys, these take a
``torch.Generator`` (``sample_loop``) or a drawn ``noise`` tensor
(``step``). The two give different numbers for one seed; the tests hold
the deterministic parts to the JAX functions and the draws to their
distributions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict

import torch


def linspace(start: float, stop: float, num: int):
    """``num`` points from ``start`` to ``stop`` in fp32, computed as
    ``jnp.linspace`` computes them: start * (1 - i / d) + stop * i / d,
    the last point ``stop`` itself. (``torch.linspace`` steps otherwise,
    and puts some points of the flow-matching grid on the other side of
    an integer, where the int32 cast then differs.)"""
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def make_betas(num_train_timesteps: int, schedule: str = "linear",
               beta_start: float = 1e-4, beta_end: float = 0.02):
    if schedule == "linear":
        return linspace(beta_start, beta_end, num_train_timesteps)
    if schedule == "scaled_linear":  # stable-diffusion parameterisation
        return linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps) ** 2
    if schedule == "squaredcos_cap_v2":  # improved-DDPM cosine
        t = torch.arange(num_train_timesteps + 1, dtype=torch.float32) \
            / num_train_timesteps
        f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return torch.clamp(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {schedule!r}")


def _bcast(v, ndim):
    """[b] -> [b, 1, ...] against a sample of rank ``ndim``."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


@dataclass(frozen=True)
class DDPMScheduler:
    """Ancestral sampling and the forward process q(x_t | x_0)."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    prediction_type: str = "epsilon"      # epsilon | v_prediction | sample
    clip_sample: bool = False
    betas: Any = None
    alphas_cumprod: Any = None
    _on_device: Dict[Any, Any] = field(default_factory=dict, repr=False,
                                       compare=False)

    # a step draws noise (DDPM always; DDIM when eta > 0)
    draws_noise = True

    def __post_init__(self):
        if self.betas is None:
            betas = make_betas(self.num_train_timesteps, self.beta_schedule,
                               self.beta_start, self.beta_end)
            object.__setattr__(self, "betas", betas)
            object.__setattr__(self, "alphas_cumprod",
                               torch.cumprod(1.0 - betas, dim=0))

    def _extract(self, t, ndim):
        """alphas-cumprod at ``t`` [b], as [b, 1, ...] fp32 on ``t``'s
        device."""
        key = t.device
        table = self._on_device.get(key)
        if table is None:
            table = self.alphas_cumprod.float().to(t.device)
            self._on_device[key] = table
        return _bcast(table[t.long()], ndim)

    # ---------------------------------------------------------- training
    def add_noise(self, x0, noise, t):
        ac = self._extract(t, x0.dim())
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * noise

    def velocity(self, x0, noise, t):
        """The v-prediction target: sqrt(ac) eps - sqrt(1 - ac) x0."""
        ac = self._extract(t, x0.dim())
        return torch.sqrt(ac) * noise - torch.sqrt(1.0 - ac) * x0

    def training_target(self, x0, noise, t):
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.velocity(x0, noise, t)
        return x0

    # ---------------------------------------------------------- sampling
    def timesteps(self, num_inference_steps: int):
        """The descending grid (int64, on the CPU): DDPM's step always
        moves t -> t - 1, so a subsampled grid is a coarse approximation
        (DDIM samples it properly)."""
        step = max(self.num_train_timesteps // num_inference_steps, 1)
        return (torch.arange(num_inference_steps) * step).flip(0)

    def _pred_x0(self, model_out, sample, t):
        ac = self._extract(t, sample.dim())
        if self.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(1.0 - ac) * model_out) / torch.sqrt(ac)
        elif self.prediction_type == "v_prediction":
            x0 = torch.sqrt(ac) * sample - torch.sqrt(1.0 - ac) * model_out
        else:
            x0 = model_out
        return torch.clamp(x0, -1.0, 1.0) if self.clip_sample else x0

    def step(self, model_out, t, sample, noise=None):
        """One reverse step x_t -> x_{t-1}: the posterior mean, plus its
        standard deviation times ``noise`` (a standard normal draw of
        ``sample``'s shape) where t > 0 when ``noise`` is given."""
        t_b = _bcast(t, sample.dim())
        nd = sample.dim()
        ac_t = self._extract(t, nd)
        ac_prev = torch.where(t_b > 0,
                              self._extract(torch.clamp(t - 1, min=0), nd),
                              1.0)
        beta_t = 1.0 - ac_t / ac_prev
        x0 = self._pred_x0(model_out, sample, t)
        coef_x0 = torch.sqrt(ac_prev) * beta_t / (1.0 - ac_t)
        coef_xt = torch.sqrt(ac_t / ac_prev) * (1.0 - ac_prev) / (1.0 - ac_t)
        mean = coef_x0 * x0 + coef_xt * sample
        if noise is not None:
            var = beta_t * (1.0 - ac_prev) / (1.0 - ac_t)
            nonzero = (t_b > 0).float()
            mean = mean + nonzero * torch.sqrt(torch.clamp(var, min=1e-20)) \
                * noise
        return mean.to(sample.dtype)


@dataclass(frozen=True)
class DDIMScheduler(DDPMScheduler):
    """Deterministic (eta 0) or stochastic DDIM steps over the subsampled
    grid."""

    eta: float = 0.0

    @property
    def draws_noise(self):
        return self.eta > 0

    def step(self, model_out, t, sample, prev_t=None, noise=None):
        """x_t -> x_{prev_t}; ``prev_t`` < 0 marks the final step (alpha-
        bar 1). With eta > 0 and ``noise`` given, sigma times ``noise`` is
        added."""
        if prev_t is None:
            prev_t = t - 1
        nd = sample.dim()
        ac_t = self._extract(t, nd)
        ac_prev = self._extract(torch.clamp(prev_t, min=0), nd)
        ac_prev = torch.where(_bcast(prev_t < 0, nd), 1.0, ac_prev)
        x0 = self._pred_x0(model_out, sample, t)
        eps = (sample - torch.sqrt(ac_t) * x0) / torch.sqrt(1.0 - ac_t)
        sigma = self.eta * torch.sqrt((1 - ac_prev) / (1 - ac_t)) \
            * torch.sqrt(1 - ac_t / ac_prev)
        dir_xt = torch.sqrt(torch.clamp(1.0 - ac_prev - sigma ** 2,
                                        min=0.0)) * eps
        prev = torch.sqrt(ac_prev) * x0 + dir_xt
        if noise is not None and self.eta > 0:
            prev = prev + sigma * noise
        return prev.to(sample.dtype)


@dataclass(frozen=True)
class FlowMatchScheduler:
    """Rectified flow (SD3): x_t = (1 - sigma) x0 + sigma eps, the model
    predicts the velocity eps - x0, Euler steps. ``shift`` is SD3's
    resolution-dependent timestep shift."""

    num_train_timesteps: int = 1000
    shift: float = 1.0

    draws_noise = False

    def sigmas_for(self, t):
        """t in [0, num_train_timesteps) -> the shifted sigma in (0, 1]
        (t = -1 gives exactly 0)."""
        s = (t.float() + 1.0) / self.num_train_timesteps
        return self.shift * s / (1.0 + (self.shift - 1.0) * s)

    def add_noise(self, x0, noise, t):
        sigma = _bcast(self.sigmas_for(t), x0.dim())
        return (1.0 - sigma) * x0 + sigma * noise

    def training_target(self, x0, noise, t):  # noqa: ARG002 (sig parity)
        return noise - x0

    def timesteps(self, num_inference_steps: int):
        """The descending grid, truncated to int32 as the JAX one is; the
        last step integrates to sigma 0."""
        return linspace(self.num_train_timesteps - 1, 0,
                        num_inference_steps).to(torch.int32)

    def step(self, model_out, t, sample, prev_t=None):
        nd = sample.dim()
        sigma = _bcast(self.sigmas_for(t), nd)
        sigma_prev = torch.zeros_like(sigma) if prev_t is None \
            else _bcast(self.sigmas_for(prev_t), nd)
        return (sample + (sigma_prev - sigma) * model_out.float()) \
            .to(sample.dtype)


def diffusion_loss(scheduler, model_fn, x0, t, noise, *cond):
    """The denoising MSE against the scheduler's training target; a
    learned-sigma output (twice the target's channels) drops its variance
    half."""
    noisy = scheduler.add_noise(x0, noise, t)
    pred = model_fn(noisy, t, *cond)
    target = scheduler.training_target(x0, noise, t)
    if pred.shape[1] == 2 * target.shape[1]:
        pred = pred[:, :target.shape[1]]
    return (pred.float() - target.float()).square().mean()


def scheduler_step(scheduler, out, tb, prev_tb, x, noise):
    """One step of ``sample_loop``'s body, by the scheduler's kind: flow
    matching to ``prev_tb`` (sigma(-1) = 0, so the last step lands on 0),
    DDIM to ``prev_tb`` with ``noise``, DDPM to t - 1 with ``noise``."""
    if isinstance(scheduler, FlowMatchScheduler):
        return scheduler.step(out, tb, x, prev_t=prev_tb)
    if isinstance(scheduler, DDIMScheduler):
        return scheduler.step(out, tb, x, prev_t=prev_tb, noise=noise)
    return scheduler.step(out, tb, x, noise=noise)


def sample_loop(scheduler, model_fn, shape, num_inference_steps: int,
                generator: torch.Generator, *cond, dtype=torch.float32,
                device=None):
    """The reverse process from x_T ~ N(0, 1) of ``shape`` over the
    scheduler's grid, eagerly. Draws from ``generator`` in this order:
    x_T, then, when a step draws noise (DDPM; DDIM with eta > 0), one
    [num_inference_steps, *shape] block of the steps' noise."""
    device = torch.device(device) if device is not None else generator.device
    x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    noise = torch.randn((num_inference_steps,) + tuple(shape),
                        generator=generator, dtype=torch.float32,
                        device=device) if scheduler.draws_noise else None
    ts = scheduler.timesteps(num_inference_steps).long().to(device)
    prev_ts = torch.cat([ts[1:], ts.new_full((1,), -1)])
    for i in range(num_inference_steps):
        tb = ts[i].expand(shape[0])
        out = model_fn(x, tb, *cond)
        x = scheduler_step(scheduler, out, tb, prev_ts[i].expand(shape[0]),
                           x, None if noise is None else noise[i])
    return x
