"""Diffusion schedulers, the training loss, the sampling loop and the
pipelines (counterpart of ``paddle_tpu/diffusion``)."""
from .schedulers import (DDIMScheduler, DDPMScheduler, FlowMatchScheduler,
                         diffusion_loss, make_betas, sample_loop)
from .pipelines import DiTPipeline, StableDiffusion3Pipeline

__all__ = ["DDIMScheduler", "DDPMScheduler", "FlowMatchScheduler",
           "diffusion_loss", "make_betas", "sample_loop", "DiTPipeline",
           "StableDiffusion3Pipeline"]
