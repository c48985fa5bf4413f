"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on Hopper.

It imports torch and numpy only, never jax or anything of ``paddle_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise when asked for the card and there is none.

It serves Llama two ways. ``Predictor.generate`` runs the forward over a
static KV cache (``generate()``). ``PagedEngine``
(``generation/paged.py``) and ``Predictor.serve_stream`` run a
continuous-batching engine over a paged KV cache, on the per-tick host
path. ``Trainer`` (``trainer.py``) trains it on one card with the
optimizers of ``optimizer/``, through flash attention and its backward.
Five hand-written kernels for ``sm_90a`` sit under ``ops/kernels``, with
their sources in ``csrc``: flash-attention forward, the flash backward's
dq and dk/dv, decode attention and ragged paged attention.
"""
from .convert import load_jax_state_dict
from .device import resolve_device
from .generation import GenerationConfig, generate
from .inference import Config, Predictor
from . import optimizer
from .models import (LlamaConfig, LlamaForCausalLM, causal_lm_loss,
                     llama3_8b, llama_tiny)
from .trainer import Trainer, TrainerCallback, TrainingArguments
from .utils.rng import make_generator

__all__ = ["load_jax_state_dict", "resolve_device", "GenerationConfig",
           "generate", "Config", "Predictor", "LlamaConfig",
           "LlamaForCausalLM", "causal_lm_loss", "llama3_8b", "llama_tiny",
           "make_generator", "optimizer", "Trainer", "TrainerCallback",
           "TrainingArguments"]
