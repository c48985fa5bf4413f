"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on Hopper.

It imports torch and numpy only, never jax or anything of ``paddle_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise when asked for the card and there is none.

This slice serves Llama through ``Predictor.generate``: the Llama forward
over a static KV cache, ``generate()``, and two hand-written kernels for
``sm_90a`` (flash-attention forward and decode attention, under
``ops/kernels`` with their sources in ``csrc``).
"""
from .convert import load_jax_state_dict
from .device import resolve_device
from .generation import GenerationConfig, generate
from .inference import Config, Predictor
from .models import LlamaConfig, LlamaForCausalLM, llama3_8b, llama_tiny
from .utils.rng import make_generator

__all__ = ["load_jax_state_dict", "resolve_device", "GenerationConfig",
           "generate", "Config", "Predictor", "LlamaConfig",
           "LlamaForCausalLM", "llama3_8b", "llama_tiny", "make_generator"]
