"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on Hopper.

It imports torch and numpy only, never jax or anything of ``paddle_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise when asked for the card and there is none.

It serves Llama two ways. ``Predictor.generate`` runs the forward over a
static KV cache (``generate()``: greedy, sampled and beam search, each
decode step one CUDA-graph replay; ``generation.speculative``: draft-model
and prompt-lookup speculative decoding; ``BatchingPredictor`` coalesces
concurrent requests). ``PagedEngine`` (``generation/paged.py``) and
``Predictor.serve_stream`` run a continuous-batching engine over a paged
KV cache, and ``serving/`` a gateway over it. ``Trainer``
(``trainer.py``) trains it on one card at the JAX package's defaults:
the optimizers of ``optimizer/`` (Adam and AdamW in one fused pass),
fp16 with ``amp.GradScaler``, the ``io/`` DataLoader, step checkpoints
with auto-resume (``checkpoint/distributed_ckpt.py``), the preemption
and hang exits and divergence rollback, through flash attention and its
backward. ``models`` also
serves Qwen2, the MoE families (Qwen2-MoE, ERNIE-4.5-MoE and
DeepSeek-V2/V3 with MLA and MTP, on ``parallel/moe.py``) through the
same ``generate()``, ``Predictor`` and, for Qwen2-MoE and ERNIE,
``PagedEngine``. Weights load
from ``checkpoint.save`` files in the JAX package's format and from HF
safetensors checkpoints (``models.from_pretrained``). Eight hand-written
kernels for ``sm_90a`` sit under ``ops/kernels``, with their sources in
``csrc``: flash-attention forward, the flash backward's dq and dk/dv,
decode attention, ragged and grid paged attention, the weight-only
quantized matmul, and the fused Adam / AdamW update.
"""
from .convert import load_jax_state_dict
from .device import resolve_device
from .checkpoint import load, save
from .generation import GenerationConfig, beam_search, generate
from .inference import (BatchingPredictor, Config, Predictor,
                        create_predictor)
from . import amp, io, optimizer
from .models import (LlamaConfig, LlamaForCausalLM, causal_lm_loss,
                     from_pretrained, llama3_8b, llama_tiny)
from .trainer import Trainer, TrainerCallback, TrainingArguments
from .utils.rng import make_generator

__all__ = ["load_jax_state_dict", "resolve_device", "GenerationConfig",
           "generate", "beam_search", "Config", "Predictor",
           "BatchingPredictor", "create_predictor", "save", "load",
           "from_pretrained", "LlamaConfig",
           "LlamaForCausalLM", "causal_lm_loss", "llama3_8b", "llama_tiny",
           "make_generator", "amp", "io", "optimizer", "Trainer",
           "TrainerCallback", "TrainingArguments"]
