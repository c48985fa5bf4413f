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
backward. Fine-tuning rides the same Trainer: LoRA adapters
(``peft``), packed SFT and DPO (``trl``, its data rendered with
``tokenizer``'s chat templates), QAT and PTQ into W8A8 (``quant``).
``models`` also
serves Qwen2, the MoE families (Qwen2-MoE, ERNIE-4.5-MoE and
DeepSeek-V2/V3 with MLA and MTP, on ``parallel/moe.py``) through the
same ``generate()``, ``Predictor`` and, for Qwen2-MoE and ERNIE,
``PagedEngine``; GPT through ``generate()``, the ``Predictor`` and the
``Trainer``; the BERT-family encoders (BERT, ERNIE) and Paddle's
``nn.Transformer`` layers through the ``Trainer``; the vision and
diffusion families: ViT, CLIP, ResNet and PP-OCR (DBNet, SVTR) through
the ``Trainer``, DiT and SD3's MMDiT with the SD VAE through
``diffusion``'s pipelines (one captured CUDA graph a denoising step), on
``nn``'s convolutions, pools and Batch/Group/Instance norms. Weights load
from ``checkpoint.save`` files in the JAX package's format and from HF
safetensors checkpoints (``models.from_pretrained``). Eight hand-written
kernels for ``sm_90a`` sit under ``ops/kernels``, with their sources in
``csrc``: flash-attention forward, the flash backward's dq and dk/dv,
decode attention, ragged and grid paged attention, the weight-only
quantized matmul, and the fused Adam / AdamW update.

Paddle's layer API sits on top: ``nn`` (every layer a ``nn.Layer``, a
``torch.nn.Module`` with Paddle's methods, and ``nn.functional``),
``incubate.nn.functional`` (the fused ops PaddleNLP imports; its causal
attention runs the flash kernels), ``vision.transforms`` and
``vision.datasets``, ``Model`` / ``summary`` and the ambient random
stream: ``seed(s)`` makes every layer built without a generator draw
the same weights again.
"""
import torch

from .convert import load_jax_state_dict
from .device import resolve_device
from .checkpoint import load, save
from .generation import GenerationConfig, beam_search, generate
from .inference import (BatchingPredictor, Config, Predictor,
                        create_predictor)
from . import amp, diffusion, io, optimizer, peft, quant, tokenizer, trl
from .models import (BertConfig, BertForPretraining,
                     BertForSequenceClassification, ErnieConfig,
                     ErnieForMaskedLM, ErnieForSequenceClassification,
                     GPTConfig, GPTForCausalLM, LlamaConfig,
                     LlamaForCausalLM, causal_lm_loss, from_pretrained,
                     llama3_70b, llama3_8b, llama_tiny)
from .trainer import Trainer, TrainerCallback, TrainingArguments
from . import metric
from .hapi import Model, summary
from .utils.rng import get_rng_state, make_generator, seed, set_rng_state
from . import callbacks, incubate, nn, vision
from . import dtypes
from .dtypes import (bfloat16, bool_, complex64, float16, float32, float64,
                     int8, int16, int32, int64, uint8)
from .tensor import *  # noqa: F401,F403 (Paddle's flat namespace)
from .tensor import Tensor
from .tensor import __all__ as _tensor_names
from ._func import grad, jvp, stop_gradient, value_and_grad, vjp, vmap
from . import autograd
from .autograd import no_grad
from . import (audio, distribution, fft, linalg, serving, signal,  # noqa: E402
               sparse)


def device_count() -> int:
    return torch.cuda.device_count()


def get_device() -> str:
    """Paddle's device string of the current card ("gpu:0"), or "cpu"
    where there is none."""
    if not torch.cuda.is_available():
        return "cpu"
    return f"gpu:{torch.cuda.current_device()}"


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def set_default_dtype(dtype):
    """Returns ``dtype`` as a torch dtype and changes nothing, as the JAX
    package's does: float32 stays the default."""
    return dtypes.to_dtype(dtype)


def get_default_dtype():
    return float32

__all__ = ["load_jax_state_dict", "resolve_device", "GenerationConfig",
           "generate", "beam_search", "Config", "Predictor",
           "BatchingPredictor", "create_predictor", "save", "load",
           "from_pretrained", "LlamaConfig",
           "LlamaForCausalLM", "causal_lm_loss", "llama3_8b", "llama3_70b",
           "llama_tiny", "GPTConfig", "GPTForCausalLM", "BertConfig",
           "BertForPretraining", "BertForSequenceClassification",
           "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "make_generator", "amp", "diffusion", "io",
           "optimizer", "peft", "quant", "tokenizer", "trl", "Trainer", "TrainerCallback",
           "TrainingArguments", "metric", "Model", "summary", "seed",
           "get_rng_state", "set_rng_state", "no_grad", "device_count",
           "get_device", "is_compiled_with_cuda", "callbacks", "incubate",
           "nn", "vision", "dtypes", "bfloat16", "bool_", "complex64",
           "float16", "float32", "float64", "int8", "int16", "int32",
           "int64", "uint8", "Tensor", "grad", "value_and_grad", "vjp",
           "jvp", "vmap", "stop_gradient", "autograd", "audio",
           "distribution", "fft", "linalg", "serving", "signal", "sparse",
           "set_default_dtype", "get_default_dtype"] + _tensor_names
