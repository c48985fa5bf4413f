from .base import CausalLMBase
from .llama import (LlamaConfig, LlamaForCausalLM, causal_lm_loss, llama3_8b,
                    llama_tiny)

__all__ = ["CausalLMBase", "LlamaConfig", "LlamaForCausalLM",
           "causal_lm_loss", "llama3_8b", "llama_tiny"]
