from .base import CausalLMBase
from .llama import LlamaConfig, LlamaForCausalLM, llama3_8b, llama_tiny

__all__ = ["CausalLMBase", "LlamaConfig", "LlamaForCausalLM", "llama3_8b",
           "llama_tiny"]
