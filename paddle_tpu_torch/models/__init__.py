from .base import CausalLMBase
from .hf_interop import (config_from_hf, convert_hf_state_dict,
                         from_pretrained, load_hf_checkpoint,
                         to_hf_state_dict)
from .llama import (LlamaConfig, LlamaForCausalLM, causal_lm_loss, llama3_8b,
                    llama_tiny)

__all__ = ["CausalLMBase", "LlamaConfig", "LlamaForCausalLM",
           "causal_lm_loss", "llama3_8b", "llama_tiny", "from_pretrained",
           "config_from_hf", "convert_hf_state_dict", "to_hf_state_dict",
           "load_hf_checkpoint"]
