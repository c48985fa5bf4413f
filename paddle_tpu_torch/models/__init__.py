from .base import CausalLMBase
from .hf_interop import (config_from_hf, convert_hf_state_dict,
                         from_pretrained, load_hf_checkpoint,
                         to_hf_state_dict)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    causal_lm_loss, llama3_70b, llama3_8b,
                    llama_tiny)
from .ernie import (Ernie45MoeConfig, Ernie45MoeForCausalLM, ErnieConfig,
                    ErnieForMaskedLM, ErnieForSequenceClassification,
                    ErnieModel, ernie45_moe_tiny, ernie_tiny)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_tiny
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_tiny,
                   pretraining_loss)
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2Model, qwen2_7b,
                    qwen2_tiny)
from .deepseek_v2 import (DeepseekV2Config, DeepseekV2ForCausalLM,
                          DeepseekV2Model, deepseek_v2_tiny)
from .qwen2_moe import (DeepseekMoeConfig, DeepseekMoeForCausalLM,
                        Qwen2MoeConfig, Qwen2MoeForCausalLM, Qwen2MoeModel,
                        deepseek_moe_tiny, moe_lm_loss, qwen2_moe_tiny)

__all__ = ["CausalLMBase", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "causal_lm_loss", "llama3_8b", "llama3_70b", "llama_tiny",
           "from_pretrained",
           "config_from_hf", "convert_hf_state_dict", "to_hf_state_dict",
           "load_hf_checkpoint", "Ernie45MoeConfig", "Ernie45MoeForCausalLM",
           "ernie45_moe_tiny", "Qwen2Config", "Qwen2ForCausalLM",
           "Qwen2Model", "qwen2_7b", "qwen2_tiny", "DeepseekV2Config",
           "DeepseekV2ForCausalLM", "DeepseekV2Model", "deepseek_v2_tiny",
           "DeepseekMoeConfig", "DeepseekMoeForCausalLM", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "Qwen2MoeModel", "deepseek_moe_tiny",
           "moe_lm_loss", "qwen2_moe_tiny", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "gpt_tiny", "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_tiny",
           "pretraining_loss", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel", "ernie_tiny"]
