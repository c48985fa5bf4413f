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
from .resnet import (ResNet, ResNetConfig, resnet18, resnet34, resnet50,
                     resnet50_vd, resnet_tiny)
from .vit import (ViTConfig, ViTForImageClassification, ViTModel,
                  vit_base_patch16_224, vit_large_patch14_224, vit_tiny)
from .clip import (CLIPConfig, CLIPModel, CLIPTextConfig, CLIPTextModel,
                   clip_contrastive_loss, clip_tiny, gather_features)
from .dit import (DiT, DiTConfig, MMDiT, MMDiTConfig, dit_tiny, dit_xl_2,
                  mmdit_tiny)
from .vae import AutoencoderKL, VAEConfig, vae_loss, vae_tiny
from .ppocr import (DBNet, DBNetConfig, SVTRConfig, SVTRNet,
                    ctc_greedy_decode, ctc_rec_loss, db_loss, dbnet_tiny,
                    svtr_tiny)

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
           "ErnieForSequenceClassification", "ErnieModel", "ernie_tiny",
           "ResNet", "ResNetConfig", "resnet18", "resnet34", "resnet50",
           "resnet50_vd", "resnet_tiny", "ViTConfig",
           "ViTForImageClassification", "ViTModel", "vit_base_patch16_224",
           "vit_large_patch14_224", "vit_tiny", "CLIPConfig", "CLIPModel",
           "CLIPTextConfig", "CLIPTextModel", "clip_contrastive_loss",
           "clip_tiny", "gather_features", "DiT", "DiTConfig", "MMDiT",
           "MMDiTConfig", "dit_tiny", "dit_xl_2", "mmdit_tiny",
           "AutoencoderKL", "VAEConfig", "vae_loss", "vae_tiny", "DBNet",
           "DBNetConfig", "SVTRConfig", "SVTRNet", "ctc_greedy_decode",
           "ctc_rec_loss", "db_loss", "dbnet_tiny", "svtr_tiny"]
