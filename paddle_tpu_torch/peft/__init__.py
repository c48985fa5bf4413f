"""Parameter-efficient fine-tuning (counterpart of ``paddle_tpu/peft``;
reference: PaddleNLP paddlenlp/peft)."""
from .lora import (LoRAConfig, LoRAModel, apply_lora, inject_lora,
                   lora_state_dict, mark_only_lora_as_trainable, merge_lora,
                   unmerge_lora)

__all__ = ["LoRAConfig", "LoRAModel", "apply_lora", "inject_lora",
           "lora_state_dict", "mark_only_lora_as_trainable", "merge_lora",
           "unmerge_lora"]
