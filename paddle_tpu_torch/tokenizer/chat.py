"""Chat templates (counterpart of ``paddle_tpu/tokenizer/chat.py``;
reference: PaddleNLP tokenizer ``apply_chat_template`` /
``chat_template.json``: rendering a messages list into the model's
conversation format before tokenization).

The reference renders Jinja templates; the three formats that cover the
model zoo (Llama-3, Qwen2/ChatML, ERNIE) are written out directly: a
template is a plain function str(messages) -> str, so the SFT data
pipeline needs no template engine.
"""
from __future__ import annotations

from typing import Callable, Dict, List

__all__ = ["CHAT_TEMPLATES", "render_chat_template", "apply_chat_template"]

Message = Dict[str, str]  # {"role": "system|user|assistant", "content": ...}


def _llama3(messages: List[Message], add_generation_prompt: bool) -> str:
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                   f"{m['content']}<|eot_id|>")
    if add_generation_prompt:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _chatml(messages: List[Message], add_generation_prompt: bool) -> str:
    """ChatML — Qwen2's format."""
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
           for m in messages]
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _ernie(messages: List[Message], add_generation_prompt: bool) -> str:
    out = []
    for m in messages:
        tag = {"system": "<|system|>", "user": "<|user|>",
               "assistant": "<|assistant|>"}.get(m["role"], "<|user|>")
        out.append(f"{tag}\n{m['content']}\n")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


CHAT_TEMPLATES: Dict[str, Callable] = {
    "llama3": _llama3,
    "chatml": _chatml,
    "qwen2": _chatml,
    "ernie": _ernie,
}


def render_chat_template(messages: List[Message], template: str = "llama3",
                         add_generation_prompt: bool = True) -> str:
    try:
        fn = CHAT_TEMPLATES[template]
    except KeyError:
        raise KeyError(f"unknown chat template {template!r}; have "
                       f"{sorted(CHAT_TEMPLATES)}") from None
    for m in messages:
        if "role" not in m or "content" not in m:
            raise ValueError(f"message missing role/content: {m}")
    return fn(list(messages), add_generation_prompt)


def apply_chat_template(tokenizer, messages: List[Message],
                        template: str = "llama3",
                        add_generation_prompt: bool = True,
                        tokenize: bool = True):
    """Render then (optionally) tokenize — the reference's tokenizer
    method, as a free function over any tokenizer with ``encode``."""
    text = render_chat_template(messages, template, add_generation_prompt)
    return tokenizer.encode(text) if tokenize else text
