"""Tokenization (counterpart of ``paddle_tpu/tokenizer``): the chat
templates SFT data is rendered with. The byte-level BPE tokenizer and the
trie tokenizer come with a later slice."""
from .chat import CHAT_TEMPLATES, apply_chat_template, render_chat_template

__all__ = ["CHAT_TEMPLATES", "apply_chat_template", "render_chat_template"]
