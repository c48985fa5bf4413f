"""Tokenization (counterpart of ``paddle_tpu/tokenizer``; reference:
PaddleNLP ``paddlenlp/transformers/*/tokenizer.py``).

- ``BPETokenizer``: merges-based byte-level BPE, loads HF tokenizer.json
  or GPT-2 vocab.json+merges.txt; its merge loop runs in the native
  runtime and its pretokenizer on stdlib ``re`` (no ``regex`` package).
- ``TrieTokenizer``: the native greedy longest-match trie (vocab-only
  models, fast data prep), re-exported from ``paddle_tpu_torch.native``.
- the chat templates SFT data is rendered with.
"""
from ..native import Tokenizer as TrieTokenizer
from .bpe import (GPT2_SPLIT, LLAMA3_SPLIT, BPETokenizer, bytes_to_unicode)
from .chat import (CHAT_TEMPLATES, apply_chat_template,
                   render_chat_template)

__all__ = ["BPETokenizer", "TrieTokenizer", "bytes_to_unicode",
           "GPT2_SPLIT", "LLAMA3_SPLIT", "CHAT_TEMPLATES",
           "apply_chat_template", "render_chat_template"]
