"""Text-generation pipeline: tokenizer -> model -> decode in one call
(the port's copy of ``paddle_tpu/generation/pipeline.py``; reference:
PaddleNLP ``paddlenlp.Taskflow("text_generation")`` / transformers-style
``pipeline``: the user-facing serving recipe).

Prompts left-pad to a shared length inside a fixed bucket ladder, so
batched generation reuses one captured program a bucket (the
executable cache of ``generate()`` keys on the shape); positions and the
KV cache index account for the padding so RoPE stays aligned per row.
A left-padded batch takes the dense cache attention, as in the JAX
package (``models/llama.py``): the pipeline launches no attention kernel.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import GenerationConfig

__all__ = ["TextGenerationPipeline"]

_SEQ_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


class TextGenerationPipeline:
    """``pipe("prompt")`` -> generated text.

    Batched prompts of different lengths are right-aligned (left-padded)
    to one bucketed length; generation then starts at the same cache
    index for every row. Right-padding would be wrong (the model would
    continue from pad tokens); left-pad plus per-row position offsets is
    the standard decoder-serving layout (PaddleNLP's llm predictor does
    the same).
    """

    def __init__(self, model, tokenizer,
                 config: Optional[GenerationConfig] = None,
                 seq_buckets: Sequence[int] = _SEQ_BUCKETS):
        self.model = model
        self.tokenizer = tokenizer
        self.config = config or GenerationConfig()
        self.seq_buckets = tuple(sorted(seq_buckets))
        pad = getattr(tokenizer, "pad_token_id", None)
        self.pad_id = pad if pad is not None else self.config.pad_token_id

    def _bucket(self, n: int) -> int:
        for cap in self.seq_buckets:
            if n <= cap:
                return cap
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.seq_buckets[-1]}")

    def __call__(self, prompts: Union[str, List[str]], **gen_kwargs):
        single = isinstance(prompts, str)
        if single:
            prompts = [prompts]
        encoded = [self.tokenizer.encode(p) for p in prompts]
        longest = max(len(e) for e in encoded)
        width = self._bucket(longest)
        ids = np.full((len(encoded), width), self.pad_id, np.int64)
        offsets = []
        for i, e in enumerate(encoded):
            ids[i, width - len(e):] = e      # left-pad: rows right-aligned
            offsets.append(width - len(e))
        offsets = np.asarray(offsets, np.int64)

        out = self.model.generate(
            torch.from_numpy(ids), prompt_start=torch.from_numpy(offsets),
            config=self.config, **gen_kwargs)
        out = out.cpu().numpy()

        texts = []
        for i, e in enumerate(encoded):
            new_tokens = out[i, width:]
            if self.config.eos_token_id is not None:
                eos = np.nonzero(new_tokens == self.config.eos_token_id)[0]
                if eos.size:
                    new_tokens = new_tokens[:eos[0]]
            texts.append(self.tokenizer.decode(
                [int(t) for t in new_tokens], skip_special_tokens=True)
                if hasattr(self.tokenizer, "decode")
                else list(map(int, new_tokens)))
        return texts[0] if single else texts
