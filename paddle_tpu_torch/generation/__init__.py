"""Autoregressive generation over a static KV cache (counterpart of
``paddle_tpu/generation/__init__.py``: ``GenerationConfig``,
``generate``, ``_logits_processors``, ``_build_generate_fn``).

The JAX package compiles prefill plus a ``while_loop`` decode into one
program per shape bucket. Here the prefill is one forward and the decode
loop is a plain Python loop of single-token forwards; the KV cache is
written in place. Beam search comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .sampling import repetition_penalty, sample_token, suffix_window_hits

__all__ = ["GenerationConfig", "generate"]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    num_beams: int = 1      # > 1 (beam search) comes with a later slice
    # penalize tokens already in the running sequence (prompt +
    # generated): divide positive logits, multiply negative ones. 1.0 = off
    repetition_penalty: float = 1.0
    # suppress eos until this many tokens have been generated
    min_new_tokens: int = 0
    # ban any token that would complete an n-gram already present in the
    # running sequence. 0 = off
    no_repeat_ngram_size: int = 0


@torch.inference_mode()
def generate(model, input_ids, config: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None, prompt_start=None,
             **kwargs):
    """Greedy or sampled decoding. ``model`` has ``init_kv_caches`` and
    ``forward(ids, kv_caches=, cache_index=)`` (the CausalLM contract).

    ``generator`` draws the samples (a seed-0 generator on the model's
    device when not given). ``prompt_start`` is an optional [b] index of
    each row's first real token in a left-padded batch: pad prefixes are
    masked out of attention and RoPE positions start at each row's real
    start.

    Returns [b, prompt_len + max_new_tokens] token ids (pad_token_id after
    eos)."""
    cfg = config or GenerationConfig(**kwargs)
    if config is not None and kwargs:
        cfg = dataclasses.replace(cfg, **kwargs)
    if cfg.no_repeat_ngram_size < 0:
        raise ValueError("no_repeat_ngram_size must be >= 0")
    if cfg.repetition_penalty <= 0:
        raise ValueError("repetition_penalty must be > 0")
    if cfg.num_beams > 1:
        raise NotImplementedError(
            "beam search comes with a later slice of the port")
    device = model.device
    input_ids = torch.as_tensor(input_ids, device=device)
    b, prompt_len = input_ids.shape
    start = None
    if prompt_start is not None:
        start = torch.as_tensor(prompt_start, device=device).long()
    if cfg.do_sample and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    run = _build_generate_fn(model, cfg, b, prompt_len, start is not None)
    return run(input_ids, generator, cfg.temperature, start)


def _logits_processors(cfg, vocab):
    """One implementation of the decode-time logits processors (repetition
    penalty, no-repeat-ngram bans, min-new-tokens eos suppression).
    Returns ``process(raw, seen, n_generated, tokens, cur, row_starts)``
    on [N, V] fp32 logits."""
    eos = cfg.eos_token_id
    use_rep = cfg.repetition_penalty != 1.0
    ngram = int(cfg.no_repeat_ngram_size)

    def banned_ngram(tokens, cur, row_starts):
        """[N, V] mask of tokens that would complete an ``ngram``-gram
        already present in each row's sequence."""
        g = ngram - 1
        L = tokens.shape[1]
        starts = torch.arange(L, device=tokens.device)
        hit = suffix_window_hits(tokens, cur, g)              # [N, L]
        if row_starts is not None:      # left-pad prefix is not content
            hit = hit & (starts[None, :] >= row_starts[:, None])
        follow = tokens[:, (starts + g).clamp(0, L - 1)]      # [N, L]
        ban = torch.zeros(tokens.shape[0], vocab, dtype=torch.int32,
                          device=tokens.device)
        ban.scatter_reduce_(1, follow.long(), hit.int(), reduce="amax")
        return ban > 0

    def process(raw, seen, n_generated, tokens=None, cur=None,
                row_starts=None):
        if use_rep:
            raw = repetition_penalty(raw, seen, cfg.repetition_penalty)
        if ngram:
            raw = raw.masked_fill(banned_ngram(tokens, cur, row_starts),
                                  -1e30)
        if eos is not None and cfg.min_new_tokens > 0 \
                and n_generated < cfg.min_new_tokens:
            raw = raw.clone()
            raw[:, eos] = -1e30
        return raw

    return process


def _build_generate_fn(model, cfg, b, prompt_len, has_start):
    """The prefill + decode loop for one (batch, prompt length, config):
    ``run(input_ids, generator, temperature, start)``."""
    total = prompt_len + cfg.max_new_tokens
    eos = cfg.eos_token_id
    use_rep = cfg.repetition_penalty != 1.0
    ngram = int(cfg.no_repeat_ngram_size)
    vocab = model.config.vocab_size if (use_rep or ngram) else None
    needs_process = use_rep or ngram or (eos is not None
                                         and cfg.min_new_tokens > 0)
    _process = _logits_processors(cfg, vocab) if needs_process else None

    def adjust(row_logits, seen, n_generated, tokens, cur, row_starts):
        if _process is None:
            return row_logits
        return _process(row_logits, seen, n_generated, tokens=tokens,
                        cur=cur, row_starts=row_starts)

    def sample(row, generator, temperature):
        return sample_token(row, generator, temperature=temperature,
                            top_k=cfg.top_k, top_p=cfg.top_p,
                            do_sample=cfg.do_sample)

    def run(input_ids, generator, temperature, start):
        device = input_ids.device
        caches = model.init_kv_caches(b, total)
        logits, caches = model(input_ids, kv_caches=caches, cache_index=0,
                               attn_start=start)
        tokens = torch.cat(
            [input_ids, torch.full((b, cfg.max_new_tokens), cfg.pad_token_id,
                                   dtype=input_ids.dtype, device=device)],
            dim=1)
        rows = torch.arange(b, device=device)
        seen = None
        if use_rep:
            # membership mask; left-pad prefixes are not part of the
            # real sequence
            valid = torch.ones(b, prompt_len, dtype=torch.int32,
                               device=device)
            if has_start:
                valid = (torch.arange(prompt_len, device=device)[None, :]
                         >= start[:, None]).int()
            seen = torch.zeros(b, vocab, dtype=torch.int32, device=device)
            seen.scatter_reduce_(1, input_ids.long(), valid, reduce="amax")
            seen = seen > 0
        row0 = adjust(logits[:, -1], seen, 0, tokens, prompt_len, start)
        next_tok = sample(row0, generator, temperature)
        tokens[:, prompt_len] = next_tok.to(tokens.dtype)
        if use_rep:
            seen[rows, next_tok] = True
        done = (torch.zeros(b, dtype=torch.bool, device=device)
                if eos is None else next_tok == eos)
        pad = torch.tensor(cfg.pad_token_id, dtype=next_tok.dtype,
                           device=device)
        for cur in range(prompt_len + 1, total):
            if eos is not None and bool(done.all()):
                break
            ids = tokens[:, cur - 1:cur]
            logits, caches = model(ids, kv_caches=caches,
                                   cache_index=cur - 1, attn_start=start)
            row = adjust(logits[:, 0], seen, cur - prompt_len, tokens, cur,
                         start)
            nxt = torch.where(done, pad, sample(row, generator, temperature))
            if use_rep:   # finished rows emit pad: don't count it
                seen[rows, nxt] |= ~done
            tokens[:, cur] = nxt.to(tokens.dtype)
            if eos is not None:
                done = done | (nxt == eos)
        return tokens

    return run
