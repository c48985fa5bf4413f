"""Autoregressive generation over a static KV cache (counterpart of
``paddle_tpu/generation/__init__.py``: ``GenerationConfig``,
``generate``, ``_logits_processors``, ``_build_generate_fn``,
``beam_search``).

The JAX package compiles prefill plus a ``while_loop`` decode into one
program per shape bucket. Here the prefill is one eager forward and the
decode step is one program over fixed device buffers (the KV caches,
``tokens``, ``seen``, ``done``, the key rows and the cursor ``cur``),
written in place: on a card it is captured into a CUDA graph on its
first use and replayed once per token (``graphs.CapturedStep``); on the
CPU the same function runs eagerly. The step reads its cache index from
``cur`` on the device, so nothing of it goes to the host. The buffers
and the graph are kept per model (``graphs.ExecCache``), keyed on the
batch, ``total`` and the processor set, as the JAX package keeps its
compiled programs.

Sampling draws with (seed, counter) key rows (``sample_token_rows``): a
row's seed comes from ``generator``, and every emitted token advances
its counter, so the graphed and the uncaptured step draw the same bits.
With an eos, the loop reads ``done.all()`` from a pinned buffer every
``graphs.EOS_CHECK_EVERY`` steps, one check behind; the steps it runs past the
last eos emit pad, as the JAX loop's tokens are.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .graphs import (RESIDENT_BYTES, DecodeProgram, buffer_bytes,
                     eager_steps, exec_cache_for)
from .sampling import (repetition_penalty, row_keys, sample_token_rows,
                       suffix_window_hits_rows)

__all__ = ["GenerationConfig", "generate", "beam_search", "eager_steps",
           "RESIDENT_BYTES"]

@dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    num_beams: int = 1
    # beam search's final ranking: sum-logprob / generated_len**penalty
    length_penalty: float = 1.0
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
    """Greedy, sampled or beam decoding. ``model`` has ``init_kv_caches``
    and ``forward(ids, kv_caches=, cache_index=)`` (the CausalLM
    contract).

    ``generator`` draws each row's sampling seed (a seed-0 generator on
    the model's device when not given). ``prompt_start`` is an optional
    [b] index of each row's first real token in a left-padded batch: pad
    prefixes are masked out of attention and RoPE positions start at
    each row's real start (beam search rejects it, as the JAX package
    does).

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
        if prompt_start is not None:
            raise NotImplementedError(
                "beam search does not support left-padded prompt_start "
                "batches; pass right-aligned prompts (per row) instead")
        return beam_search(model, input_ids, cfg)
    device = model.device
    input_ids = torch.as_tensor(input_ids, device=device)
    b, prompt_len = input_ids.shape
    start = None
    if prompt_start is not None:
        start = torch.as_tensor(prompt_start, device=device).long()
    keys = None
    if cfg.do_sample:
        keys = row_keys(generator, b, device)
    total = prompt_len + cfg.max_new_tokens
    key = ("generate", b, total, cfg.do_sample, cfg.eos_token_id,
           cfg.pad_token_id, cfg.repetition_penalty, cfg.min_new_tokens,
           cfg.no_repeat_ngram_size, start is not None)
    prog = exec_cache_for(model, RESIDENT_BYTES).get(
        key, lambda: _GenerateProgram(model, cfg, b, total,
                                      start is not None))
    return prog.run(input_ids, cfg, keys, start)


def _logits_processors(cfg, vocab):
    """One implementation of the decode-time logits processors (repetition
    penalty, no-repeat-ngram bans, min-new-tokens eos suppression),
    shared by ``generate`` and beam search. Returns
    ``process(raw, seen, n_generated, tokens, cur, row_starts)`` on
    [N, V] fp32 logits; ``cur`` and ``n_generated`` may be device
    tensors, and nothing is read on the host."""
    eos = cfg.eos_token_id
    use_rep = cfg.repetition_penalty != 1.0
    ngram = int(cfg.no_repeat_ngram_size)

    def banned_ngram(tokens, cur, row_starts):
        """[N, V] mask of tokens that would complete an ``ngram``-gram
        already present in each row's sequence."""
        g = ngram - 1
        N, L = tokens.shape
        starts = torch.arange(L, device=tokens.device)
        cur_rows = torch.as_tensor(cur, device=tokens.device).reshape(
            -1).expand(N)
        hit = suffix_window_hits_rows(tokens, cur_rows, g)    # [N, L]
        if row_starts is not None:      # left-pad prefix is not content
            hit = hit & (starts[None, :] >= row_starts[:, None])
        follow = tokens[:, (starts + g).clamp(0, L - 1)]      # [N, L]
        ban = torch.zeros(N, vocab, dtype=torch.int32, device=tokens.device)
        ban.scatter_reduce_(1, follow.long(), hit.int(), reduce="amax")
        return ban > 0

    def process(raw, seen, n_generated, tokens=None, cur=None,
                row_starts=None):
        if use_rep:
            raw = repetition_penalty(raw, seen, cfg.repetition_penalty)
        if ngram:
            raw = raw.masked_fill(banned_ngram(tokens, cur, row_starts),
                                  -1e30)
        if eos is not None and cfg.min_new_tokens > 0:
            is_eos = torch.arange(raw.shape[-1], device=raw.device) == eos
            raw = torch.where(
                is_eos[None, :] & (n_generated < cfg.min_new_tokens),
                torch.full_like(raw, -1e30), raw)
        return raw

    return process


class _GenerateProgram(DecodeProgram):
    """The fixed buffers of one (batch, total, processor set) and its
    decode step: the counterpart of the JAX package's jitted
    ``run(params, input_ids, key, temperature, *start)``."""

    def __init__(self, model, cfg, b, total, has_start):
        super().__init__(model.device)
        self.model = model
        dev = self.device
        self.cfg = cfg
        self.b, self.total = b, total
        self.use_rep = cfg.repetition_penalty != 1.0
        ngram = int(cfg.no_repeat_ngram_size)
        vocab = model.config.vocab_size if (self.use_rep or ngram) else None
        needs = self.use_rep or ngram or (cfg.eos_token_id is not None
                                          and cfg.min_new_tokens > 0)
        self.process = _logits_processors(cfg, vocab) if needs else None
        self.caches = model.init_kv_caches(b, total)
        self.tokens = torch.zeros(b, total, dtype=torch.int64, device=dev)
        self.rows = torch.arange(b, device=dev)
        self.cur = torch.zeros((), dtype=torch.int32, device=dev)
        self.prompt_len = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.all_done = torch.zeros((), dtype=torch.bool, device=dev)
        self.seen = (torch.zeros(b, model.config.vocab_size,
                                 dtype=torch.bool, device=dev)
                     if self.use_rep else None)
        self.start = (torch.zeros(b, dtype=torch.int64, device=dev)
                      if has_start else None)
        self.keys = self.temperature = self.top_k = self.top_p = None
        if cfg.do_sample:
            self.keys = torch.zeros(b, 2, dtype=torch.int64, device=dev)
            self.temperature = torch.zeros(b, dtype=torch.float32,
                                           device=dev)
            self.top_k = torch.zeros(b, dtype=torch.int32, device=dev)
            self.top_p = torch.zeros(b, dtype=torch.float32, device=dev)
        self.nbytes = buffer_bytes(self.caches, self.tokens, self.seen,
                                   self.keys)

    def _next(self, logits):
        """The token each row emits from its raw logits [b, V] at the
        cursor (processors, then argmax or a keyed sample)."""
        row = logits.float()
        if self.process is not None:
            row = self.process(row, self.seen, self.cur - self.prompt_len,
                               tokens=self.tokens, cur=self.cur,
                               row_starts=self.start)
        if self.keys is None:
            return torch.argmax(row, dim=-1)
        nxt, _, new_keys = sample_token_rows(row, self.keys,
                                             self.temperature, self.top_k,
                                             self.top_p)
        self.keys.copy_(new_keys)
        return nxt

    def _emit(self, nxt):
        """Write the cursor's token (pad for finished rows) and advance."""
        cfg = self.cfg
        nxt = torch.where(self.done, torch.full_like(nxt, cfg.pad_token_id),
                          nxt)
        if self.use_rep:   # finished rows emit pad: don't count it
            self.seen.index_put_((self.rows, nxt),
                                 self.seen[self.rows, nxt] | ~self.done)
        self.tokens.index_copy_(1, self.cur.long().reshape(1), nxt[:, None])
        if cfg.eos_token_id is not None:
            self.done |= nxt == cfg.eos_token_id
            self.all_done.copy_(self.done.all())
        self.cur += 1

    def _step(self):
        """One decode step at the device cursor: the forward of the token
        at ``cur - 1`` (writing its K/V there), then the token at
        ``cur``."""
        ci = self.cur - 1
        ids = self.tokens.index_select(1, ci.long().reshape(1))
        logits, _ = self.model(ids, kv_caches=self.caches, cache_index=ci,
                               attn_start=self.start)
        self._emit(self._next(logits[:, 0]))

    def _run(self, input_ids, cfg, keys, start):
        b, prompt_len = input_ids.shape
        if start is not None:
            self.start.copy_(start)
        logits, _ = self.model(input_ids, kv_caches=self.caches,
                               cache_index=0, attn_start=self.start)
        self.tokens[:, :prompt_len].copy_(input_ids)
        self.tokens[:, prompt_len:].fill_(cfg.pad_token_id)
        self.prompt_len.fill_(prompt_len)
        self.cur.fill_(prompt_len)
        self.done.zero_()
        if self.use_rep:
            # membership mask; left-pad prefixes are not part of the real
            # sequence
            valid = torch.ones(b, prompt_len, dtype=torch.bool,
                               device=self.device)
            if start is not None:
                valid = torch.arange(prompt_len, device=self.device)[
                    None, :] >= self.start[:, None]
            seen = torch.zeros(self.seen.shape, dtype=torch.int32,
                               device=self.device)
            seen.scatter_reduce_(1, input_ids.long(), valid.int(),
                                 reduce="amax")
            self.seen.copy_(seen > 0)
        if keys is not None:
            self.keys.copy_(keys)
            self.temperature.fill_(cfg.temperature)
            self.top_k.fill_(cfg.top_k)
            self.top_p.fill_(cfg.top_p)
        self._emit(self._next(logits[:, -1]))
        flag = self.all_done if cfg.eos_token_id is not None else None
        self.run_steps(self.total - prompt_len - 1, flag)
        return self.tokens.to(input_ids.dtype, copy=True)


@torch.inference_mode()
def beam_search(model, input_ids, config: GenerationConfig):
    """Beam search (counterpart of the JAX package's ``beam_search``:
    PaddleNLP's BeamSearchScorer). Beams live as an expanded batch
    [b * beams], so the decode kernel runs at b * beams rows; each step's
    caches, tokens and seen rows are gathered by beam index in place, so
    the buffers keep their addresses and the step is the same captured
    program as ``generate``'s. The logits processors run on each beam's
    raw logits before log_softmax, and the final beam is picked by
    ``score / length**length_penalty`` (HF convention; the length counts
    no eos)."""
    cfg = config
    device = model.device
    input_ids = torch.as_tensor(input_ids, device=device)
    b, prompt_len = input_ids.shape
    total = prompt_len + cfg.max_new_tokens
    key = ("beam", b, cfg.num_beams, total, cfg.eos_token_id,
           cfg.pad_token_id, cfg.repetition_penalty, cfg.min_new_tokens,
           cfg.no_repeat_ngram_size)
    prog = exec_cache_for(model, RESIDENT_BYTES).get(
        key, lambda: _BeamProgram(model, cfg, b, total))
    return prog.run(input_ids, cfg)


class _BeamProgram(DecodeProgram):
    """The fixed buffers of one beam search shape and its decode step."""

    def __init__(self, model, cfg, b, total):
        super().__init__(model.device)
        self.model = model
        dev = self.device
        k = cfg.num_beams
        self.cfg = cfg
        self.b, self.k, self.total = b, k, total
        self.vocab = vocab = model.config.vocab_size
        self.use_rep = cfg.repetition_penalty != 1.0
        self.process = _logits_processors(cfg, vocab)
        self.caches = model.init_kv_caches(b * k, total)
        self.tokens = torch.zeros(b * k, total, dtype=torch.int64,
                                  device=dev)
        self.rows = torch.arange(b * k, device=dev)
        self.base = torch.arange(b, device=dev)[:, None] * k
        self.cur = torch.zeros((), dtype=torch.int32, device=dev)
        self.prompt_len = torch.zeros((), dtype=torch.int32, device=dev)
        self.scores = torch.zeros(b, k, dtype=torch.float32, device=dev)
        self.done = torch.zeros(b, k, dtype=torch.bool, device=dev)
        self.n_gen = torch.zeros(b, k, dtype=torch.int32, device=dev)
        self.seen = (torch.zeros(b * k, vocab, dtype=torch.bool, device=dev)
                     if self.use_rep else None)
        self.pad_only = torch.full((vocab,), float("-inf"), device=dev)
        self.pad_only[cfg.pad_token_id] = 0.0
        self.nbytes = buffer_bytes(self.caches, self.tokens, self.seen)

    def _logp(self, logits):
        raw = self.process(logits.float(), self.seen,
                           self.cur - self.prompt_len, tokens=self.tokens,
                           cur=self.cur)
        return torch.log_softmax(raw, -1).reshape(self.b, self.k,
                                                  self.vocab)

    def _gather(self, beam_src):
        """Every beam takes the state of its source beam, in place."""
        flat = (beam_src + self.base).reshape(-1)
        self.tokens.copy_(self.tokens.index_select(0, flat))
        for cache in self.caches:       # (k, v), or MLA's (latents, k_pe)
            for t in cache:
                t.copy_(t.index_select(0, flat))
        if self.use_rep:
            self.seen.copy_(self.seen.index_select(0, flat))

    def _step(self):
        cfg, b, k, V = self.cfg, self.b, self.k, self.vocab
        ci = self.cur - 1
        ids = self.tokens.index_select(1, ci.long().reshape(1))
        logits, _ = self.model(ids, kv_caches=self.caches, cache_index=ci)
        logp = self._logp(logits[:, 0])
        # finished beams: freeze the score, only pad continues
        logp = torch.where(self.done[..., None], self.pad_only[None, None],
                           logp)
        cand = self.scores[..., None] + logp                 # [b, k, V]
        scores, idx = torch.topk(cand.reshape(b, -1), k)
        beam_src, next_tok = idx // V, idx % V
        self._gather(beam_src)
        done = self.done.gather(1, beam_src)
        n_gen = self.n_gen.gather(1, beam_src)
        # count live continuations only; the step a beam emits eos adds
        # nothing (HF's generated_len excludes that eos)
        live = ~done if cfg.eos_token_id is None \
            else ~done & (next_tok != cfg.eos_token_id)
        self.n_gen.copy_(n_gen + live.to(torch.int32))
        nxt = torch.where(done, torch.full_like(next_tok, cfg.pad_token_id),
                          next_tok)
        flat = nxt.reshape(-1)
        if self.use_rep:
            self.seen.index_put_((self.rows, flat),
                                 self.seen[self.rows, flat]
                                 | ~done.reshape(-1))
        self.tokens.index_copy_(1, self.cur.long().reshape(1), flat[:, None])
        if cfg.eos_token_id is not None:
            done = done | (nxt == cfg.eos_token_id)
        self.done.copy_(done)
        self.scores.copy_(scores)
        self.cur += 1

    def _run(self, input_ids, cfg):
        b, k, V = self.b, self.k, self.vocab
        prompt_len = input_ids.shape[1]
        ids = input_ids.repeat_interleave(k, dim=0)          # [b*k, L]
        logits, _ = self.model(ids, kv_caches=self.caches, cache_index=0)
        self.tokens[:, :prompt_len].copy_(ids)
        self.tokens[:, prompt_len:].fill_(cfg.pad_token_id)
        self.prompt_len.fill_(prompt_len)
        self.cur.fill_(prompt_len)
        if self.use_rep:
            self.seen.zero_()
            self.seen[self.rows[:, None], ids.long()] = True
        logp = self._logp(logits[:, -1])
        # first step: only beam 0 is live (identical beams would collapse)
        first = torch.where(torch.arange(k, device=self.device) == 0, 0.0,
                            float("-inf"))[None, :, None]
        scores, idx = torch.topk((logp + first).reshape(b, -1), k)
        beam_src, next_tok = idx // V, idx % V
        if self.use_rep:
            self.seen.copy_(self.seen.index_select(
                0, (beam_src + self.base).reshape(-1)))
            self.seen[self.rows, next_tok.reshape(-1)] = True
        self.tokens[:, prompt_len] = next_tok.reshape(-1)
        self.scores.copy_(scores)
        eos = cfg.eos_token_id
        if eos is None:
            self.done.zero_()
            self.n_gen.fill_(1)
        else:
            # generated length per beam excluding the terminating eos
            self.done.copy_(next_tok == eos)
            self.n_gen.copy_((~self.done).to(torch.int32))
        self.cur.fill_(prompt_len + 1)
        self.run_steps(self.total - prompt_len - 1)
        ranked = self.scores / (self.n_gen.clamp_min(1).float()
                                ** cfg.length_penalty)
        best = torch.argmax(ranked, dim=1)
        out = self.tokens.reshape(b, k, self.total)[
            torch.arange(b, device=self.device), best]
        return out.to(input_ids.dtype)


from .paged import PagedEngine, PagedKV  # noqa: E402
from .prompt_lookup import propose_ngram, propose_ngram_rows  # noqa: E402
from .speculative import (mtp_speculative_generate,  # noqa: E402
                          ngram_speculative_generate, speculative_generate)

__all__ += ["PagedEngine", "PagedKV", "propose_ngram", "propose_ngram_rows",
            "speculative_generate", "mtp_speculative_generate",
            "ngram_speculative_generate"]
