"""Speculative decoding (counterpart of
``paddle_tpu/generation/speculative.py``: ``speculative_generate``,
``mtp_speculative_generate``, ``ngram_speculative_generate``,
``_commit``, ``_mask_tail``, ``_spec_stats``; Leviathan et al. 2023,
prompt-lookup decoding, DeepSeek-V3's MTP self-drafting).

A draft (a small model, or the continuation of the most recent earlier
match of the last ``ngram`` tokens) proposes ``k`` tokens; the target
scores all of them in ONE forward over its static KV cache at s = k + 1
(the masked-cache path, as in the JAX package) and the longest matching
prefix is accepted, plus the target's own next token. Greedy
speculative decoding is exact: the output equals the target's own
greedy decode; the draft only changes how many target forwards it takes.

The JAX package vmaps a single-row ``while_loop`` over the rows, which
gives every row its own cursor and freezes finished rows. Here the rows
stay one batch with a cursor each (``n`` [b] on the device): the models
take a per-row device cache index (the decode kernel reads it per row),
and an iteration advances only the rows still live. A model whose rows
interact (an MoE layer's capacity is shared by the tokens of a call) is
decoded a row at a time instead, which is what the vmap gives it. One
iteration (the draft steps, the verify, the commit) is one program over
fixed buffers, a CUDA-graph replay on a card (``graphs.CapturedStep``),
repeated until every row is frozen (read from the card every few
iterations, one check behind; a frozen row's iterations change nothing
it returns).

Sampled prompt-lookup decoding draws with the (seed, counter) key rows
of ``sampling.sample_token_rows``: verify position j of a row draws
with its counter advanced by j, and each emitted token advances it by
one, so a token is the one plain sampled decoding draws with the same
key on the same logits (``residual_resample_rows``).
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from .graphs import (RESIDENT_BYTES, DecodeProgram, buffer_bytes,
                     exec_cache_for, weights_links, weights_moved)
from .prompt_lookup import accept_length, propose_ngram_rows
from .sampling import (fold_in_rows, residual_resample_rows, row_keys,
                       sample_token_rows)

__all__ = ["speculative_generate", "mtp_speculative_generate",
           "ngram_speculative_generate"]

# speculative loops read "every row frozen" from the card this often (in
# iterations)
FROZEN_CHECK_EVERY = 4


def _commit(tokens, g_tok, draft, n, k, eos, pad, done):
    """The accept step shared by every drafting strategy, for rows at
    cursors ``n`` [b]: commit the longest draft == target prefix plus the
    target's own correction or bonus token, with eos inside the
    committed span ending the row. ``g_tok`` [b, k+1], ``draft`` [b, k].
    Writes ``tokens`` in place; returns (accepted count, advance, done),
    each [b]."""
    m = accept_length(draft, g_tok)
    j = torch.arange(k + 1, device=tokens.device)[None, :]
    write = torch.where(j <= m[:, None], g_tok, torch.full_like(g_tok, pad))
    tokens.scatter_(1, n.long()[:, None] + j, write.to(tokens.dtype))
    if eos is None:
        return m, m + 1, done
    hit = (write == eos) & (j <= m[:, None])
    any_hit = hit.any(dim=-1)
    first_eos = torch.argmax(hit.to(torch.int32), dim=-1)
    adv = torch.where(any_hit, first_eos + 1, m + 1)
    return m, adv, done | any_hit


def _mask_tail(tokens, n_end, total, pad):
    """Blank the speculative tail and anything past each row's final
    cursor."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    keep = pos < torch.clamp(n_end, max=total)[:, None]
    return torch.where(keep, tokens,
                       torch.full_like(tokens, pad))[:, :total]


def _spec_stats(nfwd, n_end, total, prompt_len, bsz):
    # emitted counts actual tokens (eos can stop early), so the
    # tokens-per-forward figure is not overstated
    nfwd = np.asarray(nfwd).reshape(-1)
    emitted = np.minimum(np.asarray(n_end).reshape(-1), total) - prompt_len
    tpf = emitted / np.maximum(nfwd, 1)
    if bsz == 1:
        return {"target_forwards": int(nfwd[0]),
                "emitted_tokens": int(emitted[0]),
                "tokens_per_forward": float(tpf[0])}
    return {"target_forwards": nfwd.tolist(),
            "emitted_tokens": emitted.tolist(),
            "tokens_per_forward": tpf.tolist()}


class _SpecProgram(DecodeProgram):
    """The fixed buffers of one speculative decode shape and its
    iteration: ``draft`` is a model, or None for prompt lookup (with
    ``ngram``); ``sampled`` only with prompt lookup. The program, which
    lives in the target's cache, holds the draft by a weak reference:
    a caller who drops the draft frees its weights, and the program goes
    stale (its graph read them)."""

    def __init__(self, target, draft, b, prompt_len, max_new, k, ngram,
                 eos, pad, sampled):
        super().__init__(target.device)
        self.target = target
        self._draft = None if draft is None else weakref.ref(draft)
        dev = self.device
        self.b, self.k, self.ngram = b, k, ngram
        self.prompt_len = prompt_len
        self.total = total = prompt_len + max_new
        self.eos, self.pad, self.sampled = eos, pad, sampled
        L = total + k + 1
        self.t_caches = target.init_kv_caches(b, L)
        self.d_caches = draft.init_kv_caches(b, L) if draft is not None \
            else None
        self.tokens = torch.zeros(b, L, dtype=torch.int64, device=dev)
        self.n = torch.zeros(b, dtype=torch.int32, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.nfwd = torch.zeros(b, dtype=torch.int32, device=dev)
        self.frozen = torch.zeros((), dtype=torch.bool, device=dev)
        self.keys = self.temperature = self.top_k = self.top_p = None
        if sampled:
            self.keys = torch.zeros(b, 2, dtype=torch.int64, device=dev)
            self.temperature = torch.zeros(b * (k + 1), dtype=torch.float32,
                                           device=dev)
            self.top_k = torch.zeros(b * (k + 1), dtype=torch.int32,
                                     device=dev)
            self.top_p = torch.zeros(b * (k + 1), dtype=torch.float32,
                                     device=dev)
        self.j = torch.arange(k + 1, device=dev)[None, :]
        # keyed by the draft, so the links (whose dicts hold its tensors)
        # go with it
        self._draft_links = weakref.WeakKeyDictionary()
        if draft is not None and draft is not target:
            self._draft_links[draft] = weights_links(draft)
        self.nbytes = buffer_bytes(self.t_caches, self.d_caches,
                                   self.tokens)

    @property
    def draft(self):
        return None if self._draft is None else self._draft()

    def stale(self) -> bool:
        if self._draft is None:
            return False
        draft = self._draft()
        if draft is None:
            return True
        links = self._draft_links.get(draft)
        return links is not None and weights_moved(links)

    def _targets(self, raw, draft):
        """Per-position verify targets [b, k+1]: the greedy argmax, or the
        sampled accept / resample with position j's key the row's counter
        advanced by j (the last position has no draft)."""
        if not self.sampled:
            return torch.argmax(raw, dim=-1)
        b, T = self.b, self.k + 1
        pos_keys = torch.stack([fold_in_rows(self.keys, j)
                                for j in range(T)], 1).reshape(b * T, 2)
        d_ext = torch.cat([draft, torch.full_like(draft[:, :1], -1)], 1)
        toks, _, _ = residual_resample_rows(
            raw.reshape(b * T, -1), d_ext.reshape(-1), pos_keys,
            self.temperature, self.top_k, self.top_p)
        return toks.reshape(b, T)

    def _step(self):
        """One iteration: the draft, one verify forward, the commit."""
        k, tokens = self.k, self.tokens
        live = (self.n < self.total) & ~self.done
        # a frozen row's cursor is held inside the buffers; what the
        # iteration writes for it lies past its final cursor
        ns = torch.clamp(self.n, max=self.total)
        draft_model = self.draft
        if draft_model is not None:
            # k+1 draft steps, not k: each caches K/V for its input token
            # only, so the extra step commits d_{k-1}'s cache entry; its
            # own proposal (at n+k) is overwritten by the commit
            for j in range(k + 1):
                ci = ns - 1 + j
                ids = tokens.gather(1, ci.long()[:, None])
                dl, _ = draft_model(ids, kv_caches=self.d_caches,
                                    cache_index=ci)
                nxt = torch.argmax(dl[:, -1], dim=-1)
                tokens.scatter_(1, (ci + 1).long()[:, None], nxt[:, None])
            draft = tokens.gather(1, ns.long()[:, None] + self.j[:, :k])
        else:
            draft = propose_ngram_rows(tokens, ns, k, self.ngram,
                                       fill=self.pad)
            tokens.scatter_(1, ns.long()[:, None] + self.j[:, :k], draft)
        # ONE target forward over [t_{n-1}, d_0 .. d_{k-1}]: logits[j] is
        # the target's prediction for position n+j
        chunk = tokens.gather(1, (ns - 1).long()[:, None] + self.j)
        logits, _ = self.target(chunk, kv_caches=self.t_caches,
                                cache_index=ns - 1)
        g = self._targets(logits.float(), draft)
        _, adv, done = _commit(tokens, g, draft, ns, k, self.eos, self.pad,
                               self.done)
        if self.sampled:
            self.keys.copy_(torch.where(live[:, None],
                                        fold_in_rows(self.keys, adv),
                                        self.keys))
        self.n.copy_(torch.where(live, self.n + adv.to(torch.int32), self.n))
        self.done.copy_(torch.where(live, done, self.done))
        self.nfwd += live.to(torch.int32)
        self.frozen.copy_(~((self.n < self.total) & ~self.done).any())

    def _run(self, input_ids, keys, temperature, top_k, top_p):
        P = self.prompt_len
        logits, _ = self.target(input_ids, kv_caches=self.t_caches,
                                cache_index=0)
        if self.draft is not None:
            self.draft(input_ids, kv_caches=self.d_caches, cache_index=0)
        raw0 = logits[:, -1].float()
        if self.sampled:
            self.temperature.fill_(temperature)
            self.top_k.fill_(top_k)
            self.top_p.fill_(top_p)
            # the first token: a draftless position, one plain sample
            b = self.b
            first, _, new_keys = sample_token_rows(
                raw0, keys, self.temperature[:b], self.top_k[:b],
                self.top_p[:b])
            self.keys.copy_(new_keys)
        else:
            first = torch.argmax(raw0, dim=-1)
        self.tokens[:, :P].copy_(input_ids)
        self.tokens[:, P:].fill_(self.pad)
        self.tokens[:, P] = first
        self.n.fill_(P + 1)
        self.done.copy_(first == self.eos if self.eos is not None
                        else torch.zeros_like(self.done))
        self.nfwd.fill_(1)
        self.frozen.copy_(~((self.n < self.total) & ~self.done).any())
        self.run_steps(max(self.total - P - 1, 0), self.frozen,
                       every=FROZEN_CHECK_EVERY)
        out = _mask_tail(self.tokens, self.n, self.total, self.pad)
        # copies: on the CPU .numpy() would share the program's buffers
        return (out.to(input_ids.dtype), self.nfwd.cpu().numpy().copy(),
                self.n.cpu().numpy().copy())


def _rows_alone(*models) -> bool:
    """Whether a batch must be decoded a row at a time: the JAX package
    vmaps a one-row loop over the rows, so a model whose rows interact
    (MoE capacity, ``rows_independent``) routes each row as a batch of
    one there."""
    return not all(getattr(m, "rows_independent", True)
                   for m in models if m is not None)


def _by_rows(run, input_ids, keys, rows_alone):
    """``run(ids, keys)`` -> (out, nfwd, n_end) over the whole batch, or
    row by row (the same one-row program each time) and stacked."""
    if not rows_alone or input_ids.shape[0] == 1:
        return run(input_ids, keys)
    parts = [run(input_ids[r:r + 1], None if keys is None
                 else keys[r:r + 1]) for r in range(input_ids.shape[0])]
    return (torch.cat([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def _spec_run(target, draft, input_ids, max_new_tokens, k, ngram, eos,
              pad, return_stats, generator=None, temperature=0.0, top_k=0,
              top_p=1.0):
    device = target.device
    input_ids = torch.as_tensor(input_ids, device=device)
    bsz, prompt_len = input_ids.shape
    sampled = temperature > 0.0
    keys = row_keys(generator, bsz, device) if sampled else None
    total = prompt_len + max_new_tokens

    def run(ids, row_keys_):
        b = ids.shape[0]
        key = ("spec", id(draft), ngram, b, prompt_len, max_new_tokens, k,
               eos, pad, sampled)
        prog = exec_cache_for(target, RESIDENT_BYTES).get(
            key, lambda: _SpecProgram(target, draft, b, prompt_len,
                                      max_new_tokens, k, ngram, eos, pad,
                                      sampled))
        return prog.run(ids, row_keys_, temperature, top_k, top_p)

    out, nfwd, n_end = _by_rows(run, input_ids, keys,
                                _rows_alone(target, draft))
    if return_stats:
        return out, _spec_stats(nfwd, n_end, total, prompt_len, bsz)
    return out


@torch.inference_mode()
def speculative_generate(target, draft, input_ids, max_new_tokens: int = 64,
                         num_draft_tokens: int = 4,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0,
                         return_stats: bool = False):
    """Greedy decode of ``target`` accelerated by ``draft`` (both follow
    the CausalLM contract and lie on one device). Returns [b, prompt +
    max_new_tokens] ids (pad after eos and past the end), equal to the
    target's own greedy ``generate`` row by row. Rows accept
    independently and finished rows freeze while the slowest finishes.
    With ``return_stats``, also a dict with ``target_forwards`` (the
    prefill included; plain greedy needs max_new_tokens of them),
    ``emitted_tokens`` and ``tokens_per_forward`` (per-row lists when
    b > 1)."""
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError("num_draft_tokens must be >= 1")
    return _spec_run(target, draft, input_ids, max_new_tokens, k, None,
                     eos_token_id, pad_token_id, return_stats)


class _MtpProgram(DecodeProgram):
    """The fixed buffers of one MTP self-speculative decode shape and its
    iteration (the body of the JAX package's ``while_loop``): the depth-0
    MTP module drafts k tokens by chaining its own pre-norm output
    (Eagle-style, one MLA cache of its own), one target forward verifies
    them and yields the true hiddens, and a bulk pass of the module over
    the committed window rewrites its cache from them and gives the next
    round's first draft. Rows keep a cursor each (``n`` [b]); frozen rows
    change nothing they return."""

    def __init__(self, model, b, prompt_len, max_new, k, eos, pad):
        super().__init__(model.device)
        self.model = model
        dev, cfg = self.device, model.config
        self.b, self.k, self.eos, self.pad = b, k, eos, pad
        self.prompt_len = prompt_len
        self.total = total = prompt_len + max_new
        L = total + k + 1
        self.t_caches = model.init_kv_caches(b, L)
        self.m_cache = model.init_mtp_cache(b, L)
        self.tokens = torch.zeros(b, L, dtype=torch.int64, device=dev)
        self.n = torch.zeros(b, dtype=torch.int32, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.nfwd = torch.zeros(b, dtype=torch.int32, device=dev)
        self.frozen = torch.zeros((), dtype=torch.bool, device=dev)
        self.h_last = torch.zeros(b, 1, cfg.hidden_size, dtype=cfg.dtype,
                                  device=dev)
        self.d0 = torch.zeros(b, dtype=torch.int64, device=dev)
        self.rows = torch.arange(b, device=dev)
        self.j = torch.arange(k + 1, device=dev)[None, :]
        self.nbytes = buffer_bytes(self.t_caches, self.m_cache, self.tokens)

    def _mtp(self, h_prev, tok, positions, cache_index):
        """One pass of the depth-0 module over ``tok`` at ``positions``
        with its own cache: (shared-head logits fp32, PRE-norm hidden)."""
        model = self.model
        normed, pre, _ = model.mtp[0](
            h_prev, model.model.embed_tokens(tok), positions,
            kv_cache=self.m_cache, cache_index=cache_index)
        return model.lm_head(normed).float(), pre

    def _at(self, x, idx):
        """Row r's entry ``idx[r]`` of x [b, s, ...] -> [b, ...]."""
        return x[self.rows, idx.long()]

    def _step(self):
        k, tokens = self.k, self.tokens
        live = (self.n < self.total) & ~self.done
        ns = torch.clamp(self.n, max=self.total)
        tokens.scatter_(1, ns.long()[:, None], self.d0[:, None])
        # the k-1 chained draft steps: at position cur the module takes
        # the previous step's pre-norm output and draft, and predicts
        # the token at cur + 2
        h_prev, tok_prev, cur = self.h_last, self.d0, ns - 1
        for _ in range(k - 1):
            lg, pre = self._mtp(h_prev, tok_prev[:, None], cur[:, None], cur)
            nxt = torch.argmax(lg[:, -1], dim=-1)
            tokens.scatter_(1, (cur + 2).long()[:, None], nxt[:, None])
            h_prev, tok_prev, cur = pre[:, -1:], nxt, cur + 1
        # verify: ONE target forward over [t_{n-1}, d_0 .. d_{k-1}], with
        # the true hiddens for the bulk pass
        chunk = tokens.gather(1, (ns - 1).long()[:, None] + self.j)
        logits, h_ctx, _ = self.model(chunk, kv_caches=self.t_caches,
                                      cache_index=ns - 1,
                                      return_prenorm=True)
        g = torch.argmax(logits.float(), dim=-1)
        draft = tokens.gather(1, ns.long()[:, None] + self.j[:, :k])
        _, adv, done = _commit(tokens, g, draft, ns, k, self.eos, self.pad,
                               self.done)
        # bulk: the module's cache rewritten for the committed window from
        # the target's hiddens; the next round's d0 / h_last are read at
        # the accepted boundary
        toks_in = tokens.gather(1, ns.long()[:, None] + self.j)
        m_logits, m_pre = self._mtp(h_ctx, toks_in,
                                    (ns - 1)[:, None] + self.j, ns - 1)
        sel = adv - 1
        h_last = self._at(m_pre, sel)[:, None]
        d0 = torch.argmax(self._at(m_logits, sel), dim=-1)
        self.h_last.copy_(torch.where(live[:, None, None], h_last,
                                      self.h_last))
        self.d0.copy_(torch.where(live, d0, self.d0))
        self.n.copy_(torch.where(live, self.n + adv.to(torch.int32), self.n))
        self.done.copy_(torch.where(live, done, self.done))
        self.nfwd += live.to(torch.int32)
        self.frozen.copy_(~((self.n < self.total) & ~self.done).any())

    def _run(self, input_ids):
        P, b = self.prompt_len, self.b
        logits, pre, _ = self.model(input_ids, kv_caches=self.t_caches,
                                    cache_index=0, return_prenorm=True)
        first = torch.argmax(logits[:, -1], dim=-1)
        self.tokens[:, :P].copy_(input_ids)
        self.tokens[:, P:].fill_(self.pad)
        self.tokens[:, P] = first
        # the module's prefill: position i pairs h_i with the embedding
        # of t_{i+1}, so the shifted stream is prompt[1:] + [first]; it
        # fills the module's cache and gives d0 (for position P + 1)
        m_toks = torch.cat([input_ids[:, 1:].long(), first[:, None]], dim=1)
        m_pos = torch.arange(P, device=self.device)[None, :].expand(b, P)
        m_logits, m_pre = self._mtp(pre, m_toks, m_pos, 0)
        self.d0.copy_(torch.argmax(m_logits[:, -1], dim=-1))
        self.h_last.copy_(m_pre[:, -1:])
        self.n.fill_(P + 1)
        self.done.copy_(first == self.eos if self.eos is not None
                        else torch.zeros_like(self.done))
        self.nfwd.fill_(1)
        self.frozen.copy_(~((self.n < self.total) & ~self.done).any())
        self.run_steps(max(self.total - P - 1, 0), self.frozen,
                       every=FROZEN_CHECK_EVERY)
        out = _mask_tail(self.tokens, self.n, self.total, self.pad)
        # copies: on the CPU .numpy() would share the program's buffers
        return (out.to(input_ids.dtype), self.nfwd.cpu().numpy().copy(),
                self.n.cpu().numpy().copy())


@torch.inference_mode()
def mtp_speculative_generate(model, input_ids, max_new_tokens: int = 64,
                             num_draft_tokens: int = 4,
                             eos_token_id: Optional[int] = None,
                             pad_token_id: int = 0,
                             return_stats: bool = False):
    """Greedy decode accelerated by the model's own multi-token-prediction
    head, no second model (DeepSeek-V3 tech report, MTP for speculative
    decoding): the depth-0 MTP module drafts ``num_draft_tokens`` tokens
    a round (:class:`_MtpProgram`) and one target forward verifies them.
    The output equals the model's greedy ``generate`` row by row,
    whatever the drafts; with ``return_stats``, also the target forwards
    and tokens per forward, as :func:`speculative_generate` gives them.
    A model whose rows interact (MoE: every DeepSeek) decodes its rows
    one at a time, as the JAX package's vmap over rows does."""
    cfg = model.config
    if getattr(cfg, "num_nextn_predict_layers", 0) < 1:
        raise ValueError("model has no MTP depth modules "
                         "(config.num_nextn_predict_layers == 0)")
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError("num_draft_tokens must be >= 1")
    input_ids = torch.as_tensor(input_ids, device=model.device)
    bsz, prompt_len = input_ids.shape

    def run(ids, _keys):
        key = ("mtp", ids.shape[0], prompt_len, max_new_tokens, k,
               eos_token_id, pad_token_id)
        prog = exec_cache_for(model, RESIDENT_BYTES).get(
            key, lambda: _MtpProgram(model, ids.shape[0], prompt_len,
                                     max_new_tokens, k, eos_token_id,
                                     pad_token_id))
        return prog.run(ids)

    out, nfwd, n_end = _by_rows(run, input_ids, None, _rows_alone(model))
    if return_stats:
        return out, _spec_stats(nfwd, n_end, prompt_len + max_new_tokens,
                                prompt_len, bsz)
    return out


@torch.inference_mode()
def ngram_speculative_generate(model, input_ids, max_new_tokens: int = 64,
                               num_draft_tokens: int = 4, ngram: int = 2,
                               eos_token_id: Optional[int] = None,
                               pad_token_id: int = 0,
                               return_stats: bool = False,
                               temperature: float = 0.0, top_k: int = 0,
                               top_p: float = 1.0,
                               generator: Optional[torch.Generator] = None):
    """Greedy or sampled decode accelerated by prompt-lookup drafting: no
    draft model; the continuation of the most recent earlier occurrence
    of each row's last ``ngram`` tokens (``prompt_lookup``'s proposer,
    pad-filled when nothing matches) is the draft, and one target forward
    verifies it. With ``temperature <= 0`` (the default) the output
    equals greedy ``generate`` row by row. With ``temperature > 0`` the
    verify is rejection-sampled (``residual_resample_rows``): a drafted
    position is accepted with probability p(draft) under the row's
    filtered distribution and a rejection emits a sample of the rest, so
    the output follows plain sampled decoding; ``generator`` draws each
    row's seed (seed 0 when None)."""
    k, g = int(num_draft_tokens), int(ngram)
    input_ids = torch.as_tensor(input_ids)
    if k < 1:
        raise ValueError("num_draft_tokens must be >= 1")
    if g < 1:
        raise ValueError("ngram must be >= 1")
    if input_ids.shape[1] + 1 < g:
        raise ValueError(f"prompt too short for ngram={g}")
    return _spec_run(model, None, input_ids, max_new_tokens, k, g,
                     eos_token_id, pad_token_id, return_stats, generator,
                     float(temperature), int(top_k), float(top_p))
