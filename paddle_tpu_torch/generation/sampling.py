"""Logits processors for autoregressive decoding (the subset of
``paddle_tpu/generation/sampling.py`` that ``generate()`` and the paged
engine's ticks use, the speculative verify's included).

Filtering masks to the finite -1e30, as the JAX package does, so a
filtered row never holds a NaN. ``generate()`` draws from an explicit
``torch.Generator``. The engine's per-row sampling uses a row key of two
32-bit words, (seed, counter), instead of the JAX package's threefry
keys: a token is the Gumbel-max over noise hashed from (seed, counter,
vocab index) with integer ops, and every emitted token advances the
counter by one. Nothing hidden enters a draw, so a row's stream does not
depend on its batch, resumes exactly after a preemption (the key rides
with the request), and gives the same tokens on the CPU and the card for
the same logits. Neither kind of sampled stream matches the JAX
package's bit for bit; they match it in distribution.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def apply_temperature(logits, temperature):
    return logits / max(float(temperature), 1e-6)


def top_k_filter(logits, k: int):
    """Keep the k highest logits per row; mask the rest."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                       logits)


def top_p_filter(logits, p: float):
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches p (always keeps the argmax)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # mask sorted positions whose *previous* cumulative already reached p
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def repetition_penalty(logits, generated_mask, penalty: float):
    """Divide positive / multiply negative logits of seen tokens
    (``generated_mask`` [b, vocab], counts or bools)."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(generated_mask > 0, penalized, logits)


def sample_token(logits, generator=None, temperature=1.0, top_k=0,
                 top_p=1.0, do_sample=True):
    """logits [b, vocab] -> token ids [b] (int64)."""
    logits = logits.float()
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = apply_temperature(logits, temperature)
    if top_k and top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def suffix_window_hits(seq, cur: int, g: int):
    """[..., L] bool: window ``seq[..., p : p+g]`` equals the last ``g``
    committed tokens ``seq[..., cur-g : cur]``, restricted to windows
    strictly earlier than that suffix. ``g == 0`` matches every committed
    position. Leading dims are rows."""
    L = seq.shape[-1]
    starts = torch.arange(L, device=seq.device)
    idx = (starts[:, None] + torch.arange(g, device=seq.device)[None, :]
           ).clamp(0, L - 1)                                  # [L, g]
    win = seq[..., idx]                                       # [..., L, g]
    last = seq[..., max(cur - g, 0):max(cur - g, 0) + g]      # [..., g]
    hit = (win == last[..., None, :]).all(dim=-1)
    return hit & (starts <= cur - g - 1) & (cur >= g)


def suffix_window_hits_rows(seqs, cur, g: int):
    """:func:`suffix_window_hits` with a committed count per row: seqs
    [R, L], ``cur`` [R] tensor -> [R, L] bool. The suffix is read where
    the JAX package's ``dynamic_slice`` reads it (start clamped into the
    row), and no value goes to the host."""
    R, L = seqs.shape
    dev = seqs.device
    cur = cur.long()
    starts = torch.arange(L, device=dev)
    offs = torch.arange(g, device=dev)
    win = seqs[:, (starts[:, None] + offs[None, :]).clamp(0, L - 1)]
    first = (cur - g).clamp(0, max(L - g, 0))
    last = seqs.gather(1, first[:, None] + offs[None, :])      # [R, g]
    hit = (win == last[:, None, :]).all(dim=-1)
    return hit & (starts[None, :] <= (cur - g - 1)[:, None]) \
        & (cur >= g)[:, None]


# ------------------------------------------------------- per-row sampling
def repetition_penalty_rows(logits, seen, penalties):
    """Per-row repetition penalty: logits [R, V], seen [R, V] bool,
    penalties [R] (1.0 = off). Rows at 1.0 pass through bit-exactly."""
    p = penalties.float()[:, None]
    pen = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen & (p != 1.0), pen, logits)


def filter_logits_rows(logits, temperature, top_k, top_p):
    """Per-row temperature / top-k / top-p on [R, V] logits with per-row
    tensors (k <= 0 / p >= 1 disable). Returns fp32 logits: kept entries
    divided by the temperature, the rest NEG_INF. The same ops, in the
    same order, as the JAX package's ``filter_logits_rows``."""
    raw = logits.float()
    V = raw.shape[-1]
    temperature = temperature.float()
    top_k = top_k.long()
    top_p = top_p.float()
    neg = torch.full_like(raw, NEG_INF)
    lt = raw / temperature.clamp_min(1e-6)[:, None]
    # per-row top-k: the k-th largest value is the threshold
    sd = torch.sort(lt, dim=-1, descending=True).values
    kth = sd.gather(1, (top_k - 1).clamp(0, V - 1)[:, None])
    lt = torch.where((top_k[:, None] > 0) & (lt < kth), neg, lt)
    # the top-k-filtered row in sorted order, from the one sort: rank >= k
    # is masked (ties at the k-th value are kept by the filter above but
    # counted once in the top-p cumsum)
    rank = torch.arange(V, device=raw.device)[None, :]
    sd2 = torch.where((top_k[:, None] <= 0) | (rank < top_k[:, None]), sd,
                      neg)
    probs = torch.softmax(sd2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]    # always keeps argmax
    thresh = torch.where(keep_sorted, sd2,
                         torch.full_like(sd2, float("inf"))).amin(
                             dim=-1, keepdim=True)
    return torch.where((top_p[:, None] < 1.0) & (lt < thresh), neg, lt)


def seed_key_row(seed: int) -> np.ndarray:
    """One row's key: [seed, counter] as two uint32 words, counter 0.
    It replaces the JAX package's threefry ``PRNGKey(seed)`` data."""
    return np.array([int(seed) & _M32, 0], np.uint32)


def override_key_rows(keys, rows, new_keys, flags):
    """Scatter per-row key overrides into the [R, 2] key state (int64
    rows of uint32 words): row ``rows[j]`` takes ``new_keys[j]`` where
    ``flags[j] != 0``; every other row keeps its current (device) key.
    The key rule of the engine's transition descriptors, shared by the
    one-row patch and the fused patch queue. Rows whose flag is 0, and
    rows outside [0, R), go to the extra index R, which is cut off: an
    all-zero ``flags`` leaves ``keys`` bit for bit. Returns a new
    tensor."""
    keys = keys.long()
    R = keys.shape[0]
    rows = rows.long()
    keep = (flags != 0) & (rows >= 0) & (rows < R)
    target = torch.where(keep, rows, torch.full_like(rows, R))
    ext = torch.cat([keys, keys.new_zeros(1, 2)])
    ext[target] = new_keys.long() & _M32
    return ext[:R]


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, split
    in 16-bit halves so no intermediate leaves the int64 range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finaliser (xor-shift-multiply, the "lowbias32"
    constants) on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise_rows(keys, vocab: int):
    """[R, V] float64 Gumbel noise of the rows' keys ([R, 2] int64 of
    uint32 words): a counter-based hash of (seed, counter, vocab index),
    so the same key gives the same bits on any device and in any batch."""
    keys = keys.long()
    base = _mix32(_mix32(keys[:, 0] ^ 0x243F6A88) ^ keys[:, 1])     # [R]
    v = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    h = _mix32(_mix32(base[:, None] ^ v[None, :]) ^ 0x85EBCA6B)
    u = ((h >> 8).double() + 0.5) / float(1 << 24)           # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_token_rows(logits, keys, temperature, top_k, top_p):
    """Per-row sampling for continuous batching. logits [R, V] (raw);
    keys [R, 2] int64 rows of (seed, counter); temperature [R] (<= 0:
    greedy, the exact argmax of the raw fp32 logits); top_k [R] (<= 0
    disables); top_p [R] (>= 1 disables).

    Returns (tokens [R] int64, logprobs [R] fp32 of the chosen token under
    the unfiltered softmax, new_keys [R, 2] with every counter advanced by
    one). A sampled token is argmax(filtered logits + Gumbel noise), in
    float64."""
    raw = logits.float()
    lt = filter_logits_rows(raw, temperature, top_k, top_p)
    noise = gumbel_noise_rows(keys, raw.shape[-1])
    sampled = torch.argmax(lt.double() + noise, dim=-1)
    tokens = torch.where(temperature <= 0.0, torch.argmax(raw, dim=-1),
                         sampled)
    logprobs = torch.log_softmax(raw, dim=-1).gather(
        1, tokens[:, None])[:, 0]
    return tokens, logprobs, fold_in_rows(keys, 1)


# ------------------------------------------- the speculative verify's keys
def fold_in_rows(keys, j):
    """The key of a row's j-th draw from ``keys`` [R, 2]: its counter
    advanced by ``j`` (an int, or an [R] tensor), mod 2**32. Position j of
    a speculative tick's verify window draws with it, which is the key the
    plain tick would use for the row's j-th next token."""
    keys = keys.long()
    if torch.is_tensor(j):
        j = j.long()
    return torch.stack([keys[:, 0], (keys[:, 1] + j) & _M32], dim=1)


def split_key_rows(keys, n=1):
    """(carry, sub) of a tick: ``sub`` is the rows' keys as they stand,
    from which each verify position folds its own (:func:`fold_in_rows`);
    ``carry`` has every counter advanced by ``n`` (an int or an [R] tensor
    of the tokens each row emitted), so each emitted token advances the
    stream by one, as on the plain tick. Counterpart of the JAX package's
    one-split-per-tick rule on its threefry keys."""
    return fold_in_rows(keys, n), keys.long()


def residual_resample_rows(logits, draft, keys, temperature, top_k,
                           top_p):
    """One verify position of the rejection-sampled speculative tick with
    a deterministic (one-hot) draft, row-batched: logits [R, V] fp32 (the
    penalty-applied logits the plain tick would sample from), draft [R]
    (< 0: no draft), keys [R, 2] this position's keys, temperature /
    top_k / top_p as :func:`sample_token_rows`.

    The token is the plain tick's Gumbel-max sample from the filtered
    logits (greedy rows: the argmax), and the draft is accepted iff the
    token equals it. That is the JAX package's residual rule with a
    one-hot draft q = onehot(d): P(accept) = p(d) under the filtered
    distribution p, and on a rejection the token follows p with d removed
    and renormalised, so P(emit y) = p(y) whatever the draft. The token
    is also exactly the one the plain tick draws with the same key, so a
    speculative stream equals the spec-off stream bit for bit on the
    same logits, sampled rows included.

    Returns (tokens [R] int64, accepted [R] bool, logprobs [R] fp32 of
    the token under the unfiltered softmax)."""
    tokens, logprobs, _ = sample_token_rows(logits, keys, temperature,
                                            top_k, top_p)
    accepted = (draft >= 0) & (tokens == draft)
    return tokens, accepted, logprobs
