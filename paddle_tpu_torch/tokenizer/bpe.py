"""Merges-based byte-level BPE tokenizer (the port's copy of
``paddle_tpu/tokenizer/bpe.py``; reference: PaddleNLP
``paddlenlp/transformers/gpt/tokenizer.py`` GPTTokenizer and
``llama/tokenizer_fast.py``: the rank-ordered merge loop over a
byte-to-unicode alphabet that GPT-2/Llama-3/Qwen2 checkpoints require).

Host code: tokenization never runs on the card. The merge loop runs in
C++ (``native/src/bpe.cc``), built at first use; a failed build raises.
A vocab or merge entry outside the byte alphabet sends that tokenizer to
the Python merge loop, as in the JAX package, and ``counts`` says which
loop encoded each stretch of text.

The pretokenizer needs no ``regex`` package. A split pattern written
for ``regex`` (``\\p{L}``, ``\\p{N}``, ``\\s`` as Unicode White_Space) is
translated once into a stdlib ``re`` pattern (:func:`translate_split`):
each Unicode class becomes explicit code-point ranges read from
``_unicode_ranges.py``, a table generated from ``regex`` itself
(``tools/gen_unicode_ranges.py``), so the classes are ``regex``'s at
every code point whatever this Python's Unicode version. A construct that
``re`` cannot express with the same meaning is refused with
``ValueError``. Loads either HF ``tokenizer.json`` or GPT-2 style
``vocab.json`` + ``merges.txt``.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import sys
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ._unicode_ranges import RANGES

# GPT-2's pretokenizer split (tokenizers ByteLevel default)
GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
              r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
# Llama-3 / GPT-4 (cl100k-style) split
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")

# which merge loop encoded each stretch of plain text: "native" (C++) or
# "python" (a vocab outside the byte alphabet, or a byte with no id)
counts = {"native": 0, "python": 0}

_REFUSED_ESCAPES = "wWbBXGKmM"


def _runs(name: str) -> List[List[int]]:
    """[first, last] runs of general category ``name`` (``L``, ``Lu``,
    ``N``...), or of White_Space for ``"space"``, from ``regex``'s table."""
    flat = RANGES[name]
    return [[flat[i], flat[i + 1]] for i in range(0, len(flat), 2)]


def _esc(c: int) -> str:
    return f"\\u{c:04x}" if c <= 0xFFFF else f"\\U{c:08x}"


@lru_cache(maxsize=None)
def _ranges(name: str, negate: bool) -> str:
    """The class body (no brackets) of ``name``'s code points, or of
    their complement: ``\\uXXXX-\\uYYYY`` ranges for ``re``."""
    runs = _runs(name)
    if negate:
        gaps, start = [], 0
        for a, b in runs:
            if a > start:
                gaps.append([start, a - 1])
            start = b + 1
        if start <= sys.maxunicode:
            gaps.append([start, sys.maxunicode])
        runs = gaps
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}"
                   for a, b in runs)


_CATEGORIES = {"L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "Mn", "Mc", "Me",
               "N", "Nd", "Nl", "No", "P", "Pc", "Pd", "Ps", "Pe", "Pi",
               "Pf", "Po", "S", "Sm", "Sc", "Sk", "So", "Z", "Zs", "Zl",
               "Zp", "C", "Cc", "Cf", "Co", "Cn"}


@lru_cache(maxsize=32)
def translate_split(pattern: str) -> str:
    """A ``regex``-syntax split pattern as a stdlib ``re`` pattern with the
    same matches. ``\\p{..}``/``\\P{..}`` (a general category, braced or
    one letter), ``\\s``/``\\S`` (White_Space) and ``\\d``/``\\D`` (Nd)
    become explicit ranges: bare inside a ``[...]`` set, wrapped in their
    own ``[...]`` outside one. Raises ``ValueError`` on a construct that
    ``re`` would read otherwise (``\\w``, ``\\b``, a script or binary
    property, a nested set or POSIX class)."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_set = set_start = False
    while i < n:
        ch = pattern[i]
        if ch == "\\":
            if i + 1 >= n:
                raise ValueError(f"split pattern ends in a backslash: "
                                 f"{pattern!r}")
            e = pattern[i + 1]
            set_start = False
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.find("}", i + 3)
                    if end < 0:
                        raise ValueError(f"unclosed \\{e}{{ in {pattern!r}")
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                if name.startswith("^"):
                    name, e = name[1:], "P" if e == "p" else "p"
                if name not in _CATEGORIES:
                    raise ValueError(
                        f"\\{e}{{{name}}} in the split pattern: only Unicode "
                        f"general categories translate to stdlib re")
                body = _ranges(name, e == "P")
            elif e in "sSdD":
                body = _ranges("space" if e in "sS" else "Nd", e in "SD")
                i += 2
            elif e in _REFUSED_ESCAPES and not (in_set and e == "b"):
                raise ValueError(
                    f"\\{e} in the split pattern: its meaning in stdlib re "
                    f"differs from regex's, so it is not translated")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            out.append(body if in_set else f"[{body}]")
            continue
        if in_set:
            if ch == "[":
                raise ValueError(f"a nested set or POSIX class in the split "
                                 f"pattern {pattern!r}: not translated")
            if ch == "]" and not set_start:
                in_set = False
            set_start = False
            out.append(ch)
            i += 1
            continue
        if ch == "[":
            in_set, set_start = True, True
            out.append(ch)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            continue
        out.append(ch)
        i += 1
    if in_set:
        raise ValueError(f"unclosed [ in the split pattern {pattern!r}")
    translated = "".join(out)
    try:
        re.compile(translated)
    except re.error as err:
        raise ValueError(f"the split pattern {pattern!r} has a construct "
                         f"stdlib re cannot express: {err}") from err
    return translated


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table: the 188
    printable latin-1 bytes map to themselves, the rest shift past 255."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class _NativeBPE:
    """ctypes handle over the C++ merge loop (native/src/bpe.cc). The
    C++ side works on RAW BYTES; vocab/merge tokens are converted from
    the printable byte-level alphabet once at build. ``build`` returns
    None when a vocab or merge entry falls outside the byte alphabet (the
    Python loop then keeps the semantics) and raises when the library
    does not build."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @classmethod
    def build(cls, vocab, merges, byte_dec):
        from ..native import lib as native_lib
        lib = native_lib()
        if not vocab:
            return None

        def to_bytes(tok):
            try:
                return bytes(byte_dec[ch] for ch in tok)
            except KeyError:
                return None

        blobs, offsets, ids = [], [0], []
        tok_to_id = {}
        for tok, i in vocab.items():
            raw = to_bytes(tok)
            if raw is None:
                return None  # non-byte-level vocab entry: Python path
            blobs.append(raw)
            offsets.append(offsets[-1] + len(raw))
            ids.append(i)
            tok_to_id[tok] = i
        ml, mr, mm = [], [], []
        for left, right in merges:
            lid = tok_to_id.get(left)
            rid = tok_to_id.get(right)
            mid = tok_to_id.get(left + right)
            if lid is None or rid is None or mid is None:
                return None  # merge outside vocab: semantics differ
            ml.append(lid)
            mr.append(rid)
            mm.append(mid)

        blob = b"".join(blobs)
        off = np.asarray(offsets, np.int32)
        idarr = np.asarray(ids, np.int32)
        l_ = np.asarray(ml, np.int32)
        r_ = np.asarray(mr, np.int32)
        m_ = np.asarray(mm, np.int32)
        p32 = ctypes.POINTER(ctypes.c_int32)
        h = lib.pt_bpe_create(
            len(ids), blob, off.ctypes.data_as(p32),
            idarr.ctypes.data_as(p32), int(max(ids)), len(ml),
            l_.ctypes.data_as(p32), r_.ctypes.data_as(p32),
            m_.ctypes.data_as(p32))
        if not h:
            raise MemoryError("pt_bpe_create returned no handle")
        # no keepalive needed: pt_bpe_create copies everything into its
        # own std::string/map storage before returning
        return cls(h, lib)

    def encode_words(self, pieces):
        """List of pretokenized strings -> flat ids, or None when a byte
        has no id or the output overflows (the Python loop then runs)."""
        if not pieces:
            return []
        raw = [p.encode("utf-8") for p in pieces]
        blob = b"".join(raw)
        offsets = np.zeros(len(raw) + 1, np.int32)
        np.cumsum([len(r) for r in raw], out=offsets[1:])
        cap = max(len(blob) * 2, 64)
        out = np.empty(cap, np.int32)
        ends = np.empty(len(raw), np.int32)
        p32 = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.pt_bpe_encode_words(
            self._h, blob, offsets.ctypes.data_as(p32), len(raw),
            out.ctypes.data_as(p32), cap, ends.ctypes.data_as(p32))
        if n < 0:
            return None
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_bpe_destroy(self._h)
            self._h = None


class BPETokenizer:
    """Byte-level BPE with rank-ordered merges.

    Parameters
    ----------
    vocab: token string -> id
    merges: ordered (left, right) pairs; earlier = higher priority
    special_tokens: content -> id, matched verbatim before pretokenization
    split_pattern: pretokenizer pattern in ``regex`` syntax (GPT2_SPLIT
        default), translated once by :func:`translate_split`
    add_prefix_space: prepend " " to the text (GPT-2 sentence-start quirk)
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 special_tokens: Optional[Dict[str, int]] = None,
                 split_pattern: str = GPT2_SPLIT,
                 add_prefix_space: bool = False,
                 unk_token: Optional[str] = None):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        self.id_to_token.update({i: t for t, i in self.special_tokens.items()})
        self._special_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.special_tokens,
                                         key=len, reverse=True)))
            if self.special_tokens else None)
        self.split_pattern = split_pattern
        self._split_re = re.compile(translate_split(split_pattern))
        self.add_prefix_space = add_prefix_space
        self.unk_token = unk_token
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._cache: Dict[str, List[str]] = {}
        # C++ merge loop (native/src/bpe.cc): same ids; None -> Python loop
        self._native = _NativeBPE.build(self.vocab, merges, self._byte_dec)

    # ------------------------------------------------------------- encoding
    def _bpe(self, word: str) -> List[str]:
        """Merge loop: repeatedly fuse the lowest-rank adjacent pair."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = -1, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best_rank is None:
                break
            merged = parts[best] + parts[best + 1]
            # fuse every occurrence of this exact pair in one pass
            # (standard BPE: all instances of the chosen pair merge together)
            out: List[str] = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] + parts[i + 1] == merged
                        and (parts[i], parts[i + 1]) in self.ranks
                        and self.ranks[(parts[i], parts[i + 1])] == best_rank):
                    out.append(merged)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        if len(self._cache) < 65536:
            self._cache[word] = parts
        return parts

    def pretokenize(self, text: str) -> List[str]:
        """The split pattern's pieces of ``text`` (prefix space added)."""
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        return self._split_re.findall(text)

    def tokenize(self, text: str) -> List[str]:
        """Text -> BPE token strings (no special-token handling)."""
        toks: List[str] = []
        for piece in self.pretokenize(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            toks.extend(self._bpe(mapped))
        return toks

    def _convert(self, toks: Iterable[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token) if self.unk_token else None
        out = []
        for t in toks:
            i = self.vocab.get(t, unk)
            if i is None:
                raise KeyError(f"token {t!r} not in vocab and no unk_token")
            out.append(i)
        return out

    def _encode_plain(self, text: str) -> List[int]:
        """Non-special text -> ids (the C++ loop unless the data forbids)."""
        if self._native is not None:
            ids = self._native.encode_words(self.pretokenize(text))
            if ids is not None:
                counts["native"] += 1
                return ids
        counts["python"] += 1
        return self._convert(self.tokenize(text))

    def encode(self, text: str) -> List[int]:
        """Text -> ids; special tokens are matched verbatim first."""
        if self._special_re is None:
            return self._encode_plain(text)
        ids: List[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_plain(text[pos:m.start()]))
            ids.append(self.special_tokens[m.group()])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_plain(text[pos:]))
        return ids

    __call__ = encode

    # ------------------------------------------------------------- decoding
    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        special_ids = set(self.special_tokens.values())
        for i in ids:
            i = int(i)
            if i in special_ids:
                flush()
                if not skip_special_tokens:
                    out.append(self.id_to_token[i])
                continue
            for ch in self.id_to_token[i]:
                buf.append(self._byte_dec[ch])
        flush()
        return "".join(out)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -------------------------------------------------------------- loading
    @classmethod
    def from_tokenizer_json(cls, path: str, **overrides) -> "BPETokenizer":
        """Load an HF ``tokenizer.json`` (tokenizers-library format):
        model.vocab/merges, added_tokens, and the pre_tokenizer's Split
        pattern (ByteLevel default = GPT-2's). ``overrides`` (e.g.
        ``add_prefix_space``) take precedence over the parsed values."""
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"not a BPE tokenizer.json: {model.get('type')}")
        if not cls._is_byte_level(data):
            # e.g. Llama-2's sentencepiece-converted BPE: its vocab uses
            # ▁ word boundaries, so running it through the GPT-2 byte
            # alphabet would silently produce unk/garbage ids.
            raise ValueError(
                "only byte-level BPE tokenizer.json is supported (no "
                "ByteLevel pre_tokenizer/decoder found — this looks like "
                "a sentencepiece-style BPE)")
        merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
                  for m in model["merges"]]
        special = {t["content"]: t["id"]
                   for t in data.get("added_tokens", [])}
        split, prefix_space = cls._parse_pre_tokenizer(
            data.get("pre_tokenizer"))
        kw = dict(special_tokens=special, split_pattern=split,
                  add_prefix_space=prefix_space,
                  unk_token=model.get("unk_token"))
        kw.update(overrides)
        return cls(model["vocab"], merges, **kw)

    @staticmethod
    def _is_byte_level(data) -> bool:
        pre = data.get("pre_tokenizer") or {}
        entries = (pre.get("pretokenizers", [])
                   if pre.get("type") == "Sequence" else [pre])
        if any(e.get("type") == "ByteLevel" for e in entries):
            return True
        return (data.get("decoder") or {}).get("type") == "ByteLevel"

    @staticmethod
    def _parse_pre_tokenizer(pre) -> Tuple[str, bool]:
        split, prefix_space = GPT2_SPLIT, False
        entries = []
        if pre:
            entries = (pre.get("pretokenizers", [])
                       if pre.get("type") == "Sequence" else [pre])
        for e in entries:
            if e.get("type") == "ByteLevel":
                prefix_space = bool(e.get("add_prefix_space"))
                if not e.get("use_regex", True):
                    continue  # Split entry carries the pattern (Llama-3)
            elif e.get("type") == "Split":
                pat = e.get("pattern", {})
                if "Regex" in pat:
                    split = pat["Regex"]
        return split, prefix_space

    @classmethod
    def from_vocab_merges(cls, vocab_path: str, merges_path: str,
                          **kw) -> "BPETokenizer":
        """GPT-2 style ``vocab.json`` + ``merges.txt``."""
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ", 1)
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "BPETokenizer":
        tj = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tj):
            return cls.from_tokenizer_json(tj, **kw)
        vj = os.path.join(model_dir, "vocab.json")
        mt = os.path.join(model_dir, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            return cls.from_vocab_merges(vj, mt, **kw)
        raise FileNotFoundError(
            f"no tokenizer.json or vocab.json+merges.txt in {model_dir}")
