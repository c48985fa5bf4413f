"""Write ``paddle_tpu_torch/tokenizer/_unicode_ranges.py``: the code-point
ranges of every Unicode general category that the BPE pretokenizer
translates (``tokenizer.bpe._CATEGORIES``), of White_Space (``regex``'s
``\\s``) and of Nd, exactly as the ``regex`` package classifies each code
point. The pretokenizer reads that table instead of this Python's
``unicodedata``, so its splits are ``regex``'s where ``regex`` is not
installed (the card machine has none).

This script imports ``regex``; nothing on the port's import path imports
this script. Run it where ``regex`` is installed:

    python -m paddle_tpu_torch.tools.gen_unicode_ranges          # rewrite
    python -m paddle_tpu_torch.tools.gen_unicode_ranges --check  # compare
"""
from __future__ import annotations

import argparse
import os
import sys

import regex

from ..tokenizer.bpe import _CATEGORIES

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tokenizer", "_unicode_ranges.py")

# the first code point that each Unicode version assigned as a letter:
# the newest one ``regex`` calls a letter names its table's version
_VERSION_PROBES = (("15.1.0", 0x2EBF0), ("16.0.0", 0x1C89),
                   ("17.0.0", 0x11DB0))


def unicode_version() -> str:
    known = [v for v, c in _VERSION_PROBES if regex.match(r"\p{L}", chr(c))]
    return known[-1] if known else "15.0.0 or older"


def runs(cls: str):
    """[(first, last), ...] of the code points that the class ``cls``
    matches, one ``regex`` search over a string of every code point."""
    text = "".join(map(chr, range(sys.maxunicode + 1)))
    return [(m.start(), m.end() - 1)
            for m in regex.finditer(f"(?:{cls})+", text)]


def table():
    """{name: ranges} for every category, and ``space`` (White_Space)."""
    tab = {name: runs(rf"\p{{{name}}}") for name in sorted(_CATEGORIES)}
    tab["space"] = runs(r"\s")
    return tab


def render(tab) -> str:
    lines = [
        '"""Unicode code-point ranges for the BPE pretokenizer, generated by',
        "``python -m paddle_tpu_torch.tools.gen_unicode_ranges`` from the",
        f"``regex`` package {regex.__version__} (its tables: Unicode "
        f"{unicode_version()}).",
        "",
        "``RANGES[name]`` lists ``first, last`` pairs (inclusive) of the",
        "code points in general category ``name`` (``L``, ``Lu``, ``N``,",
        "``Nd``, ...), and ``RANGES['space']`` those of White_Space, which",
        "is what ``regex``'s ``\\\\s`` matches. Do not edit: regenerate.",
        '"""',
        f"REGEX_VERSION = {regex.__version__!r}",
        f"UNICODE_VERSION = {unicode_version()!r}",
        "",
        "RANGES = {",
    ]
    for name, rs in tab.items():
        flat = [f"0x{v:x}" for r in rs for v in r]
        lines.append(f"    {name!r}: (")
        for i in range(0, len(flat), 8):
            lines.append("        " + ", ".join(flat[i:i + 8]) + ",")
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the committed table differs")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    text = render(table())
    if args.check:
        with open(args.out, encoding="utf-8") as f:
            same = f.read() == text
        print("up to date" if same else f"{args.out} differs")
        return 0 if same else 1
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
