"""The port's byte-level BPE (``paddle_tpu_torch.tokenizer``) against the
JAX package's ``BPETokenizer`` and the HF ``tokenizers`` library. A BPE
is trained locally (no network), as ``tests/test_tokenizer.py`` does, and
saved as ``tokenizer.json``. The ids must be equal (exactly) to both
under the GPT-2, Llama-3 and Qwen2 split patterns; the C++ merge loop
must give the Python loop's ids; the pretokenizer, which runs on stdlib
``re`` with the Unicode classes spelled out, must split random text as
the JAX package's ``regex`` split does; and the port must build and
encode in a process where ``regex`` cannot be imported."""
import json
import os
import subprocess
import sys

import pytest
import regex
from hypothesis import event, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

import paddle_tpu.tokenizer as jtok  # noqa: E402
import paddle_tpu_torch.tokenizer as ttok  # noqa: E402
from paddle_tpu_torch.tokenizer import bpe as tbpe  # noqa: E402

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "TPUs multiply matrices in bfloat16 on a 128x128 systolic array.",
    "def train_step(params, batch):\n    return loss, grads\n",
    "Unicode: café naïve über 中文分词 🚀🤖",
    "   leading spaces\tand\ttabs\nnewlines\r\nwindows",
    "don't can't won't it's we're I'll they'd you've",
    "numbers 123 4567 3.14159 0x1F large 1234567890",
]

TRICKY = [
    "Hello, world!",
    "  double  spaces  ",
    "café 🚀 rocket",
    "don't stop",
    "tabs\tnewlines\nmixed \r\n end",
    "123abc 456 def789",
    "",
    "a",
    "中文 mixed English 中文",
    "ROMAN Ⅻ ⅷ ² ½ and ٣٤٥ digits",
    "next\u0085line sep​zero nbsp\x1cfs\x1f",
    "DON'T I'LL SHE'S Ǆ ſ'S",
    "emoji 👩‍👩‍👧 🏳️‍🌈 ✓✓",
]

QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
               r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
SPLITS = {"gpt2": ttok.GPT2_SPLIT, "llama3": ttok.LLAMA3_SPLIT,
          "qwen2": QWEN2_SPLIT}


def _train(path, split):
    """A byte-level BPE trained on CORPUS under ``split`` (None: the
    ByteLevel pre-tokenizer's own GPT-2 split), saved as tokenizer.json."""
    if split is None:
        tok = tokenizers.ByteLevelBPETokenizer()
        tok.train_from_iterator(CORPUS, vocab_size=400, min_frequency=1,
                                special_tokens=["<|endoftext|>", "<pad>"])
        tok.save(str(path))
        return tok
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=400, min_frequency=1, special_tokens=["<|eot|>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Sequence([
        tokenizers.pre_tokenizers.Split(tokenizers.Regex(split),
                                        behavior="isolated"),
        tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False,
                                            use_regex=False),
    ])
    tok.decoder = tokenizers.decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(str(path))
    return tok


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    out = {"bytelevel": (_train(d / "bytelevel.json", None),
                         str(d / "bytelevel.json"))}
    for name, split in SPLITS.items():
        out[name] = (_train(d / f"{name}.json", split), str(d / f"{name}.json"))
    return out


@pytest.mark.parametrize("kind", ("bytelevel", "gpt2", "llama3", "qwen2"))
def test_ids_match_jax_and_the_library(trained, kind):
    ref, path = trained[kind]
    jt = jtok.BPETokenizer.from_tokenizer_json(path)
    before = dict(tbpe.counts)
    pt = ttok.BPETokenizer.from_tokenizer_json(path)
    if kind in SPLITS:
        assert pt.split_pattern == jt._split_re.pattern == SPLITS[kind]
    for s in CORPUS + TRICKY:
        got = pt.encode(s)
        assert got == jt.encode(s), f"port != JAX on {s!r}"
        assert got == ref.encode(s).ids, f"port != tokenizers on {s!r}"
        assert pt.decode(got) == s
        assert pt.tokenize(s) == jt.tokenize(s)
    assert tbpe.counts["python"] == before["python"]
    assert tbpe.counts["native"] > before["native"]


@pytest.mark.parametrize("kind", ("bytelevel", "llama3"))
def test_native_ids_equal_the_python_loop(trained, kind):
    _, path = trained[kind]
    pt = ttok.BPETokenizer.from_tokenizer_json(path)
    assert pt._native is not None
    for s in CORPUS + TRICKY + ["".join(CORPUS) * 3]:
        assert pt._native.encode_words(pt.pretokenize(s)) == \
            pt._convert(pt.tokenize(s)), s


def test_a_vocab_outside_the_byte_alphabet_takes_the_python_loop():
    """A token that is not in GPT-2's byte alphabet (here "▁a", a
    sentencepiece-style marker) builds no native loop, in either package;
    both give the same ids, and the port counts the Python path."""
    table = ttok.bytes_to_unicode()
    vocab = {table[b]: i for i, b in enumerate(range(256))}
    vocab["▁a"] = 256
    vocab[table[ord("a")] + table[ord("b")]] = 257
    merges = [(table[ord("a")], table[ord("b")])]
    jt = jtok.BPETokenizer(vocab, merges)
    before = dict(tbpe.counts)
    pt = ttok.BPETokenizer(vocab, merges)
    assert pt._native is None and jt._native is None
    assert pt.encode("abc ab") == jt.encode("abc ab") == [257, 99, 32, 257]
    assert tbpe.counts["python"] == before["python"] + 1
    assert tbpe.counts["native"] == before["native"]


def test_special_tokens_as_jax(trained):
    _, path = trained["bytelevel"]
    jt = jtok.BPETokenizer.from_tokenizer_json(path)
    pt = ttok.BPETokenizer.from_tokenizer_json(path)
    for s in ("Hello<|endoftext|>world", "<pad><pad>x<|endoftext|>",
              "<|endoftext|>", "a<|endoftext|><pad>b"):
        ids = pt.encode(s)
        assert ids == jt.encode(s)
        assert pt.decode(ids) == jt.decode(ids) == s
        assert pt.decode(ids, skip_special_tokens=True) == \
            jt.decode(ids, skip_special_tokens=True)
    assert pt.special_tokens == jt.special_tokens
    assert pt.vocab_size == jt.vocab_size


def test_vocab_merges_files_and_from_pretrained(trained, tmp_path):
    ref, path = trained["bytelevel"]
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(data["model"]["vocab"], f, ensure_ascii=False)
    with open(tmp_path / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for m in data["model"]["merges"]:
            f.write((m if isinstance(m, str) else " ".join(m)) + "\n")
    pt = ttok.BPETokenizer.from_pretrained(str(tmp_path))
    jt = jtok.BPETokenizer.from_pretrained(str(tmp_path))
    for s in TRICKY:
        assert pt.encode(s) == jt.encode(s) == ref.encode(s).ids
    with pytest.raises(FileNotFoundError):
        ttok.BPETokenizer.from_pretrained(str(tmp_path / "missing"))


def test_sentencepiece_style_refused_as_jax(tmp_path):
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace()
    tok.decoder = tokenizers.decoders.Metaspace()
    trainer = tokenizers.trainers.BpeTrainer(vocab_size=120,
                                             special_tokens=["<unk>"])
    tok.train_from_iterator(CORPUS, trainer)
    path = str(tmp_path / "sp.json")
    tok.save(path)
    with pytest.raises(ValueError, match="byte-level") as jerr:
        jtok.BPETokenizer.from_tokenizer_json(path)
    with pytest.raises(ValueError, match="byte-level") as perr:
        ttok.BPETokenizer.from_tokenizer_json(path)
    assert str(perr.value) == str(jerr.value)


def _differing(cls):
    """Code points where the translated class ``cls`` and ``regex``'s
    disagree, over every code point but the surrogates."""
    text = "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if not 0xD800 <= c <= 0xDFFF)
    import re
    ours = set(re.findall(tbpe.translate_split(cls), text))
    return ours ^ set(regex.findall(cls, text))


@settings(max_examples=300, deadline=None)
@given(text=st.text(max_size=40),
       split=st.sampled_from(sorted(SPLITS)))
def test_pretokenizer_splits_random_text_as_regex(text, split):
    """Equal splits on any text: the translated classes come from
    ``regex``'s own table."""
    pattern = SPLITS[split]
    want = regex.findall(pattern, text)
    pt = ttok.BPETokenizer({}, [], split_pattern=pattern)
    assert pt.pretokenize(text) == want


def test_unicode_classes_match_regex_at_every_code_point():
    """The translated classes against ``regex``'s over every code point:
    no difference in any class (ROADMAP C11, fixed: before, 9,568 letters
    and 93 numbers newer than this Python's Unicode 15.0 differed)."""
    counts = {cls: len(_differing(cls))
              for cls in (r"\p{L}", r"\p{N}", r"\s", r"[^\s\p{L}\p{N}]",
                          r"\d", r"\p{Lu}", r"\P{N}")}
    assert counts == dict.fromkeys(counts, 0)
    # the example recorded with the fault: one GPT-2 piece under regex
    text = ":\U000323b0"
    pt = ttok.BPETokenizer({}, [], split_pattern=ttok.GPT2_SPLIT)
    assert pt.pretokenize(text) == regex.findall(ttok.GPT2_SPLIT, text)
    assert len(pt.pretokenize(text)) == 2


def test_unicode_table_is_what_the_generator_writes_now():
    """``tokenizer/_unicode_ranges.py`` is, byte for byte, what
    ``tools/gen_unicode_ranges.py`` renders from the installed
    ``regex``."""
    pytest.importorskip("regex", reason="the generator reads regex's "
                        "tables; regex is not installed here")
    from paddle_tpu_torch.tokenizer import _unicode_ranges
    from paddle_tpu_torch.tools import gen_unicode_ranges as gen
    with open(gen.OUT, encoding="utf-8") as f:
        assert f.read() == gen.render(gen.table())
    assert _unicode_ranges.REGEX_VERSION == regex.__version__


@pytest.mark.parametrize("pattern,match", (
    (r"\w+", r"\\w"),
    (r"\p{Han}+", "general categories"),
    (r"[[:alpha:]]+", "nested set"),
    (r"\bfoo", r"\\b"),
    (r"[a-z", "unclosed"),
    (r"(?<=\p{L}+)x", "cannot express"),
))
def test_untranslatable_patterns_are_refused(pattern, match):
    with pytest.raises(ValueError, match=match):
        tbpe.translate_split(pattern)


def test_builds_and_encodes_where_regex_cannot_be_imported(trained):
    ref, path = trained["llama3"]
    code = (
        "import sys, json\n"
        "sys.modules['regex'] = None\n"
        "from paddle_tpu_torch.tokenizer import BPETokenizer\n"
        f"tok = BPETokenizer.from_tokenizer_json({path!r})\n"
        f"texts = json.loads({json.dumps(json.dumps(CORPUS + TRICKY))})\n"
        "print(json.dumps([tok.encode(t) for t in texts]))\n"
        "assert 'regex' not in sys.modules or sys.modules['regex'] is None\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == [ref.encode(t).ids for t in CORPUS + TRICKY]
