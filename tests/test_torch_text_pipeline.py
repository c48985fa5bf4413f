"""The port's ``TextGenerationPipeline`` against the JAX package's: the
same ``llama_tiny`` weights in fp32 (crossed by ``load_jax_state_dict``)
and one byte-level BPE trained locally give the same greedy tokens and
the same text (exactly), through left-padded batches in a bucket, eos
truncation and ``skip_special_tokens``. And the claim of
``tests/test_text_pipeline.py``: a prompt inside a left-padded batch
gives the tokens it gives alone, bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation.pipeline import \
    TextGenerationPipeline as JaxPipeline
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.tokenizer import BPETokenizer as JaxBPE
from paddle_tpu_torch.generation import TextGenerationPipeline
from paddle_tpu_torch.tokenizer import BPETokenizer

tokenizers = pytest.importorskip("tokenizers")

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "def train_step(params, batch):\n    return loss, grads\n",
    "Unicode: café naïve über 中文分词 🚀🤖",
    "don't can't won't it's we're I'll they'd you've",
    "numbers 123 4567 3.14159 0x1F large 1234567890",
]
PROMPTS = ["The quick brown", "a", "Unicode: café 中文 and numbers 123",
           "don't stop the fox"]
TINY = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tok = tokenizers.ByteLevelBPETokenizer()
    tok.train_from_iterator(CORPUS, vocab_size=TINY["vocab_size"],
                            min_frequency=1,
                            special_tokens=["<|endoftext|>", "<pad>"])
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    tok.save(path)
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**TINY), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    jtok, ttok = JaxBPE.from_tokenizer_json(path), \
        BPETokenizer.from_tokenizer_json(path)
    assert max(ttok.vocab.values()) < TINY["vocab_size"]
    return jm, tm, jtok, ttok


class _EncodeOnly:
    def __init__(self, tok):
        self.encode = tok.encode


def _pipes(setup, buckets=(16, 32), **cfg):
    jm, tm, jtok, ttok = setup
    return (JaxPipeline(jm, jtok, JaxGenConfig(**cfg), seq_buckets=buckets),
            TextGenerationPipeline(tm, ttok, ptt.GenerationConfig(**cfg),
                                   seq_buckets=buckets))


def test_greedy_tokens_and_text_match_jax(setup):
    jpipe, tpipe = _pipes(setup, max_new_tokens=10, temperature=0.0)
    want = jpipe(PROMPTS)
    got = tpipe(PROMPTS)
    assert got == want
    assert tpipe(PROMPTS[2]) == jpipe(PROMPTS[2]) == want[2]
    # token level: a tokenizer without decode() makes both pipelines
    # return the new ids (cut at eos)
    jm, tm, jtok, ttok = setup
    cfg = dict(max_new_tokens=10, temperature=0.0)
    jids = JaxPipeline(jm, _EncodeOnly(jtok), JaxGenConfig(**cfg),
                       seq_buckets=(16, 32))(PROMPTS)
    tids = TextGenerationPipeline(tm, _EncodeOnly(ttok),
                                  ptt.GenerationConfig(**cfg),
                                  seq_buckets=(16, 32))(PROMPTS)
    assert tids == jids and all(len(t) == 10 for t in tids)


def test_eos_truncates_before_decoding_as_jax(setup):
    _, tm, _, ttok = setup
    prompt = ttok.encode(PROMPTS[0])
    out = tm.generate(torch.tensor([prompt]), config=ptt.GenerationConfig(
        max_new_tokens=10, temperature=0.0))
    new = out[0, len(prompt):].tolist()
    cut = next(k for k in range(1, len(new)) if new[k] not in new[:k])
    jpipe, tpipe = _pipes(setup, max_new_tokens=10, temperature=0.0,
                          eos_token_id=new[cut])   # a token this row emits
    got = tpipe(PROMPTS)
    assert got == jpipe(PROMPTS)
    assert got[0] == ttok.decode(new[:cut])


def test_special_token_prompts_and_longer_bucket_match_jax(setup):
    jpipe, tpipe = _pipes(setup, buckets=(8, 64), max_new_tokens=6,
                          temperature=0.0)
    prompts = ["<|endoftext|>The fox", "x" * 20 + "<pad> numbers"]
    assert tpipe(prompts) == jpipe(prompts)
    with pytest.raises(ValueError, match="largest bucket"):
        _pipes(setup, buckets=(4,))[1]("a much longer prompt than four")


def test_left_padded_row_equals_its_solo_run(setup):
    """Each row of a left-padded batch gives, token for token, what it
    gives alone (pad rows masked out of attention, RoPE per row)."""
    _, tm, _, ttok = setup
    cfg = ptt.GenerationConfig(max_new_tokens=8, temperature=0.0)
    encoded = [ttok.encode(p) for p in PROMPTS]
    solo = []
    for e in encoded:
        out = tm.generate(torch.tensor([e]), config=cfg)
        solo.append(out[0, len(e):].tolist())
    width = 32
    batch = torch.zeros((len(encoded), width), dtype=torch.long)
    starts = []
    for i, e in enumerate(encoded):
        batch[i, width - len(e):] = torch.tensor(e)
        starts.append(width - len(e))
    out = tm.generate(batch, prompt_start=torch.tensor(starts), config=cfg)
    for i, e in enumerate(encoded):
        assert out[i, width:].tolist() == solo[i], PROMPTS[i]
    tpipe = TextGenerationPipeline(tm, ttok, cfg, seq_buckets=(32,))
    assert tpipe(PROMPTS) == [ttok.decode(s, skip_special_tokens=True)
                              for s in solo]
