"""The port's beam search against the JAX package's ``beam_search``, on
the same weights (fp32, CPU).

Token ids must be identical. The JAX function returns tokens only, so
scores are compared through the returned sequences: each package
re-scores its own best sequences by one forward (the sum of the
generated tokens' log-probabilities), within 1e-4 in fp32 (the sums run
over at most 10 positions of [-6, 0] log-probs, through matmuls summed in
another order). ``test_beam_search_beats_greedy_logprob`` fails in the
reference itself and is no parity target here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import beam_search as jax_beam_search
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import beam_search

TOL_SCORE = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(
        np.int32)


def _jax_score(jm, seq, prompt_len):
    logits = np.asarray(jm(jnp.asarray(seq)), np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    pos = np.arange(prompt_len, seq.shape[1])
    return lp[:, pos - 1][np.arange(seq.shape[0])[:, None],
                          np.arange(len(pos))[None, :],
                          seq[:, pos]].sum(-1)


def _torch_score(tm, seq, prompt_len):
    with torch.no_grad():
        lp = torch.log_softmax(tm(torch.from_numpy(seq)).float(), -1)
    pos = torch.arange(prompt_len, seq.shape[1])
    tok = torch.from_numpy(seq[:, prompt_len:]).long()
    return lp[:, pos - 1].gather(-1, tok[..., None])[..., 0].sum(-1).numpy()


@pytest.mark.parametrize("k,kw", [
    (1, dict()),
    (4, dict()),
    (4, dict(length_penalty=1.2)),
    (3, dict(length_penalty=0.5)),
], ids=["k1", "k4", "k4-lp1.2", "k3-lp0.5"])
def test_beam_tokens_and_scores_match_jax(pair, k, kw):
    jm, tm = pair
    ids = _ids(2, 7, seed=40 + k)
    jcfg = JaxGenConfig(max_new_tokens=8, num_beams=k, **kw)
    ref = np.asarray(jax_beam_search(jm, jnp.asarray(ids), jcfg))
    got = beam_search(tm, torch.from_numpy(ids),
                      ptt.GenerationConfig(max_new_tokens=8, num_beams=k,
                                           **kw))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(_torch_score(tm, got.numpy(), 7),
                               _jax_score(jm, ref, 7), atol=TOL_SCORE,
                               rtol=0)


@pytest.mark.parametrize("kw", [
    dict(repetition_penalty=1.5),
    dict(no_repeat_ngram_size=2),
    dict(min_new_tokens=5),
    dict(length_penalty=1.2),
    dict(length_penalty=0.0, repetition_penalty=1.3,
         no_repeat_ngram_size=3),
], ids=["rep-penalty", "no-repeat-ngram", "min-new-eos", "eos-lp1.2",
        "all-processors"])
def test_beam_with_eos_and_processors_matches_jax(pair, kw):
    """With an eos from the greedy stream, beams finish at different
    steps (their scores freeze, their lengths differ, so the length
    penalty decides), through ``generate(num_beams=4)``."""
    jm, tm = pair
    ids = _ids(2, 6, seed=47)
    free = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                   JaxGenConfig(max_new_tokens=9)))
    eos = int(free[0, 6 + 2])
    jcfg = JaxGenConfig(max_new_tokens=9, num_beams=4, eos_token_id=eos,
                        pad_token_id=0, **kw)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids), jcfg))
    got = ptt.generate(tm, torch.from_numpy(ids), ptt.GenerationConfig(
        max_new_tokens=9, num_beams=4, eos_token_id=eos, pad_token_id=0,
        **kw))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_beam_rejects_prompt_start(pair):
    """As in the JAX package: beams neither mask a pad prefix nor keep it
    out of the processors, so left-padded batches are refused."""
    _, tm = pair
    ids = torch.from_numpy(_ids(2, 6, seed=48))
    with pytest.raises(NotImplementedError, match="prompt_start"):
        ptt.generate(tm, ids, num_beams=2, max_new_tokens=3,
                     prompt_start=torch.tensor([0, 2]))


def test_beam_program_reused_and_repeats(pair):
    """The second call reuses the beam program (its buffers gathered in
    place by every step) and gives the same tokens."""
    _, tm = pair
    ids = torch.from_numpy(_ids(2, 6, seed=49))
    cfg = ptt.GenerationConfig(max_new_tokens=6, num_beams=3)
    a = ptt.generate(tm, ids, cfg)
    n = len(tm._gen_exec_cache.programs)
    b = ptt.generate(tm, ids, cfg)
    assert len(tm._gen_exec_cache.programs) == n
    assert torch.equal(a, b)
