"""The port's ``generate()``, sampling and ``Predictor`` against the JAX
package's, on the same weights (fp32, CPU).

Greedy streams must be identical token for token. Sampled streams cannot
be: JAX's threefry keys have no torch counterpart. They are held to the
reference through the shared filters (``top_k_filter`` / ``top_p_filter``
masks on the same logits) and to themselves through determinism under
one seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation import sampling as jax_sampling
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import sampling


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
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


def _ids(b, s, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(repetition_penalty=1.3),
    dict(no_repeat_ngram_size=2),
    dict(min_new_tokens=4, eos_token_id=5),
], ids=["greedy", "rep-penalty", "no-repeat-ngram", "min-new-eos"])
def test_greedy_matches_jax(pair, kw):
    jm, tm = pair
    ids = _ids(3, 10, seed=1)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=8, **kw)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(max_new_tokens=8, **kw))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("min_new", [0, 4])
def test_eos_stops_and_pads_like_jax(pair, min_new):
    """An eos taken from the greedy stream itself, so rows finish early
    (or, under min_new_tokens, are kept from finishing) and pad after."""
    jm, tm = pair
    ids = _ids(2, 8, seed=4)
    free = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                   JaxGenConfig(max_new_tokens=10)))
    eos = int(free[0, 8 + 2])
    cfg = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=3,
               min_new_tokens=min_new)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(**cfg)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), ref)
    if not min_new:
        assert (got[0, 8 + 3:] == 3).all()


@pytest.mark.parametrize("kw", [dict(), dict(repetition_penalty=1.5,
                                             no_repeat_ngram_size=2)],
                         ids=["greedy", "processors"])
def test_left_padded_prompt_start_matches_jax(pair, kw):
    """Left-padded rows (``prompt_start``) take the masked dense route in
    both packages, kernels bypassed."""
    jm, tm = pair
    ids = _ids(2, 12, seed=2)
    start = np.array([0, 5], np.int32)
    ids[1, :5] = 0
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=6, **kw),
                                  prompt_start=jnp.asarray(start)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(max_new_tokens=6, **kw),
                       prompt_start=torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_filters_match_jax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(4, 64) * 3).astype(np.float32)
    t = torch.from_numpy(logits)
    for k in (1, 5, 64):
        np.testing.assert_array_equal(
            sampling.top_k_filter(t, k).numpy(),
            np.asarray(jax_sampling.top_k_filter(jnp.asarray(logits), k)))
    for p in (0.1, 0.9, 0.999):
        np.testing.assert_array_equal(
            sampling.top_p_filter(t, p).numpy() > -1e29,
            np.asarray(jax_sampling.top_p_filter(jnp.asarray(logits), p))
            > -1e29)
    seen = rs.rand(4, 64) > 0.5
    np.testing.assert_allclose(
        sampling.repetition_penalty(t, torch.from_numpy(seen), 1.7).numpy(),
        np.asarray(jax_sampling.repetition_penalty(jnp.asarray(logits),
                                                   jnp.asarray(seen), 1.7)),
        rtol=1e-6)


@pytest.mark.parametrize("cur,g", [(9, 2), (9, 0), (3, 4), (12, 3)])
def test_suffix_window_hits_match_jax(cur, g):
    seq = np.array([1, 2, 1, 2, 3, 1, 2, 1, 2, 0, 0, 0, 0, 0], np.int32)
    ref = np.asarray(jax_sampling.suffix_window_hits(jnp.asarray(seq),
                                                     jnp.int32(cur), g))
    got = sampling.suffix_window_hits(torch.from_numpy(seq), cur, g)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampling_is_seeded_and_stays_in_the_filter(pair):
    _, tm = pair
    ids = torch.from_numpy(_ids(2, 8, seed=5))
    cfg = ptt.GenerationConfig(max_new_tokens=6, do_sample=True,
                               temperature=0.8, top_k=4, top_p=0.95)

    def run(seed):
        return ptt.generate(tm, ids, cfg,
                            generator=ptt.make_generator(seed, "cpu"))

    a, b = run(11), run(11)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(12)) or not torch.equal(a, run(13))
    # every sampled token sits in the top-4 of the logits that chose it
    with torch.no_grad():
        logits = tm(a[:, :-1])
    for pos in range(8, 14):
        top = torch.topk(logits[:, pos - 1], 4).indices
        assert (top == a[:, pos:pos + 1]).any(dim=1).all()


def test_predictor_generate_pads_to_bucket_and_crops(pair):
    _, tm = pair
    pred = ptt.Predictor(tm, device="cpu")
    ids = torch.from_numpy(_ids(3, 10, seed=6))
    cfg = ptt.GenerationConfig(max_new_tokens=5)
    got = pred.generate(ids, config=cfg)
    assert got.shape == (3, 15)
    padded = torch.cat([ids, ids[-1:]])                 # bucket 4
    np.testing.assert_array_equal(got.numpy(),
                                  ptt.generate(tm, padded, cfg)[:3].numpy())
    start = torch.tensor([0, 2, 0])
    got = pred.generate(ids, config=cfg, prompt_start=start)
    ref = ptt.generate(tm, padded, cfg,
                       prompt_start=torch.tensor([0, 2, 0, 0]))[:3]
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_predictor_run_crops_bucket_padding(pair):
    _, tm = pair
    pred = ptt.Predictor(tm, ptt.Config().set_batch_buckets([4, 8]),
                         device="cpu")
    ids = _ids(3, 6, seed=7)
    out = pred.run(ids)
    assert out.shape == (3, 6, 256)
    with torch.no_grad():
        ref = tm(torch.from_numpy(ids))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_generate_rejects_bad_configs(pair):
    _, tm = pair
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="repetition_penalty"):
        ptt.generate(tm, ids, repetition_penalty=0.0)
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        ptt.generate(tm, ids, no_repeat_ngram_size=-1)
    with pytest.raises(NotImplementedError, match="beam"):
        ptt.generate(tm, ids, num_beams=2)
