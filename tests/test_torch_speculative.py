"""The port's speculative decoding against the JAX package's, on the same
weights (fp32, CPU): ``speculative_generate`` (a draft model) and
``ngram_speculative_generate`` (prompt lookup) on Llama, and
``mtp_speculative_generate`` (the model's own MTP module drafting) on
DeepSeek-V3-style models, the cases of ``tests/test_speculative.py``.

Greedy: token ids identical to JAX's speculative output and to greedy
``generate`` in both packages, target forwards equal to JAX's. Sampled
prompt lookup cannot match JAX's threefry draws; it is held to the port's
own sampled ``generate`` with the same key rows (bit for bit on these
weights), to its seed, and to its filter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import mtp_speculative_generate as jax_mtp
from paddle_tpu.generation import ngram_speculative_generate as jax_ngram
from paddle_tpu.generation import speculative_generate as jax_spec
from paddle_tpu.models import DeepseekV2ForCausalLM as JaxDeepseek
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import deepseek_v2_tiny as jax_deepseek_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.generation import (mtp_speculative_generate,
                                         ngram_speculative_generate,
                                         speculative_generate)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(jm, **cfg):
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**cfg), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return tm


def _jax_models(head_scale=10.0):
    pt.seed(0)
    target = JaxLlama(jax_llama_tiny())
    # decisive logits, as in the JAX tests: the decode (q_len 1) and
    # verify (q_len k+1) paths differ by float epsilon
    target.lm_head.weight = target.lm_head.weight * head_scale
    pt.seed(99)      # a different (bad) draft: random init, half the size
    draft = JaxLlama(jax_llama_tiny(hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=1))
    return target, draft


@pytest.fixture(scope="module")
def models():
    jt, jd = _jax_models()
    return (jt, jd, _port(jt),
            _port(jd, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=1))


@pytest.fixture(scope="module")
def copier():
    """A target whose head is zero: every logit row is uniform, so greedy
    emits token 0 forever and prompt lookup accepts every draft."""
    jt, _ = _jax_models(head_scale=0.0)
    return jt, _port(jt)


def _prompt(seed=0, b=1, n=8):
    return np.random.RandomState(seed).randint(1, 256, (b, n)).astype(
        np.int32)


def _check(jax_out, port_out, jax_stats=None, port_stats=None):
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(jax_out))
    if jax_stats is not None:
        assert port_stats["target_forwards"] == (
            jax_stats["target_forwards"].tolist()
            if hasattr(jax_stats["target_forwards"], "tolist")
            else jax_stats["target_forwards"])


class TestSpeculative:
    @pytest.mark.parametrize("b,k,new,eos,seed", [
        (1, 4, 24, None, 0),
        (1, 3, 24, 7, 2),
        (3, 4, 16, None, 8),
        (4, 3, 20, 7, 9),
        (1, 1, 16, None, 3),
        (1, 6, 16, None, 3),
    ], ids=["bad-draft", "eos", "batched", "batched-eos", "k1", "k6"])
    def test_exact_and_equal_to_jax(self, models, b, k, new, eos, seed):
        """A random draft changes speed only: the output equals the
        target's own greedy decode, row by row, and JAX's speculative
        output, with the same target forwards per row."""
        jt, jd, tt, td = models
        ids = _prompt(seed, b)
        ref, rstats = jax_spec(jt, jd, jnp.asarray(ids), max_new_tokens=new,
                               num_draft_tokens=k, eos_token_id=eos,
                               return_stats=True)
        got, stats = speculative_generate(
            tt, td, torch.from_numpy(ids), max_new_tokens=new,
            num_draft_tokens=k, eos_token_id=eos, return_stats=True)
        _check(ref, got, rstats, stats)
        want = ptt.generate(tt, torch.from_numpy(ids), max_new_tokens=new,
                            eos_token_id=eos)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    @pytest.mark.parametrize("b", [1, 2])
    def test_perfect_draft_cuts_target_forwards(self, models, b):
        """Draft == target: every proposal accepted, ~(k+1) tokens per
        target forward instead of 1."""
        jt, _, tt, _ = models
        ids = _prompt(1 if b == 1 else 10, b)
        got, stats = speculative_generate(
            tt, tt, torch.from_numpy(ids), max_new_tokens=24,
            num_draft_tokens=4, return_stats=True)
        ref, rstats = jax_spec(jt, jt, jnp.asarray(ids), max_new_tokens=24,
                               num_draft_tokens=4, return_stats=True)
        _check(ref, got, rstats, stats)
        fwd = stats["target_forwards"]
        assert all(f <= 8 for f in (fwd if b > 1 else [fwd])), stats
        if b == 1:
            assert stats["tokens_per_forward"] > 2.5

    def test_program_cached_and_model_collectable(self, models):
        """The second call with the same (draft, shapes) reuses the
        program; dropping the models frees it."""
        import gc
        import weakref
        jt, jd, _, _ = models
        tt = _port(jt)
        td = _port(jd, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=1)
        ids = torch.from_numpy(_prompt(5))
        a = speculative_generate(tt, td, ids, max_new_tokens=8,
                                 num_draft_tokens=2)
        assert len(tt._gen_exec_cache.programs) == 1
        b = speculative_generate(tt, td, ids, max_new_tokens=8,
                                 num_draft_tokens=2)
        assert len(tt._gen_exec_cache.programs) == 1
        assert torch.equal(a, b)
        wr = weakref.ref(tt)
        del tt, td, a, b
        gc.collect()
        assert wr() is None

    def test_dropped_draft_is_freed_and_its_program_dropped(self, models):
        """The target's cached program holds the draft weakly: dropping
        the draft frees it, and the target's next call drops the stale
        program (and, asked again for that draft's key, rebuilds it)."""
        import gc
        import weakref
        jt, jd, _, _ = models
        tt = _port(jt)
        td = _port(jd, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=1)
        ids = torch.from_numpy(_prompt(5))
        want = speculative_generate(tt, td, ids, max_new_tokens=8,
                                    num_draft_tokens=2)
        prog = next(iter(tt._gen_exec_cache.programs.values()))
        assert not prog.stale()
        wr = weakref.ref(td)
        del td
        gc.collect()
        assert wr() is None and prog.stale()
        td = _port(jd, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=1)
        got = speculative_generate(tt, td, ids, max_new_tokens=8,
                                   num_draft_tokens=2)
        assert torch.equal(got, want)
        assert prog not in tt._gen_exec_cache.programs.values()
        assert len(tt._gen_exec_cache.programs) == 1

    def test_mtp_raises_until_its_models_are_ported(self, models):
        """A model without MTP depth modules (a Llama) raises the JAX
        package's ValueError; the DeepSeek models that have them are
        ported (``TestMTPSpeculative``)."""
        _, _, tt, _ = models
        with pytest.raises(ValueError, match="num_nextn"):
            mtp_speculative_generate(tt, torch.from_numpy(_prompt()),
                                     max_new_tokens=4)


def _mtp_pair(head_scale=10.0):
    """``deepseek_v2_tiny`` with one MTP module, as the JAX tests build
    it (lm_head x 10: decisive logits), in both packages."""
    pt.seed(0)
    jm = JaxDeepseek(jax_deepseek_tiny(num_nextn_predict_layers=1))
    jm.eval()
    jm.lm_head.weight = jm.lm_head.weight * head_scale
    tm = ptt.models.DeepseekV2ForCausalLM(
        ptt.models.deepseek_v2_tiny(num_nextn_predict_layers=1),
        device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


class TestMTPSpeculative:
    """MTP-as-draft self-speculation against the JAX package's
    ``mtp_speculative_generate``, the cases of its tests: the same token
    ids and target forwards, and the model's own greedy ``generate``."""

    @pytest.fixture(scope="class")
    def mtp(self):
        return _mtp_pair()

    @pytest.mark.parametrize("b,k,new,eos,seed", [
        (1, 3, 20, None, 21),
        (1, 3, 20, 7, 23),
        (2, 2, 16, None, 24),
    ], ids=["exact", "eos", "batched"])
    def test_exact_and_equal_to_jax(self, mtp, b, k, new, eos, seed):
        jm, tm = mtp
        ids = _prompt(seed, b)
        ref, rstats = jax_mtp(jm, jnp.asarray(ids), max_new_tokens=new,
                              num_draft_tokens=k, eos_token_id=eos,
                              return_stats=True)
        got, stats = mtp_speculative_generate(
            tm, torch.from_numpy(ids), max_new_tokens=new,
            num_draft_tokens=k, eos_token_id=eos, return_stats=True)
        _check(ref, got, rstats, stats)
        assert stats == {k_: (v.tolist() if hasattr(v, "tolist") else v)
                         for k_, v in rstats.items()}
        want = ptt.generate(tm, torch.from_numpy(ids), max_new_tokens=new,
                            eos_token_id=eos)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_forced_full_accept_cuts_forwards(self):
        """A zero head: target and draft both argmax to token 0, so every
        draft is accepted, ~(k+1) tokens a target forward."""
        jm, tm = _mtp_pair(head_scale=0.0)
        ids = _prompt(22)
        ref, rstats = jax_mtp(jm, jnp.asarray(ids), max_new_tokens=24,
                              num_draft_tokens=4, return_stats=True)
        got, stats = mtp_speculative_generate(
            tm, torch.from_numpy(ids), max_new_tokens=24,
            num_draft_tokens=4, return_stats=True)
        _check(ref, got, rstats, stats)
        assert stats["target_forwards"] <= 6
        assert stats["tokens_per_forward"] > 3.5

    def test_program_reused_and_bad_k_raises(self, mtp):
        """One program per shape, reused: a second call allocates nothing
        and gives the same tokens."""
        _, tm = mtp
        ids = torch.from_numpy(_prompt(25))
        a = mtp_speculative_generate(tm, ids, max_new_tokens=8)
        n = len(tm._gen_exec_cache.programs)
        b = mtp_speculative_generate(tm, ids, max_new_tokens=8)
        assert torch.equal(a, b) and len(tm._gen_exec_cache.programs) == n
        with pytest.raises(ValueError, match="num_draft_tokens"):
            mtp_speculative_generate(tm, ids, num_draft_tokens=0)


class TestNgramSpeculative:
    @pytest.mark.parametrize("b,k,new,eos,seed", [
        (1, 3, 20, None, 31),
        (1, 3, 20, 7, 33),
        (2, 2, 16, None, 34),
    ], ids=["exact", "eos", "batched"])
    def test_exact_and_equal_to_jax(self, models, b, k, new, eos, seed):
        jt, _, tt, _ = models
        ids = _prompt(seed, b)
        ref, rstats = jax_ngram(jt, jnp.asarray(ids), max_new_tokens=new,
                                num_draft_tokens=k, ngram=2,
                                eos_token_id=eos, return_stats=True)
        got, stats = ngram_speculative_generate(
            tt, torch.from_numpy(ids), max_new_tokens=new,
            num_draft_tokens=k, ngram=2, eos_token_id=eos,
            return_stats=True)
        _check(ref, got, rstats, stats)
        want = ptt.generate(tt, torch.from_numpy(ids), max_new_tokens=new,
                            eos_token_id=eos)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_repetitive_output_cuts_forwards(self, copier):
        jt, tt = copier
        ids = _prompt(32)
        got, stats = ngram_speculative_generate(
            tt, torch.from_numpy(ids), max_new_tokens=24,
            num_draft_tokens=4, ngram=2, return_stats=True)
        ref, rstats = jax_ngram(jt, jnp.asarray(ids), max_new_tokens=24,
                                num_draft_tokens=4, ngram=2,
                                return_stats=True)
        _check(ref, got, rstats, stats)
        assert stats["target_forwards"] <= 8, stats
        assert stats["tokens_per_forward"] >= 2.5, stats

    def test_prompt_with_repeats_drafts_from_prompt(self, copier):
        jt, tt = copier
        ids = np.array([[5, 9, 5, 9, 5, 9, 5, 9]], np.int32)
        got, stats = ngram_speculative_generate(
            tt, torch.from_numpy(ids), max_new_tokens=12,
            num_draft_tokens=3, return_stats=True)
        ref, rstats = jax_ngram(jt, jnp.asarray(ids), max_new_tokens=12,
                                num_draft_tokens=3, return_stats=True)
        _check(ref, got, rstats, stats)
        assert stats["target_forwards"] < 12, stats
        assert stats["tokens_per_forward"] > 1.5, stats

    def test_sampled_equals_sampled_generate_with_the_same_keys(
            self, models):
        """Each verify position draws with the key plain sampling uses
        for that token, so on these weights the sampled prompt-lookup
        stream is bit for bit the port's sampled ``generate`` with the
        same generator seed; a repeat is the same stream, another seed
        another, and every token lies in its top-k."""
        _, _, tt, _ = models
        ids = torch.from_numpy(_prompt(35, 2))
        kw = dict(temperature=0.9, top_k=8, top_p=0.95)

        def spec(seed):
            return ngram_speculative_generate(
                tt, ids, max_new_tokens=16, num_draft_tokens=3, ngram=2,
                generator=ptt.make_generator(seed, "cpu"), **kw)

        got = spec(3)
        plain = ptt.generate(tt, ids, max_new_tokens=16, do_sample=True,
                             generator=ptt.make_generator(3, "cpu"), **kw)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        assert torch.equal(got, spec(3))
        assert not torch.equal(got, spec(4))
        with torch.no_grad():
            logits = tt(got[:, :-1])
        for pos in range(8, 24):
            top = torch.topk(logits[:, pos - 1], 8).indices
            assert (top == got[:, pos:pos + 1]).any(dim=1).all()

    def test_sampled_at_top_k_1_is_greedy(self, models):
        """At top_k 1 the filtered distribution is one token, so the
        rejection-sampled verify accepts exactly what greedy would: the
        stream and its forward counts equal the greedy path's."""
        _, _, tt, _ = models
        ids = torch.from_numpy(_prompt(36, 2))
        got, stats = ngram_speculative_generate(
            tt, ids, max_new_tokens=16, num_draft_tokens=4, ngram=2,
            temperature=0.7, top_k=1, return_stats=True)
        want, wstats = ngram_speculative_generate(
            tt, ids, max_new_tokens=16, num_draft_tokens=4, ngram=2,
            return_stats=True)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert stats == wstats

    def test_rejects_bad_arguments(self, models):
        _, _, tt, _ = models
        ids = torch.from_numpy(_prompt(37))
        with pytest.raises(ValueError, match="num_draft_tokens"):
            ngram_speculative_generate(tt, ids, num_draft_tokens=0)
        with pytest.raises(ValueError, match="ngram"):
            ngram_speculative_generate(tt, ids, ngram=0)
        with pytest.raises(ValueError, match="num_draft_tokens"):
            speculative_generate(tt, tt, ids, num_draft_tokens=0)
