"""The port's GPT against the JAX package's, on the same weights.

The JAX model is built from its seed, its ``state_dict()`` crosses as
numpy through ``load_jax_state_dict``, and both run fp32 on the CPU (the
JAX side on its dense paths, the port on its kernels' plain versions):
logits with and without a cache, cache decode against the full forward,
greedy and beam ``generate()``, the weight-only ``Predictor`` at int8
and int4 (hidden 256, so every projection quantizes), speculative
generation, the ``Trainer`` (plain and ``recompute``) and the packed SFT
fallback. The refusals kept as JAX has them (a left-padded
``generate()``, a ``PagedEngine``) and the position clamp past
``max_position_embeddings`` are held too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import causal_lm_loss as jax_causal_lm_loss
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch.generation import (PagedEngine,
                                         ngram_speculative_generate,
                                         speculative_generate)
from paddle_tpu_torch.models import gpt_tiny

# fp32 logits: the same math, summed in another order by XLA and torch
ATOL_LOGITS = 1e-4
# loss histories over a few SGD steps, and the parameters after them
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5

# head_dim 64 at 128 positions: the flash route (its plain version here);
# hidden 256, so every projection fills a 128-row quant block
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            vocab_size=512, max_position_embeddings=256)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sd(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _pair(seed=0, **overrides):
    pt.seed(seed)
    jm = JaxGPT(jax_gpt_tiny(**overrides))
    jm.eval()
    tm = ptt.GPTForCausalLM(gpt_tiny(**overrides), device="cpu")
    ptt.load_jax_state_dict(tm, _sd(jm))
    return jm, tm


def _ids(b, s, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("overrides,seq", (
    (dict(), 16),
    (WIDE, 128),                                  # the flash route
    (dict(tie_word_embeddings=False), 16),
), ids=("tiny", "d64-flash", "untied"))
def test_logits_match_jax(overrides, seq):
    jm, tm = _pair(**overrides)
    ids = _ids(2, seq, jm.config.vocab_size)
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("index", ("int", "device", "per-row"))
def test_cache_logits_and_decode_match_jax(index):
    """A prefill of 8 tokens into a 16-long cache, then 4 one-token steps:
    each step's logits equal the JAX cached step's and the full
    forward's, at a Python int index, a 0-d device index and one index a
    row (the speculative programs' form)."""
    jm, tm = _pair(seed=1)
    ids = _ids(2, 12, 256, seed=2)
    full = np.asarray(jm(jnp.asarray(ids)))
    jc = jm.init_kv_caches(2, 16)
    ref, jc = jm(jnp.asarray(ids[:, :8]), kv_caches=jc, cache_index=0)
    tc = tm.init_kv_caches(2, 16)
    t = torch.from_numpy(ids).long()

    def at(i):
        if index == "int":
            return i
        if index == "device":
            return torch.tensor(i, dtype=torch.int32)
        return torch.tensor([i, i], dtype=torch.int32)

    with torch.no_grad():
        got, _ = tm(t[:, :8], kv_caches=tc, cache_index=at(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL_LOGITS, rtol=0)
    np.testing.assert_allclose(got.numpy(), full[:, :8], atol=ATOL_LOGITS,
                               rtol=0)
    for i in range(8, 12):
        ref, jc = jm(jnp.asarray(ids[:, i:i + 1]), kv_caches=jc,
                     cache_index=i)
        with torch.no_grad():
            got, _ = tm(t[:, i:i + 1], kv_caches=tc, cache_index=at(i))
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref)[:, 0],
                                   atol=ATOL_LOGITS, rtol=0)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i],
                                   atol=ATOL_LOGITS, rtol=0)


def test_greedy_and_beam_generate_match_jax():
    jm, tm = _pair(seed=3, **WIDE)
    ids = _ids(2, 12, WIDE["vocab_size"], seed=4)
    t = torch.from_numpy(ids).long()
    for kw in (dict(max_new_tokens=10), dict(max_new_tokens=8, num_beams=3)):
        ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                      JaxGenConfig(**kw)))
        got = ptt.generate(tm, t, **kw)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(kw))


@pytest.mark.parametrize("bits", (8, 4))
def test_predictor_quant_tokens_match_jax(bits):
    """Both Predictors quantize the four biased projections of every
    layer (the tied head is not a Linear) and give the same greedy
    tokens."""
    jm, tm = _pair(seed=5, **WIDE)
    jp = JaxPredictor(jm, JaxConfig().enable_weight_only_quant(bits))
    tp = ptt.Predictor(tm, ptt.Config().enable_weight_only_quant(bits),
                       device="cpu")
    from paddle_tpu_torch.quant import QuantizedLinear
    n = sum(isinstance(m, QuantizedLinear) for m in tp.model.modules())
    assert n == 4 * WIDE.get("num_hidden_layers", 2)
    ids = _ids(2, 12, WIDE["vocab_size"], seed=6)
    ref = np.asarray(jp.generate(jnp.asarray(ids), max_new_tokens=10))
    got = tp.generate(torch.from_numpy(ids).long(), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_speculative_and_batching_on_gpt():
    """Draft-model and prompt-lookup speculative generation give the
    target's greedy tokens (the JAX package's, by the test above's
    check), and each ``BatchingPredictor`` answer (a bucketed
    ``Predictor.run``) is its row of the JAX forward's logits."""
    jm, tm = _pair(seed=7, **WIDE)
    draft = ptt.GPTForCausalLM(gpt_tiny(**dict(WIDE, num_hidden_layers=1)),
                               device="cpu",
                               generator=ptt.make_generator(8, "cpu"))
    pattern = _ids(1, 16, WIDE["vocab_size"], seed=9)
    ids = np.concatenate([np.tile(pattern, (1, 3)),
                          np.tile(pattern[:, ::-1], (1, 3))])
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=12)))
    t = torch.from_numpy(ids).long()
    got = speculative_generate(tm, draft, t, max_new_tokens=12,
                               num_draft_tokens=3)
    np.testing.assert_array_equal(got.numpy(), ref)
    got = ngram_speculative_generate(tm, t, max_new_tokens=12,
                                     num_draft_tokens=3, ngram=2)
    np.testing.assert_array_equal(got.numpy(), ref)
    bp = ptt.BatchingPredictor(tm, device="cpu", max_batch=4,
                               max_delay_ms=50)
    futs = [bp.submit(row) for row in ids]
    outs = [f.result(timeout=60) for f in futs]
    bp.close()
    whole = np.asarray(jm(jnp.asarray(ids)))
    for out, want in zip(outs, whole):
        np.testing.assert_allclose(np.asarray(out), want, atol=ATOL_LOGITS,
                                   rtol=0)


def test_positions_past_the_table_clamp_as_in_jax():
    """Past ``max_position_embeddings`` the JAX gather clamps to the last
    row: a forward at positions beyond the table and a ``generate()``
    whose total length passes it give the JAX results."""
    jm, tm = _pair(seed=10, max_position_embeddings=16)
    ids = _ids(2, 12, 256, seed=11)
    pos = np.tile(np.arange(10, 22, dtype=np.int32), (2, 1))
    ref = np.asarray(jm(jnp.asarray(ids), positions=jnp.asarray(pos)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(),
                 positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_LOGITS, rtol=0)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=10)))
    got = ptt.generate(tm, torch.from_numpy(ids).long(), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_refusals_kept_as_in_jax():
    """A left-padded ``generate()`` raises ``TypeError`` in both packages
    (the forward takes no ``attn_start``), while a batch without
    ``prompt_start`` serves; a ``PagedEngine`` refuses GPT (its attention
    unpacks the cache as a (k, v) pair). tp > 1 is no refusal: the fused
    qkv's weight and bias are split over tp by q, k and v apart
    (``tests/test_torch_tp_zoo.py`` holds GPT at tp 2)."""
    jm, tm = _pair(seed=12)
    ids = _ids(2, 8, 256, seed=13)
    start = np.array([0, 3], np.int32)
    with pytest.raises(TypeError, match="attn_start"):
        jax_generate(jm, jnp.asarray(ids), JaxGenConfig(max_new_tokens=2),
                     prompt_start=jnp.asarray(start))
    with pytest.raises(TypeError, match="attn_start"):
        ptt.generate(tm, torch.from_numpy(ids).long(), max_new_tokens=2,
                     prompt_start=torch.from_numpy(start))
    with pytest.raises(ValueError, match="PagedEngine"):
        PagedEngine(tm, max_slots=2, block_size=16, max_blocks_per_seq=4)
    import paddle_tpu_torch.models.gpt as gpt
    assert not hasattr(gpt, "refuse_tp")
    qkv = tm.model.layers[0].attn.qkv_proj
    assert qkv.weight.fused_parts == qkv.bias.fused_parts == 3


@pytest.mark.parametrize("recompute", (False, True))
def test_trainer_matches_jax(tmp_path, recompute):
    """SGD through both Trainers (the default causal-LM loss) from the
    same weights and batches for 3 steps: the loss histories within 1e-4
    relative, every parameter after them within 1e-5 (SGD: an update
    linear in the gradient, where AdamW's sign of a near-zero moment
    would amplify fp32 noise); ``recompute`` replays each layer in the
    backward in both packages."""
    jm, tm = _pair(seed=14, recompute=recompute)
    rs = np.random.RandomState(15)
    batches = [rs.randint(0, 256, (4, 16)).astype(np.int32)
               for _ in range(2)]
    kw = dict(max_steps=3, logging_steps=1)
    jtr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=0.5),
                     JaxArgs(output_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=False, **kw),
                     train_dataloader=[jnp.asarray(x) for x in batches])
    jtr.train()
    ttr = ptt.Trainer(tm, ptt.optimizer.SGD(learning_rate=0.5),
                      ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                            graceful_shutdown=False, **kw),
                      train_dataloader=batches)
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)
    assert got[-1] < got[0]
    ref = ptt.GPTForCausalLM(gpt_tiny(), device="cpu")
    ptt.load_jax_state_dict(ref, {k: np.asarray(v)
                                  for k, v in jtr._params.items()})
    want = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=ATOL_PARAMS, rtol=0, err_msg=name)


def test_causal_lm_loss_on_gpt_matches_jax():
    jm, tm = _pair(seed=16)
    ids = _ids(2, 16, 256, seed=17)
    ref = float(jax_causal_lm_loss(jm(jnp.asarray(ids)), jnp.asarray(ids)))
    t = torch.from_numpy(ids).long()
    with torch.no_grad():
        got = float(ptt.causal_lm_loss(tm(t), t))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_packed_sft_fallback_matches_jax(tmp_path):
    """GPT's forward has no ``segment_ids``: ``SFTTrainer`` takes the
    explicit block-causal mask in both packages (the JAX
    ``tests/test_trl.py`` case), and the loss histories agree."""
    from paddle_tpu.trl import DataCollatorForSFT as JaxCollator
    from paddle_tpu.trl import SFTTrainer as JaxSFT
    from paddle_tpu_torch.trl import DataCollatorForSFT, SFTTrainer
    jm, tm = _pair(seed=18)
    rs = np.random.RandomState(6)
    examples = [{"prompt_ids": rs.randint(1, 256, 4).tolist(),
                 "response_ids": rs.randint(1, 256, 6).tolist()}
                for _ in range(4)]
    jbatch = JaxCollator(max_length=24, packing=True)(examples)
    tbatch = DataCollatorForSFT(max_length=24, packing=True)(examples)
    np.testing.assert_array_equal(np.asarray(tbatch["segment_ids"]),
                                  np.asarray(jbatch["segment_ids"]))
    kw = dict(max_steps=4, logging_steps=1)
    jtr = JaxSFT(jm, pt.optimizer.AdamW(learning_rate=1e-2),
                 JaxArgs(output_dir=str(tmp_path / "jax"),
                         resume_from_checkpoint=False, **kw),
                 train_dataloader=[jbatch])
    jtr.train()
    ttr = SFTTrainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2),
                     ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                           graceful_shutdown=False, **kw),
                     train_dataloader=[tbatch])
    ttr.train()
    want = [v for _, v in jtr.logger.history["loss"]]
    got = [v for _, v in ttr.logger.history["loss"]]
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS, atol=0)
    assert got[-1] < got[0]
