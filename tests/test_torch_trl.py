"""The port's SFT, DPO and chat templates (``paddle_tpu_torch.trl``,
``paddle_tpu_torch.tokenizer``) against the JAX package's.

Every case of the JAX package's ``tests/test_trl.py`` has its
counterpart, held against the JAX function on the same numpy inputs (fp32
on the CPU, ``llama_tiny`` weights carried by ``load_jax_state_dict``):
the masked SFT loss, the collators (padded and packed, ``pack_rows``),
``packed_sft_inputs``, the packed forward against lone forwards (on the
segment route and on the mask route), the boundary targets, SFTTrainer
padded, packed, packed through the flash route and packed on a model
whose forward takes no ``segment_ids`` (the mask fallback; the JAX test
runs it on GPT, which the port lacks, so both sides use a Llama
wrapper), DPO's loss, log-probs and Trainer, and the chat templates."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import trl as jtrl
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn.layer import Layer as JaxLayer
from paddle_tpu.tokenizer import chat as jchat
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from paddle_tpu_torch import trl
from paddle_tpu_torch.tokenizer import (CHAT_TEMPLATES, apply_chat_template,
                                        render_chat_template)

# fp32 losses and log-probs: the same sums in another order
RTOL_FP32 = 1e-5
# logits of a 2-layer fp32 model
ATOL_LOGITS = 1e-4
# loss histories of a few fp32 AdamW steps
RTOL_LOSS = 1e-4
# the flash route: JAX's Pallas kernel in interpret mode against the
# port's plain flash formula, fp32, over 2 steps
RTOL_LOSS_FLASH = 1e-4
FLASH_CFG = dict(hidden_size=256, num_attention_heads=4,
                 num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _no_cache_writes():
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


def _np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


def _pair(seed=0, **cfg):
    pt.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**cfg))
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**cfg), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return jm, tm


def _port_args(tmp_path, **kw):
    return ptt.TrainingArguments(output_dir=str(tmp_path / "port"),
                                 graceful_shutdown=False, logging_steps=1,
                                 **kw)


def _jax_args(tmp_path, **kw):
    return JaxArgs(output_dir=str(tmp_path / "jax"), logging_steps=1,
                   resume_from_checkpoint=False, **kw)


def _losses(tr):
    return [v for _, v in tr.logger.history["loss"]]


def _examples(seed, n, prompt=4, resp=6):
    rs = np.random.RandomState(seed)
    return [{"prompt_ids": rs.randint(1, 256, prompt).tolist(),
             "response_ids": rs.randint(1, 256, resp).tolist()}
            for _ in range(n)]


def _to_jax(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


# ----------------------------------------------------------------- SFT
def test_sft_loss_masks_prompt_as_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 8, 16).astype(np.float32)
    ids = rs.randint(0, 16, (2, 8))
    masks = [np.ones((2, 8), np.int64), np.zeros((2, 8), np.int64)]
    masks[1][0, 5] = 1
    for mask in masks:
        got = float(trl.sft_loss(torch.from_numpy(logits),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(mask)))
        want = float(jtrl.sft_loss(jnp.asarray(logits), jnp.asarray(ids),
                                   jnp.asarray(mask)))
        assert got == pytest.approx(want, rel=RTOL_FP32)
    # one position isolates that token's log-prob
    lp = jax.nn.log_softmax(jnp.asarray(logits[:, :-1]), axis=-1)
    assert got == pytest.approx(-float(lp[0, 4, ids[0, 5]]), rel=RTOL_FP32)


def test_sft_collator_padded_as_jax():
    ex = [{"prompt_ids": [1, 2, 3], "response_ids": [4, 5]},
          {"prompt_ids": [6], "response_ids": list(range(20))}]
    for mask_prompt in (True, False):
        got = trl.DataCollatorForSFT(max_length=10, pad_token_id=9,
                                     mask_prompt=mask_prompt)(ex)
        want = jtrl.DataCollatorForSFT(max_length=10, pad_token_id=9,
                                       mask_prompt=mask_prompt)(ex)
        assert set(got) == set(want) == {"input_ids", "loss_mask"}
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        trl.DataCollatorForSFT(max_length=10, pad_token_id=9)(ex)[
            "loss_mask"][0].numpy(), [0, 0, 0, 1, 1, 0, 0, 0, 0, 0])


def test_sft_collator_packs_and_segments_as_jax():
    ex = [{"prompt_ids": [1, 2], "response_ids": [3, 4]},
          {"prompt_ids": [5], "response_ids": [6, 7, 8]},
          {"prompt_ids": [9], "response_ids": [10, 11]},
          {"prompt_ids": [12] * 8, "response_ids": [13] * 3}]
    got = trl.DataCollatorForSFT(max_length=12, packing=True)(ex)
    want = jtrl.DataCollatorForSFT(max_length=12, packing=True)(ex)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    segs = got["segment_ids"].numpy()
    assert got["input_ids"].shape[0] == 2
    np.testing.assert_array_equal(
        segs[0], [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 0])
    assert got["segment_ids"].dtype == torch.int32


def test_sft_pack_rows_fixed_shape():
    coll = trl.DataCollatorForSFT(max_length=8, packing=True, pack_rows=3)
    jcoll = jtrl.DataCollatorForSFT(max_length=8, packing=True, pack_rows=3)
    small = [{"prompt_ids": [1], "response_ids": [2, 3]}]
    for ex in (small, small * 5):
        got = coll(ex)
        assert tuple(got["input_ids"].shape) == (3, 8)
        np.testing.assert_array_equal(got["segment_ids"].numpy(),
                                      np.asarray(jcoll(ex)["segment_ids"]))
    with pytest.raises(ValueError, match="pack_rows"):
        coll(small * 12)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_packed_sft_inputs_positions_and_mask_as_jax(seed):
    """Positions and the block-causal mask of random packings (pads,
    segments of length 1, a row of one segment) equal JAX's."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(3):
        lens = rs.randint(1, 6, rs.randint(1, 4))
        row = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lens)])
        rows.append(np.pad(row, (0, 20 - len(row)))[:20])
    seg = np.stack(rows)
    pos, attn = trl.packed_sft_inputs(torch.from_numpy(seg))
    jpos, jattn = jtrl.packed_sft_inputs(jnp.asarray(seg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(jattn))
    p2, none = trl.packed_sft_inputs(torch.from_numpy(seg), with_mask=False)
    assert none is None and torch.equal(p2, pos)
    small, a = trl.packed_sft_inputs(torch.tensor([[1, 1, 1, 2, 2, 0]]))
    np.testing.assert_array_equal(small[0].numpy(), [0, 1, 2, 0, 1, 0])
    a = a[0, 0].numpy()
    assert a[1, 0] and not a[0, 1] and a[4, 3] and not a[3, 1]
    assert not a[5, 4] and a[5, 5]


@pytest.mark.parametrize("route", ("segments", "mask"))
def test_packed_logits_equal_lone_forwards(route):
    """Each packed example's logits equal its forward alone (the same
    positions, nothing leaks across segments), through ``segment_ids``
    and through the explicit mask; the packed logits equal JAX's."""
    jm, tm = _pair(3)
    rs = np.random.RandomState(3)
    a, b = rs.randint(1, 256, 5), rs.randint(1, 256, 4)
    packed = np.zeros((1, 12), np.int64)
    packed[0, :5], packed[0, 5:9] = a, b
    seg = np.zeros((1, 12), np.int64)
    seg[0, :5], seg[0, 5:9] = 1, 2
    pos, attn = trl.packed_sft_inputs(torch.from_numpy(seg))
    with torch.no_grad():
        if route == "segments":
            lp = tm(torch.from_numpy(packed), positions=pos,
                    segment_ids=torch.from_numpy(seg))
        else:
            lp = tm(torch.from_numpy(packed), positions=pos, attn_mask=attn)
        la = tm(torch.from_numpy(a)[None])
        lb = tm(torch.from_numpy(b)[None])
    np.testing.assert_allclose(_np(lp[0, :5]), _np(la[0]), atol=2e-4)
    np.testing.assert_allclose(_np(lp[0, 5:9]), _np(lb[0]), atol=2e-4)
    fn, params = jm.functional()
    jpos, jattn = jtrl.packed_sft_inputs(jnp.asarray(seg))
    want = np.asarray(fn(dict(params), jnp.asarray(packed), positions=jpos,
                         attn_mask=jattn))
    np.testing.assert_allclose(_np(lp[0, :9]), want[0, :9],
                               atol=ATOL_LOGITS)


def test_sft_boundary_targets_dropped_as_jax():
    rs = np.random.RandomState(5)
    logits = rs.randn(1, 6, 16).astype(np.float32)
    ids = rs.randint(0, 16, (1, 6))
    seg = np.array([[1, 1, 1, 2, 2, 0]])
    mask = np.array([[1, 1, 1, 1, 1, 0]])
    got = float(trl.sft_loss(*(torch.from_numpy(v) for v in
                               (logits, ids, mask)),
                             segment_ids=torch.from_numpy(seg)))
    want = float(jtrl.sft_loss(*(jnp.asarray(v) for v in (logits, ids, mask)),
                               segment_ids=jnp.asarray(seg)))
    assert got == pytest.approx(want, rel=RTOL_FP32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), axis=-1))
    manual = -(lp[0, ids[0, 1]] + lp[1, ids[0, 2]] + lp[3, ids[0, 4]]) / 3
    assert got == pytest.approx(float(manual), rel=RTOL_FP32)


def _sft_runs(tmp_path, batch_fn, steps, cfg=None, wrap=None):
    """Both SFTTrainers (full fine-tune, AdamW 1e-2) on one batch."""
    cfg = cfg or {}
    jm, tm = _pair(0, **cfg)
    if wrap is not None:
        jm, tm = wrap(jm, tm)
    tb = batch_fn(trl)
    with _no_cache_writes():
        jtr = jtrl.SFTTrainer(jm, pt.optimizer.AdamW(learning_rate=1e-2),
                              _jax_args(tmp_path, max_steps=steps),
                              train_dataloader=[_to_jax(tb)])
        jtr.train()
    tr = trl.SFTTrainer(tm, ptt.optimizer.AdamW(learning_rate=1e-2),
                        _port_args(tmp_path, max_steps=steps),
                        train_dataloader=[tb])
    tr.train()
    return _losses(tr), _losses(jtr)


def test_sft_trainer_padded_matches_jax(tmp_path):
    """Padded SFT, 4 steps: loss histories within RTOL_LOSS, falling."""
    ex = _examples(0, 4, 6, 8)
    got, want = _sft_runs(
        tmp_path, lambda m: m.DataCollatorForSFT(max_length=16)(ex), 4)
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)
    assert got[-1] < got[0]


def test_sft_trainer_packed_matches_jax(tmp_path):
    """Packed SFT (dense segment route: 24 positions), 4 steps."""
    ex = _examples(4, 6)
    got, want = _sft_runs(tmp_path, lambda m: m.DataCollatorForSFT(
        max_length=24, packing=True)(ex), 4)
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)
    assert got[-1] < got[0]


def test_sft_trainer_packed_flash_route_matches_jax(tmp_path, monkeypatch):
    """Packed rows of 128 positions at head_dim 64 take the flash route
    with segments on both sides (JAX's Pallas kernel in interpret mode,
    the port's FlashAttentionFunction, whose plain version runs on CPU
    tensors): 2 steps within RTOL_LOSS_FLASH."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    ex = _examples(6, 7, 8, 24)
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    calls = []
    real = fa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(kw.get("segment_ids") is not None)
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    got, want = _sft_runs(tmp_path, lambda m: m.DataCollatorForSFT(
        max_length=128, packing=True, pack_rows=2)(ex), 2, cfg=FLASH_CFG)
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS_FLASH)
    assert calls and all(calls)


class _JaxNoSeg(JaxLayer):
    """A JAX Llama wrapper whose forward has no ``segment_ids``."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, input_ids, positions=None, attn_mask=None):
        return self.inner(input_ids, positions=positions, attn_mask=attn_mask)


class _NoSeg(torch.nn.Module):
    """The port's counterpart."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, input_ids, positions=None, attn_mask=None):
        return self.inner(input_ids, positions=positions, attn_mask=attn_mask)


def test_sft_packed_mask_fallback_matches_jax(tmp_path):
    """A model whose forward takes no ``segment_ids`` gets the explicit
    block-causal mask (``packed_sft_inputs``) on both sides; 4 steps of
    packed SFT within RTOL_LOSS, falling."""
    assert not trl._model_takes_segment_ids(_NoSeg(torch.nn.Linear(1, 1)))
    ex = _examples(6, 4)
    got, want = _sft_runs(
        tmp_path, lambda m: m.DataCollatorForSFT(max_length=24,
                                                 packing=True)(ex), 4,
        wrap=lambda jm, tm: (_JaxNoSeg(jm), _NoSeg(tm)))
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)
    assert got[-1] < got[0]


# ----------------------------------------------------------------- DPO
def test_dpo_loss_as_jax():
    rs = np.random.RandomState(0)
    vals = [rs.randn(4).astype(np.float32) for _ in range(4)]
    for beta, ls in ((0.1, 0.0), (0.5, 0.1)):
        got = trl.dpo_loss(*(torch.from_numpy(v) for v in vals), beta=beta,
                           label_smoothing=ls)
        want = jtrl.dpo_loss(*(jnp.asarray(v) for v in vals), beta=beta,
                             label_smoothing=ls)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    z = torch.zeros(4)
    loss, _, _ = trl.dpo_loss(z, z, z, z, beta=0.1)
    assert float(loss) == pytest.approx(np.log(2.0), rel=1e-6)
    better, _, _ = trl.dpo_loss(z + 1.0, z, z, z, beta=0.1)
    assert float(better) < float(loss)


def test_dpo_sequence_logps_as_jax():
    """``sequence_logps`` and ``compute_sequence_logps`` (eval mode, no
    grad, in slices of 2 rows) equal JAX's; the model's mode comes back."""
    jm, tm = _pair(1)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 256, (3, 12))
    mask = (rs.rand(3, 12) > 0.3).astype(np.int64)
    tm.train()
    pre = trl.compute_sequence_logps(tm, ids, mask, batch_size=2)
    assert tm.training and not pre.requires_grad
    with torch.no_grad():
        direct = trl.sequence_logps(tm(torch.from_numpy(ids)),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(_np(pre), _np(direct), rtol=1e-6)
    want = jtrl.compute_sequence_logps(jm, jnp.asarray(ids),
                                       jnp.asarray(mask), batch_size=2)
    np.testing.assert_allclose(_np(pre), np.asarray(want), rtol=RTOL_FP32)
    assert (_np(pre) <= 0).all()


def test_dpo_trainer_matches_jax(tmp_path):
    """3 DPOTrainer steps: the reference log-probs computed first, then
    the losses within RTOL_LOSS of the JAX trainer's (the first at ln 2
    within 1e-6), and after them the policy prefers the chosen rows."""
    jm, tm = _pair(2)
    rs = np.random.RandomState(2)
    chosen = rs.randint(1, 256, (4, 12))
    rejected = rs.randint(1, 256, (4, 12))
    mask = np.ones((4, 12), np.int64)
    ref_c = trl.compute_sequence_logps(tm, chosen, mask)
    ref_r = trl.compute_sequence_logps(tm, rejected, mask)
    batch = {"chosen_ids": torch.from_numpy(chosen),
             "chosen_mask": torch.from_numpy(mask),
             "rejected_ids": torch.from_numpy(rejected),
             "rejected_mask": torch.from_numpy(mask),
             "ref_chosen_logps": ref_c, "ref_rejected_logps": ref_r}
    with _no_cache_writes():
        jref_c = jtrl.compute_sequence_logps(jm, jnp.asarray(chosen),
                                             jnp.asarray(mask))
        jref_r = jtrl.compute_sequence_logps(jm, jnp.asarray(rejected),
                                             jnp.asarray(mask))
        np.testing.assert_allclose(_np(ref_c), np.asarray(jref_c),
                                   rtol=RTOL_FP32)
        jbatch = {"chosen_ids": jnp.asarray(chosen),
                  "chosen_mask": jnp.asarray(mask),
                  "rejected_ids": jnp.asarray(rejected),
                  "rejected_mask": jnp.asarray(mask),
                  "ref_chosen_logps": jref_c, "ref_rejected_logps": jref_r}
        jtr = jtrl.DPOTrainer(jm, pt.optimizer.AdamW(learning_rate=5e-3),
                              _jax_args(tmp_path, max_steps=3), beta=0.1,
                              train_dataloader=[jbatch])
        jtr.train()
    tr = trl.DPOTrainer(tm, ptt.optimizer.AdamW(learning_rate=5e-3),
                        _port_args(tmp_path, max_steps=3), beta=0.1,
                        train_dataloader=[batch])
    tr.train()
    got, want = _losses(tr), _losses(jtr)
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)
    assert got[0] == pytest.approx(np.log(2.0), abs=1e-6)
    assert got[-1] < got[0]
    pc = trl.compute_sequence_logps(tm, chosen, mask)
    pr = trl.compute_sequence_logps(tm, rejected, mask)
    assert float((pc - ref_c).mean() - (pr - ref_r).mean()) > 0


# ------------------------------------------------------- chat templates
MSGS = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
        {"role": "assistant", "content": "ok"},
        {"role": "tool", "content": "x"}]


@pytest.mark.parametrize("template", sorted(jchat.CHAT_TEMPLATES))
def test_chat_template_renders_as_jax(template):
    assert sorted(CHAT_TEMPLATES) == sorted(jchat.CHAT_TEMPLATES)
    for gen in (True, False):
        for msgs in (MSGS, MSGS[:2]):
            assert render_chat_template(msgs, template, gen) == \
                jchat.render_chat_template(msgs, template, gen)


def test_chat_template_shapes_and_errors():
    s = render_chat_template(MSGS[:2], "llama3")
    assert s.startswith("<|begin_of_text|>")
    assert "<|start_header_id|>system<|end_header_id|>\n\nbe brief" in s
    assert s.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert render_chat_template(MSGS[:2], "qwen2",
                                add_generation_prompt=False) == (
        "<|im_start|>system\nbe brief<|im_end|>\n"
        "<|im_start|>user\nhi<|im_end|>\n")
    with pytest.raises(KeyError, match="unknown chat template"):
        render_chat_template(MSGS, "nope")
    with pytest.raises(ValueError, match="role"):
        render_chat_template([{"content": "x"}], "llama3")


def test_apply_chat_template_with_tokenizer_as_jax():
    class Tok:
        def encode(self, text):
            return [ord(c) % 97 for c in text[:5]]

    for tokenize in (True, False):
        assert apply_chat_template(Tok(), MSGS[:2], "chatml",
                                   tokenize=tokenize) == \
            jchat.apply_chat_template(Tok(), MSGS[:2], "chatml",
                                      tokenize=tokenize)
    assert len(apply_chat_template(Tok(), MSGS[:2], "chatml")) == 5
