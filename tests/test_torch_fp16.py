"""fp16 through the port, held against the JAX package on the CPU.

The JAX package computes fp16 wherever it computes bf16: its attention
gates have no dtype term and its Pallas kernels compute in the inputs'
dtype with fp32 scores and accumulators. The port does the same: every
kernel wrapper and plain version takes fp16 and rounds where it rounds
for bf16 (p to V's type before P V, ds to q/k's type, the outputs once).

Each plain version is held against its Pallas kernel in interpret mode on
the same fp16 inputs (made from a seed with numpy); the Llama model, its
``generate``, the host-tick ``PagedEngine``, ``weight_only_linear`` and
``Predictor`` with ``Config().set_dtype("float16")`` against the JAX
package's, with weights carried across by ``load_jax_state_dict``.
``test_torch_kernels_gpu.py`` holds the CUDA kernels against the plain
versions in fp16 on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.generation import generate as jax_generate
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd,
                                                   flash_attention_bshd)
from paddle_tpu.ops.pallas.paged_attention import paged_attention_pallas
from paddle_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from paddle_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_attention_pallas
from paddle_tpu.quant import weight_only as jax_wo
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.ops.kernels.decode_attention import decode_attention_fwd
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttentionFunction, flash_attention_bwd, flash_attention_fwd,
    flash_route)
from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
    ragged_paged_attention
from paddle_tpu_torch.quant import quantize_blockwise, weight_only_linear

F16 = np.float16
# fp16 attention outputs (mostly of magnitude below 2): both sides form
# fp32 scores from the same fp16 values and round p to fp16 at the same
# point, but against another running max (online against whole-row), and
# sum in another order; then each rounds its output once to fp16. Two
# fp16 steps at magnitude 1-2 (2^-10 each); the cases here stay within one.
ATOL_ATTN = 2 * 2.0 ** -10
# fp16 gradients, relative to the largest reference gradient: ds is
# rounded to fp16 on both sides against another lse rounding; sums over
# up to 256 keys or 2 x 256 query rows in another order
RTOL_GRAD = 5e-3
# the quant matmul: both sides dequantize and sum in fp32 and round once
# to fp16, so two nearby fp32 sums may land one fp16 step apart
RTOL_QUANT = 2.0 ** -10
# fp16 logits of the tiny Llama, relative to the largest: both models
# round every activation to fp16, but XLA and torch fuse and order the
# fp32 sums inside each matmul and norm differently
RTOL_LOGITS = 5e-3
TINY = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------ plain versions
def _qkv(b, sq, sk, h, kv, d, seed=0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, sq, h, d) * 0.5).astype(F16)
    k = (rs.randn(b, sk, kv, d) * 0.5).astype(F16)
    v = rs.randn(b, sk, kv, d).astype(F16)
    g = rs.randn(b, sq, h, d).astype(F16)
    return q, k, v, g


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, :s // 3], seg[:, s // 3:s // 2], seg[:, s // 2:s - 8] = 1, 2, 3
    return seg


def _jax_flash(q, k, v, causal, window=None, seg=None):
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * kv, sk, d)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(b * kv, sk, d)
    out, lse = _flash_fwd(qf, kf, vf, 1.0 / np.sqrt(d), causal, 128, 128,
                          segment_ids=None if seg is None
                          else jnp.asarray(seg), heads=h, window=window)
    assert out.dtype == jnp.float16
    out = np.asarray(out).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse).reshape(b, h, sq)


FLASH_CASES = [dict(causal=True), dict(causal=False),
               dict(causal=True, window=40), dict(causal=True, seg=True),
               dict(causal=True, h=8)]
FLASH_IDS = ["causal", "full", "window", "segments", "group4"]


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_fp16_flash_fwd_plain_matches_pallas(pallas_interpret, case):
    q, k, v, _ = _qkv(2, 256, 256, case.get("h", 4), 2, 64)
    seg = _segments(2, 256) if case.get("seg") else None
    window = case.get("window")
    ref_out, ref_lse = _jax_flash(q, k, v, case["causal"], window, seg)
    out, lse = flash_attention_fwd(
        *_t(q, k, v), causal=case["causal"], window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _close(out.numpy(), ref_out, ATOL_ATTN)
    _close(lse.numpy(), ref_lse, 1e-4)


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_fp16_flash_bwd_matches_jax_grad(pallas_interpret, case):
    """``FlashAttentionFunction`` forward + backward in fp16 against
    ``jax.grad`` of the Pallas flash kernel (interpret) in fp16; the
    gradients come back in fp16 on both sides."""
    q, k, v, g = _qkv(2, 256, 256, case.get("h", 4), 2, 64, seed=1)
    seg = _segments(2, 256) if case.get("seg") else None
    window = case.get("window")

    def loss(q, k, v):
        out = flash_attention_bshd(
            q, k, v, causal=case["causal"], block_q=128, block_k=128,
            window=window,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g, jnp.float32))
    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    out, _ = FlashAttentionFunction.apply(
        *xs, case["causal"], None, window,
        None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(g))
    for x, want in zip(xs, ref):
        assert x.grad.dtype == torch.float16 and want.dtype == jnp.float16
        want = np.asarray(want, np.float32)
        _close(x.grad.numpy(), want, RTOL_GRAD * np.abs(want).max())


def test_fp16_fully_masked_rows_stay_finite(pallas_interpret):
    """sq > sk, causal: the first sq - sk query rows see no key at all.
    The -1e30 mask stays in fp32 on every path, so such rows give finite
    values (which values depends on the tile a kernel skips, so only the
    live rows are compared with the Pallas kernel)."""
    q, k, v, g = _qkv(1, 256, 128, 4, 2, 64, seed=2)
    out, lse = flash_attention_fwd(*_t(q, k, v), causal=True)
    ref_out, ref_lse = _jax_flash(q, k, v, True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert np.isfinite(ref_out).all()
    _close(out[:, 128:].numpy(), ref_out[:, 128:], ATOL_ATTN)
    grads = flash_attention_bwd(*_t(q, k, v), out, lse, torch.from_numpy(g),
                                causal=True)
    assert all(torch.isfinite(x).all() for x in grads)


@pytest.mark.parametrize("cache_index,window", [(0, None), (127, None),
                                                (200, None), (255, 50)])
def test_fp16_decode_plain_matches_pallas(pallas_interpret, cache_index,
                                          window):
    rs = np.random.RandomState(cache_index)
    b, T, h, kv, d = 2, 256, 8, 2, 64
    q = rs.randn(b, h, d).astype(F16)
    ck = rs.randn(b, T, kv, d).astype(F16)
    cv = rs.randn(b, T, kv, d).astype(F16)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.int32(cache_index),
                                  scale=1.0 / np.sqrt(d), block_t=128,
                                  window=window)
    got = decode_attention_fwd(*_t(q, ck, cv), cache_index, window=window)
    assert got.dtype == torch.float16 and ref.dtype == jnp.float16
    _close(got.numpy(), ref, ATOL_ATTN)


def _paged_case(seed, T=1, h=4, kvh=2, d=64, B=8, M=6, P=24, lens=None):
    rs = np.random.RandomState(seed)
    R = len(lens)
    shape = (R, T, h, d) if T > 1 else (R, h, d)
    q = rs.randn(*shape).astype(F16)
    kp = rs.randn(P, B, kvh, d).astype(F16)
    vp = rs.randn(P, B, kvh, d).astype(F16)
    tables = np.stack([rs.permutation(np.arange(1, P))[:M]
                       for _ in range(R)]).astype(np.int32)
    tables[1:3, :M // 2] = tables[0, :M // 2]
    lens = np.asarray(lens, np.int32)
    tables[lens == 0] = 0
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("T,window", [(1, None), (1, 5), (3, None)],
                         ids=["decode", "window", "multi-query"])
def test_fp16_ragged_plain_matches_pallas(pallas_interpret, T, window):
    q, kp, vp, tables, sl = _paged_case(T, T=T, lens=[0, 7, 8, 45])
    ref = ragged_paged_attention_pallas(
        *map(jnp.asarray, (q, kp, vp, tables, sl)), 1.0 / np.sqrt(64),
        window=window)
    got = ragged_paged_attention(*_t(q, kp, vp, tables, sl), window=window)
    assert got.dtype == torch.float16
    _close(got.numpy(), ref, ATOL_ATTN)


@pytest.mark.parametrize("window", [None, 13])
def test_fp16_grid_plain_matches_pallas(pallas_interpret, window):
    q, kp, vp, tables, sl = _paged_case(5, h=8, M=8, P=40,
                                        lens=[0, 7, 8, 63])
    ref = paged_attention_pallas(*map(jnp.asarray, (q, kp, vp, tables, sl)),
                                 1.0 / np.sqrt(64), window=window)
    got = paged_attention(*_t(q, kp, vp, tables, sl), window=window)
    assert got.dtype == torch.float16
    _close(got.numpy(), ref, ATOL_ATTN)


@pytest.mark.parametrize("bits", [8, 4])
def test_fp16_quant_plain_matches_pallas(pallas_interpret, bits):
    """fp16 activations, bf16 scales: both dequantize and sum in fp32 and
    cast once to fp16."""
    rs = np.random.RandomState(bits)
    w = (rs.randn(256, 384) * 0.1).astype(np.float32)
    x = rs.randn(8, 256).astype(F16)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), bits)
    ref = np.asarray(quant_matmul_pallas(jnp.asarray(x), qj, sj, bits=bits))
    assert ref.dtype == F16
    qt, st = quantize_blockwise(torch.from_numpy(w), bits)
    got = quant_matmul(torch.from_numpy(x), qt, st, bits)
    assert got.dtype == torch.float16
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=RTOL_QUANT,
                               atol=1e-3 * np.abs(ref).max())


def test_fp16_takes_the_tensor_core_route():
    """On the card fp16 at d 64/128 launches the wgmma kernels (forward,
    dq and dk/dv), as bf16 does; d 256 the simt ones."""
    assert [flash_route(torch.float16, d) for d in (64, 128, 256)] == \
        ["wgmma", "wgmma", "simt"]


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def pair():
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny(dtype=jnp.float16, **TINY))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(dtype=torch.float16, **TINY),
                              device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    assert next(tm.parameters()).dtype == torch.float16
    return jm, tm


@pytest.mark.parametrize("s", [10, 128])
def test_fp16_generate_matches_jax(pair, s):
    """Greedy ``generate`` in fp16: prompt 10 (dense prefill) and 128 (the
    flash route's plain version), then the decode route; token for
    token."""
    jm, tm = pair
    ids = np.random.RandomState(s).randint(0, 256, (2, s)).astype(np.int32)
    ref = np.asarray(jax_generate(jm, jnp.asarray(ids),
                                  JaxGenConfig(max_new_tokens=3)))
    got = ptt.generate(tm, torch.from_numpy(ids),
                       ptt.GenerationConfig(max_new_tokens=3))
    assert got.shape == (2, s + 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fp16_paged_engine_matches_jax(pair):
    """One 11-token request through the host-tick engines (the port's
    ragged plain version at head_dim 64): the same greedy tokens."""
    jm, tm = pair
    geo = dict(max_slots=4, num_blocks=32, block_size=8,
               max_blocks_per_seq=8, prefill_buckets=(16, 32),
               fused_tick=False)
    ids = np.random.RandomState(11).randint(1, 256, (1, 11))
    out = []
    for eng in (JaxEngine(jm, **geo), PagedEngine(tm, **geo)):
        eng.submit("a", ids, max_new_tokens=3)
        out.append(eng.run())
    assert out[1] == out[0] and len(out[0]["a"]) == 3


def test_fp16_weight_only_linear_matches_jax(pallas_interpret):
    """x fp16 [4, 256] against int8 codes of a [256, 128] weight: both
    packages take their quant kernel (Pallas in interpret mode, the plain
    version here) and return fp16 [4, 128]."""
    rs = np.random.RandomState(3)
    w = (rs.randn(256, 128) * 0.1).astype(np.float32)
    x = rs.randn(4, 256).astype(F16)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), 8)
    ref = np.asarray(jax_wo.weight_only_linear(jnp.asarray(x), qj, sj,
                                               bits=8))
    qt, st = quantize_blockwise(torch.from_numpy(w), 8)
    got = weight_only_linear(torch.from_numpy(x), qt, st, bits=8)
    assert ref.dtype == F16 and got.dtype == torch.float16
    assert got.shape == (4, 128)
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=RTOL_QUANT,
                               atol=1e-3 * np.abs(ref).max())


def test_fp16_predictor_run_matches_jax():
    """``Predictor(model, Config().set_dtype("float16"))`` casts an fp32
    model to fp16 in both packages; ``run`` on [1, 128] ids (the flash
    route) runs the fp16 model; both return its logits cast to fp32 (as
    the models do for the loss), within RTOL_LOGITS of each other."""
    pt.seed(1)
    jm = JaxLlama(jax_llama_tiny(**TINY))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**TINY), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    jp = JaxPredictor(jm, JaxConfig().set_dtype("float16"))
    tp = ptt.Predictor(tm, ptt.Config().set_dtype("float16"), device="cpu")
    ids = np.random.RandomState(4).randint(0, 256, (1, 128)).astype(np.int32)
    assert {p.dtype for p in tp.model.parameters()} == {torch.float16}
    ref = np.asarray(jp.run(jnp.asarray(ids)))
    got = tp.run(torch.from_numpy(ids))
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == (1, 128, 256) and torch.isfinite(got).all()
    _close(got.numpy(), ref, RTOL_LOGITS * np.abs(ref).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
