"""The port's weight-only quantization against the JAX package's, on the
CPU.

The same numpy weights go through both packages: codes, packed int4
bytes and bf16 scales must be bitwise equal; dequantized weights equal
in fp32 and bf16; the quant kernel's plain version (what the wrapper runs
on CPU tensors) within 1e-5 of ``quant_matmul_pallas`` in interpret mode
(fp32: the same products summed in another order). A quantized
``Predictor`` on a Llama wide enough for every projection to pass the
kernel's gate (hidden 256, ffn 512; ``llama_tiny``'s hidden 64 quantizes
nothing) must give the JAX Predictor's greedy tokens, with logits within
1e-4. ``test_torch_kernels_gpu.py`` holds the CUDA kernel against the
plain version on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation import GenerationConfig as JaxGenConfig
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from paddle_tpu.quant import gptq_awq as jax_gptq_awq
from paddle_tpu.quant import weight_only as jax_wo
from paddle_tpu_torch.ops.kernels.quant_matmul import (mma_splits,
                                                       quant_matmul,
                                                       quant_matmul_plain,
                                                       quant_route,
                                                       use_quant_matmul)
from paddle_tpu_torch.quant import (AWQLinear, QuantizedLinear,
                                    awq_quantize_model, awq_search_scale,
                                    dequantize_weight, gptq_quantize_model,
                                    gptq_quantize_weight, pack_int4,
                                    quantize_blockwise, quantize_model,
                                    weight_only_linear)

# fp32 on the CPU: the same products summed in another order
ATOL_FP32 = 1e-5
# logits of a 2-layer fp32 model: XLA's and torch's matmuls sum in
# another order
ATOL_LOGITS = 1e-4
# every projection of this Llama has in_features % 128 == 0
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _weight(din, dout, bits, seed=0):
    """Random [din, dout] weights with the hard cases in fixed places: an
    all-zero scale block (scale 0 -> divisor 1), and a column whose block
    maximum makes the scale a power of two and whose values sit exactly
    half-way between two codes (round half to even)."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(din, dout) * 0.05).astype(np.float32)
    w[:128, 1] = 0.0
    qmax = 127 if bits == 8 else 7
    step = 2.0 ** -7 if bits == 8 else 2.0 ** -4
    ties = (np.arange(128) % (2 * qmax) - qmax + 0.5) * step
    w[:128, 2] = np.clip(ties, -qmax * step, qmax * step)
    w[0, 2] = qmax * step              # the block maximum: scale = step
    return w


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256, 384), (1024, 128)])
def test_quantize_blockwise_codes_bitwise_equal_jax(bits, shape):
    w = _weight(*shape, bits)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), bits)
    qt, st = quantize_blockwise(torch.from_numpy(w), bits)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    assert qt.shape == ((shape[0] if bits == 8 else shape[0] // 2),
                        shape[1])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))
    if bits == 8:
        # the ties round half to even (+-0.5 -> 0, 1.5 -> 2, ...)
        np.testing.assert_array_equal(
            qt.numpy()[:128, 2], np.round(w[:128, 2] / 2.0 ** -7))


def test_pack_int4_bytes_bitwise_equal_jax():
    codes = np.random.RandomState(1).randint(-8, 8, (64, 48)).astype(np.int8)
    codes[0, :16] = np.arange(-8, 8)
    codes[1, :16] = np.arange(7, -9, -1)
    ref = np.asarray(jax_wo.pack_int4(jnp.asarray(codes)))
    got = pack_int4(torch.from_numpy(codes))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weight_matches_jax(bits, dtype):
    w = _weight(256, 256, bits, seed=2)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), bits)
    ref = jax_wo.dequantize_weight(qj, sj, bits, dtype=getattr(jnp, dtype))
    qt, st = quantize_blockwise(torch.from_numpy(w), bits)
    got = dequantize_weight(qt, st, bits, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 17, 64])
def test_quant_matmul_plain_matches_pallas(pallas_interpret, bits, m):
    rs = np.random.RandomState(m)
    w = (rs.randn(256, 384) * 0.1).astype(np.float32)
    x = rs.randn(m, 256).astype(np.float32)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), bits)
    ref = quant_matmul_pallas(jnp.asarray(x), qj, sj, bits=bits)
    qt, st = quantize_blockwise(torch.from_numpy(w), bits)
    got = quant_matmul(torch.from_numpy(x), qt, st, bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("lead", [(2, 3), (5, 20)], ids=["kernel", "dequant"])
def test_weight_only_linear_routes_match_jax(pallas_interpret, bits, lead):
    """6 rows take the kernel in both packages (Pallas in interpret mode,
    the plain version here); 100 rows dequantize and take one matmul."""
    rs = np.random.RandomState(bits)
    w = (rs.randn(256, 128) * 0.1).astype(np.float32)
    x = rs.randn(*lead, 256).astype(np.float32)
    bias = rs.randn(128).astype(np.float32)
    qj, sj = jax_wo.quantize_blockwise(jnp.asarray(w), bits)
    ref = jax_wo.weight_only_linear(jnp.asarray(x), qj, sj, jnp.asarray(bias),
                                    bits=bits)
    qt, st = quantize_blockwise(torch.from_numpy(w), bits)
    x2d = torch.from_numpy(x).reshape(-1, 256)
    assert use_quant_matmul(x2d, qt, 128) == (x2d.shape[0] <= 64)
    got = weight_only_linear(torch.from_numpy(x), qt, st,
                             torch.from_numpy(bias), bits=bits)
    assert got.shape == (*lead, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_FP32,
                               rtol=0)


def test_quant_kernel_gate_and_plain_route_without_counting():
    qt, st = quantize_blockwise(torch.randn(256, 128), 8)
    x = torch.randn(4, 256)
    assert use_quant_matmul(x, qt, 128)
    assert not use_quant_matmul(torch.randn(65, 256), qt, 128)
    assert not use_quant_matmul(x, qt, 64)
    assert not use_quant_matmul(x, torch.zeros(256, 96, dtype=torch.int8),
                                128)
    n = quant_matmul.launches
    assert torch.equal(quant_matmul(x, qt, st), quant_matmul_plain(x, qt, st))
    assert quant_matmul.launches == n


def test_quant_route_depends_on_dtype_alone():
    """bf16 and fp16 activations take the tensor-core kernel, fp32 the
    CUDA-core one, at any shape; a CPU call counts on neither route."""
    assert quant_route(torch.bfloat16) == quant_route(torch.float16) == "mma"
    assert quant_route(torch.float32) == "simt"
    qt, st = quantize_blockwise(torch.randn(256, 128), 8)
    before = dict(quant_matmul.launches_by_route)
    quant_matmul(torch.randn(4, 256).to(torch.bfloat16), qt, st)
    assert quant_matmul.launches_by_route == before


@pytest.mark.parametrize("m", [1, 16, 64, 65, 200])
def test_mma_splits_stay_on_scale_blocks(m):
    """Split-K of the tensor-core kernel: from the shapes, the bits and
    the SM count alone, never more splits than pairs of 128-row scale
    blocks, a divisor of the scale-block count, and more
    splits where the projection has few column tiles (Llama-3-8B's k/v
    projection, 8 tiles of 128, against gate_proj's 112)."""
    for din, dout in ((4096, 4096), (4096, 1024), (4096, 14336),
                      (14336, 4096), (128, 16)):
        for bits in (8, 4):
            s = mma_splits(m, din, dout, 132, bits)
            assert 1 <= s <= max(1, din // 128 // 2)
            assert (din // 128) % s == 0       # every split the same bytes
            assert s == mma_splits(m, din, dout, 132, bits)
    assert mma_splits(4, 4096, 1024, 132) > mma_splits(4, 4096, 14336, 132)


def test_quant_wrapper_rejects_what_the_kernel_does_not_take():
    qt, st = quantize_blockwise(torch.randn(256, 128), 8)
    x = torch.randn(4, 256)
    with pytest.raises(ValueError, match="bits"):
        quant_matmul(x, qt, st, bits=2)
    with pytest.raises(ValueError, match="do not fit"):
        quant_matmul(x, qt, st, bits=4)          # 256 rows of codes, not 128
    with pytest.raises(ValueError, match="do not fit"):
        quant_matmul(torch.randn(4, 200), qt[:200], st)
    with pytest.raises(TypeError):
        quant_matmul(x.double(), qt, st)
    with pytest.raises(TypeError):
        quant_matmul(x, qt, st.float())


def _jax_wide(seed=0):
    pt.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**WIDE))
    jm.eval()
    return jm


def _port_from(jm):
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**WIDE), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    return tm


def _quantized_paths(model, named):
    return sorted(p for p, m in named(model)
                  if type(m).__name__ == "QuantizedLinear")


def test_quantize_model_swaps_and_skips_like_jax():
    """Same paths swapped: every q/k/v/o and gate/up/down projection; the
    lm_head and the embedding skipped by name; a Linear whose in_features
    is not a multiple of 128 left as it is."""
    jm = _jax_wide()
    tm = _port_from(jm)
    skip = ["lm_head", "embed"]
    nj = jax_wo.quantize_model(jm, bits=8, skip=skip)
    nt = quantize_model(tm, bits=8, skip=skip)
    assert nt == nj == 2 * 7
    assert _quantized_paths(tm, lambda m: m.named_modules()) == \
        _quantized_paths(jm, lambda m: m.named_sublayers())
    assert isinstance(tm.lm_head, ptt.nn.Linear)
    small = ptt.nn.Linear(64, 128, generator=ptt.make_generator(0, "cpu"),
                          device="cpu")
    holder = torch.nn.Sequential(small)
    assert quantize_model(holder) == 0 and holder[0] is small
    assert quantize_model(tm, bits=8) == 1              # now lm_head too
    q = tm.model.layers[0].mlp.down_proj
    assert dict(q.named_buffers()).keys() == {"qweight", "scales"}
    assert not list(q.parameters())
    # codes from the transposed [out, in] weight are dense [in, out] rows,
    # as the kernel reads them
    for m in tm.modules():
        if isinstance(m, QuantizedLinear):
            assert m.qweight.is_contiguous() and m.scales.is_contiguous()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_jax_model_crosses_by_load_jax_state_dict(bits):
    """A JAX model quantized in place, its state_dict loaded into a port
    model quantized the same way from other weights: codes and scales
    cross bit for bit, untransposed, and the logits agree."""
    jm = _jax_wide(seed=1)
    jax_wo.quantize_model(jm, bits=bits, skip=["lm_head", "embed"])
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**WIDE), device="cpu",
                              generator=ptt.make_generator(7, "cpu"))
    quantize_model(tm, bits=bits, skip=["lm_head", "embed"])
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ptt.load_jax_state_dict(tm, state)
    own = tm.state_dict()
    for k in state:
        if k.endswith(("qweight", "scales")):
            assert own[k].dtype == (torch.int8 if k.endswith("qweight")
                                    else torch.bfloat16), k
            np.testing.assert_array_equal(_np(own[k]),
                                          state[k].astype(_np(own[k]).dtype))
    ids = np.random.RandomState(3).randint(0, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_LOGITS, rtol=0)
    with pytest.raises(KeyError, match="missing"):
        ptt.load_jax_state_dict(tm, {k: v for k, v in state.items()
                                     if not k.endswith("scales")})


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_only_predictor_generate_matches_jax(bits):
    """Predictor(Config().enable_weight_only_quant(bits)) on both sides,
    from the same fp32 weights: the same layers quantize to the same
    codes, greedy generate gives the same tokens, and the prefill logits
    agree. Both decode steps (4 rows) take the kernel route, the 16-row
    prefill too (the JAX side dequantizes there: the same fp32 math)."""
    jm = _jax_wide(seed=2)
    tm = _port_from(jm)
    jp = JaxPredictor(jm, JaxConfig().enable_weight_only_quant(bits))
    tp = ptt.Predictor(tm, ptt.Config().enable_weight_only_quant(bits),
                       device="cpu")
    jq = dict(jm.state_dict())
    for k, v in tm.state_dict().items():
        if k.endswith("qweight"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jq[k]))
    ids = np.random.RandomState(4).randint(0, 256, (4, 16)).astype(np.int32)
    ref = np.asarray(jp.generate(jnp.asarray(ids),
                                 config=JaxGenConfig(max_new_tokens=8)))
    got = tp.generate(torch.from_numpy(ids),
                      config=ptt.GenerationConfig(max_new_tokens=8))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(tp.run(ids).numpy(),
                               np.asarray(jp.run(ids)), atol=ATOL_LOGITS,
                               rtol=0)


def test_config_dtype_and_bits():
    cfg = ptt.Config().set_dtype("bfloat16").enable_weight_only_quant(4)
    assert cfg.dtype == torch.bfloat16 and cfg.quant_bits == 4
    assert cfg.quant_skip == ["lm_head", "embed"]
    with pytest.raises(ValueError):
        ptt.Config().enable_weight_only_quant(3)
    with pytest.raises(ValueError):
        ptt.Config().set_dtype("int8")
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**WIDE), device="cpu")
    pred = ptt.Predictor(tm, cfg, device="cpu")
    q = pred.model.model.layers[0].self_attn.q_proj
    assert isinstance(q, QuantizedLinear) and q.qweight.shape == (128, 256)
    assert pred.model.lm_head.weight.dtype == torch.bfloat16
    assert pred.model.model.rope_inv_freq.dtype == torch.float32


@pytest.mark.parametrize("bits,act_order", [(4, False), (4, True),
                                            (8, False)])
def test_gptq_codes_match_jax(bits, act_order):
    rs = np.random.RandomState(5)
    w = (rs.randn(256, 64) * 0.1).astype(np.float32)
    x = rs.randn(96, 256).astype(np.float32)
    qj, sj = jax_gptq_awq.gptq_quantize_weight(w, x, bits,
                                               act_order=act_order)
    qt, st = gptq_quantize_weight(torch.from_numpy(w), x, bits,
                                  act_order=act_order)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))


@pytest.mark.parametrize("bits", [4, 8])
def test_awq_scale_and_codes_match_jax(bits):
    rs = np.random.RandomState(6)
    w = (rs.randn(256, 64) * 0.1).astype(np.float32)
    x = (rs.randn(96, 256) * np.linspace(0.1, 4, 256)).astype(np.float32)
    sj = np.asarray(jax_gptq_awq.awq_search_scale(jnp.asarray(w), x, bits))
    st = awq_search_scale(torch.from_numpy(w), x, bits)
    np.testing.assert_array_equal(st.numpy(), sj)
    qj, _ = jax_wo.quantize_blockwise(jnp.asarray(w) * jnp.asarray(sj)[:, None],
                                      bits)
    qt, _ = quantize_blockwise(torch.from_numpy(w) * st[:, None], bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


@pytest.mark.parametrize("pass_fn", [gptq_quantize_model, awq_quantize_model],
                         ids=["gptq", "awq"])
def test_calibrated_passes_swap_and_serve(pass_fn):
    """The model passes capture each projection's inputs, swap every
    eligible Linear (lm_head skipped) and the model still serves: logits
    close to the fp32 model's, and an AWQ layer equals its formula."""
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**WIDE), device="cpu",
                              generator=ptt.make_generator(3, "cpu"))
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (2, 16)).astype(np.int64))
    with torch.no_grad():
        before = tm(ids)
    n = pass_fn(tm, [ids], bits=8, skip=["lm_head"])
    assert n == 14
    with torch.no_grad():
        after = tm(ids)
    assert torch.isfinite(after).all()
    assert float((after - before).abs().max()) < 0.1
    layer = tm.model.layers[1].mlp.up_proj
    if pass_fn is awq_quantize_model:
        assert isinstance(layer, AWQLinear)
        x = torch.randn(3, 256)
        ref = weight_only_linear(x * layer.awq_inv, layer.qweight,
                                 layer.scales, bits=8)
        torch.testing.assert_close(layer(x), ref, atol=0, rtol=0)
