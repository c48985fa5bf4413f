"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode (fp32, same numpy inputs).
``test_torch_kernels_gpu.py`` holds the CUDA kernels against the plain
versions on the card."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention import decode_attention as jax_decode
from paddle_tpu.ops.attention import dense_attention as jax_dense
from paddle_tpu.ops.pallas.decode_attention import decode_attention_pallas
from paddle_tpu.ops.pallas.flash_attention import _flash_fwd
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.kernels import use_kernel
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain, flash_route)

# fp32 on the CPU: both sides sum the same fp32 products in another order
ATOL_FP32 = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _qkv(b, sq, sk, h, kv, d, seed=0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rs.randn(b, sk, kv, d) * 0.5).astype(np.float32)
    v = rs.randn(b, sk, kv, d).astype(np.float32)
    return q, k, v


def _segments(b, s, seed=0):
    rs = np.random.RandomState(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        a, c = sorted(rs.choice(np.arange(16, s - 16), 2, replace=False))
        seg[i, :a], seg[i, a:c], seg[i, c:s - 8] = 1, 2, 3
    return seg


def _jax_flash(q, k, v, causal, window=None, seg=None):
    """_flash_fwd in interpret mode on the bh-flattened layout, back to
    (out [b, sq, h, d], lse [b, h, sq])."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * kv, sk, d)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(b * kv, sk, d)
    out, lse = _flash_fwd(qf, kf, vf, 1.0 / np.sqrt(d), causal, 128, 128,
                          segment_ids=None if seg is None
                          else jnp.asarray(seg), heads=h, window=window)
    out = np.asarray(out).reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse).reshape(b, h, sq)


@pytest.mark.parametrize("case", [
    dict(causal=True, s=256),
    dict(causal=False, s=128),
    dict(causal=True, s=256, window=40),
    dict(causal=True, s=256, seg=True),
    dict(causal=False, s=128, seg=True),
    dict(causal=True, s=128, kv=4),          # MHA: one query head per kv
], ids=["causal", "full", "window", "segments", "segments-full", "mha"])
def test_flash_plain_matches_pallas(pallas_interpret, case):
    """Plain flash forward vs ``_flash_fwd`` (interpret), fp32, out and lse
    within 1e-5; GQA with 2 query heads per kv head unless noted."""
    b, s, h, d = 2, case["s"], 4, 64
    kv = case.get("kv", 2)
    q, k, v = _qkv(b, s, s, h, kv, d)
    seg = _segments(b, s) if case.get("seg") else None
    window = case.get("window")
    ref_out, ref_lse = _jax_flash(q, k, v, case["causal"], window, seg)
    out, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=case["causal"], window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL_FP32,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL_FP32,
                               rtol=0)


def test_flash_plain_bottom_right_causal_with_longer_keys(pallas_interpret):
    """sk > sq: the causal diagonal sits at offset sk - sq."""
    q, k, v = _qkv(1, 128, 256, 4, 2, 64, seed=3)
    ref_out, ref_lse = _jax_flash(q, k, v, True)
    out, lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL_FP32,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL_FP32,
                               rtol=0)


@pytest.mark.parametrize("cache_index", [0, 127, 128, 200, 255])
@pytest.mark.parametrize("window", [None, 50])
def test_decode_plain_matches_pallas(pallas_interpret, cache_index, window):
    """Plain decode vs ``decode_attention_pallas`` (interpret), fp32,
    within 1e-5, at a cache tile edge and with a sliding window."""
    rs = np.random.RandomState(cache_index)
    b, T, h, kv, d = 2, 256, 8, 2, 64
    q = rs.randn(b, h, d).astype(np.float32)
    ck = rs.randn(b, T, kv, d).astype(np.float32)
    cv = rs.randn(b, T, kv, d).astype(np.float32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.int32(cache_index),
                                  scale=1.0 / np.sqrt(d), block_t=128,
                                  window=window)
    got = decode_attention_fwd(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), cache_index,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("window", [None, 7])
def test_decode_dispatch_matches_jax(monkeypatch, window):
    """``ops.attention.decode_attention``: the port's kernel route and its
    grouped-einsum route (group 16 > 8) vs the JAX dispatch layer."""
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    rs = np.random.RandomState(5)
    for h, kv in ((8, 2), (16, 1)):
        q = rs.randn(2, 1, h, 64).astype(np.float32)
        ck = rs.randn(2, 96, kv, 64).astype(np.float32)
        cv = rs.randn(2, 96, kv, 64).astype(np.float32)
        ref = jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                         jnp.int32(40), window=window)
        assert port_attn.use_decode_kernel(torch.from_numpy(q),
                                           torch.from_numpy(ck)) == (h // kv
                                                                     <= 8)
        got = port_attn.decode_attention(torch.from_numpy(q),
                                         torch.from_numpy(ck),
                                         torch.from_numpy(cv), 40,
                                         window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_dense_attention_matches_jax(causal, window):
    q, k, v = _qkv(2, 24, 24, 4, 2, 16, seed=7)
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window)
    got = port_attn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL_FP32, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 128, 4, 2, 64))
    f0, d0 = flash_attention_fwd.launches, decode_attention_fwd.launches
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(out, ref)
    decode_attention_fwd(q[:, 0], k, v, 5)
    assert (flash_attention_fwd.launches, decode_attention_fwd.launches) \
        == (f0, d0)
    assert not use_kernel(q, k, v)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float16, 256, "simt")])
def test_flash_route_depends_on_dtype_and_head_dim_alone(dtype, d, route):
    """bf16 or fp16 at d 64 or 128 takes the tensor-core kernels; fp32
    (no fp32 wgmma) and d 256 the CUDA-core ones. The CPU's plain route
    counts nothing on either."""
    assert flash_route(dtype, d) == route
    before = dict(flash_attention_fwd.launches_by_route)
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    flash_attention_fwd(q, q, q, causal=True)
    assert flash_attention_fwd.launches_by_route == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 128, 4, 2, 64))
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention_fwd(q, k, v, window=4)
    with pytest.raises(ValueError, match="cache_index"):
        decode_attention_fwd(q[:, 0], k, v, 128)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        use_kernel(q, torch.empty(1, device="meta"))


def test_import_keeps_jax_and_paddle_tpu_out():
    """Every module of the port, found by walking the package, and
    chip_smoke.py import in a fresh interpreter without JAX or the JAX
    package coming in."""
    code = (
        "import importlib, pkgutil, sys, paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "want = {'trainer', 'optimizer', 'io', 'utils.profiler', 'quant',"
        " 'quant.gptq_awq', 'ops.kernels.quant_matmul',"
        " 'ops.kernels.paged_attention', 'generation.paged'}\n"
        "missing = want - {n.split('.', 1)[1] for n in names}\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def test_default_device_raises_without_a_card(monkeypatch):
    import paddle_tpu_torch as ptt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.LlamaForCausalLM(ptt.llama_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.Predictor(ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.make_generator(0)
