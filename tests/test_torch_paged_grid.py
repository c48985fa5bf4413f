"""The port's grid paged attention and the ``PADDLE_TPU_PAGED_ATTN``
routing against the JAX package's, on the CPU.

The plain version (what the wrapper runs on CPU tensors) is held against
``paged_attention_pallas`` in interpret mode, fp32, same numpy inputs,
within 1e-5: idle rows (seq_len 0), block edges, a sliding window, GQA
groups 1, 2 and 4, and table slots past each row's live count that hold
other rows' blocks. ``paged_decode_attention`` under every value of
``PADDLE_TPU_PAGED_ATTN`` is held against the JAX function under the same
value, and must take the same route; the port's ``PagedEngine`` under
``grid`` must give the JAX engine's greedy tokens.
``test_torch_kernels_gpu.py`` holds the CUDA kernel against the plain
version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.generation.paged import PagedEngine as JaxEngine
from paddle_tpu.generation.paged import PagedKV as JaxPagedKV
from paddle_tpu.generation.paged import \
    paged_decode_attention as jax_paged_decode_attention
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas.paged_attention import paged_attention_pallas
from paddle_tpu_torch.generation import paged as port_paged
from paddle_tpu_torch.generation.paged import PagedEngine, PagedKV
from paddle_tpu_torch.ops.kernels.paged_attention import (
    paged_attention, paged_attention_plain)

# fp32 on the CPU: both sides sum the same fp32 products in another order
ATOL_FP32 = 1e-5
# fp32 logprobs of a 2-layer model: XLA's and torch's sums in another order
ATOL_LP = 1e-4
# llama_tiny's head_dim is 16, which the port's paged gate refuses (it
# would take the dense gather); these widths give head_dim 64
HEAD_DIM_64 = dict(hidden_size=256, intermediate_size=512,
                   num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(seed, R=4, T=1, h=4, kvh=2, d=64, B=8, M=8, P=40, lens=None):
    """Random q and pools; each row's table distinct physical blocks
    (never block 0), rows 1 and 2 sharing row 0's first blocks as prefix
    sharing does, and the slots past each row's live count holding other
    blocks of the pool (garbage the kernel must not read); idle rows (len
    0) keep an all-zero table."""
    rs = np.random.RandomState(seed)
    shape = (R, T, h, d) if T > 1 else (R, h, d)
    q = rs.randn(*shape).astype(np.float32)
    kp = rs.randn(P, B, kvh, d).astype(np.float32)
    vp = rs.randn(P, B, kvh, d).astype(np.float32)
    tables = np.stack([rs.permutation(np.arange(1, P))[:M]
                       for _ in range(R)]).astype(np.int32)
    tables[1:3, :M // 2] = tables[0, :M // 2]
    lens = np.asarray(lens if lens is not None
                      else rs.randint(0, M * B - T, R), np.int32)
    for r, n in enumerate(lens):
        live = -(-(int(n) + T) // B)
        tables[r, live:] = rs.randint(0, P, M - live)
    tables[lens == 0] = 0
    return q, kp, vp, tables, lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window,group,d,lens", [
    (None, 2, 64, [0, 7, 8, 63]),           # idle row, block edges, full
    (20, 2, 64, [0, 7, 8, 63]),
    (None, 1, 64, [3, 16, 30, 47]),
    (13, 4, 64, [1, 9, 24, 40]),
    (None, 4, 128, [0, 15, 16, 62]),
    (5, 4, 128, [4, 5, 6, 33]),              # window inside the first block
], ids=["decode", "window", "mha", "group4-window", "group4-d128",
        "short-window"])
def test_grid_plain_matches_pallas(window, group, d, lens):
    q, kp, vp, tables, sl = _case(group + d, h=2 * group, d=d, lens=lens)
    scale = 1.0 / np.sqrt(d)
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tables),
                                 jnp.asarray(sl), scale, window=window)
    got = paged_attention(*_torch(q, kp, vp, tables, sl), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_FP32,
                               rtol=0)


@pytest.fixture
def routes(monkeypatch):
    """Counts which kernel wrapper the port's paged_decode_attention
    called (the wrappers' own counters count only launches on a card)."""
    seen = {"grid": 0, "ragged": 0}

    def spy(key, fn):
        def wrapped(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_paged, "paged_attention",
                        spy("grid", port_paged.paged_attention))
    monkeypatch.setattr(port_paged, "ragged_paged_attention",
                        spy("ragged", port_paged.ragged_paged_attention))
    return seen


@pytest.mark.parametrize("mode,T,route", [
    ("grid", 1, "grid"), ("grid", 3, "dense"), ("ragged", 1, "ragged"),
    ("ragged", 3, "ragged"), ("dense", 1, "dense"), ("bogus", 1, "ragged"),
    (None, 3, "ragged"),
], ids=["grid", "grid-multi-query", "ragged", "ragged-multi-query",
        "dense", "unknown-value", "unset-multi-query"])
@pytest.mark.parametrize("window", [None, 6], ids=["full", "window"])
def test_paged_decode_attention_routes_as_jax(monkeypatch, routes, mode, T,
                                              route, window):
    """The variable is read at call time, value for value as the JAX
    package reads it, and both packages give the same numbers."""
    if mode is not None:
        monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", mode)
    q, kp, vp, tables, sl = _case(17, T=T, lens=[0, 8, 21, 44])
    q4 = q if T > 1 else q[:, None]
    ref = jax_paged_decode_attention(
        jnp.asarray(q4), JaxPagedKV(jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(tables), jnp.asarray(sl)),
        window=window)
    tq, tkp, tvp, ttb, tsl = _torch(q4, kp, vp, tables, sl)
    got = port_paged.paged_decode_attention(tq, PagedKV(tkp, tvp, ttb, tsl),
                                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_FP32,
                               rtol=0)
    want = {"grid": 0, "ragged": 0}
    if route != "dense":
        want[route] = 1
    assert routes == want


def test_engine_under_grid_gives_jax_greedy_tokens(monkeypatch, routes):
    """Both PagedEngines (host tick) under PADDLE_TPU_PAGED_ATTN=grid, the
    JAX one running its grid kernel in interpret mode: identical greedy
    tokens, logprobs within 1e-4, and every decode tick of every layer
    through the port's grid wrapper. The port's ragged route gives the
    same tokens."""
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "grid")
    pt.seed(0)
    jm = JaxLlama(jax_llama_tiny(**HEAD_DIM_64))
    jm.eval()
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(**HEAD_DIM_64), device="cpu")
    ptt.load_jax_state_dict(tm, {k: np.asarray(v)
                                 for k, v in jm.state_dict().items()})
    geo = dict(max_slots=3, num_blocks=24, block_size=8,
               max_blocks_per_seq=6, prefill_buckets=(16,), fused_tick=False)
    rs = np.random.RandomState(4)
    prompts = {f"g{i}": rs.randint(1, 256, (1, n))
               for i, n in enumerate([3, 8, 13])}

    def drive(eng):
        for rid, ids in prompts.items():
            eng.submit(rid, ids, max_new_tokens=9)
        return eng.run()

    je = JaxEngine(jm, **geo)
    ref = drive(je)
    te = PagedEngine(tm, **geo)
    got = drive(te)
    assert got == ref
    for rid in ref:
        np.testing.assert_allclose(te.logprobs[rid], je.logprobs[rid],
                                   atol=ATOL_LP, rtol=0, err_msg=rid)
    layers = tm.config.num_hidden_layers
    assert routes == {"grid": layers * te.stats["decode_steps"],
                      "ragged": 0}
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "ragged")
    assert drive(PagedEngine(tm, **geo)) == ref


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, kp, vp, tables, sl = _torch(*_case(2))
    n = paged_attention.launches
    out = paged_attention(q, kp, vp, tables, sl, window=9)
    assert torch.equal(out, paged_attention_plain(q, kp, vp, tables, sl,
                                                  window=9))
    assert paged_attention.launches == n


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, tables, sl = _torch(*_case(3))
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, kp, vp, tables.long(), sl)
    with pytest.raises(TypeError):
        paged_attention(q, kp.double(), vp, tables, sl)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q[..., :48], kp[..., :48], vp[..., :48], tables, sl)
    with pytest.raises(ValueError, match="q \\[R, h, d\\]"):
        paged_attention(q[:, None], kp, vp, tables, sl)    # multi-query
    with pytest.raises(ValueError, match="seq_lens"):
        paged_attention(q, kp, vp, tables, sl[:2])
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kp, vp, tables, sl, window=0)
    with pytest.raises(ValueError, match="at most 32"):
        paged_attention(torch.zeros(4, 66, 64), torch.zeros(40, 8, 2, 64),
                        torch.zeros(40, 8, 2, 64), tables, sl)
