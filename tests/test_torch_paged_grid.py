"""The port's grid paged attention and the ``PADDLE_TPU_PAGED_ATTN``
routing against the JAX package's, on the CPU.

The plain version (what the wrapper runs on CPU tensors) is held against
``paged_attention_pallas`` in interpret mode, fp32, same numpy inputs,
within 1e-5: idle rows (seq_len 0), block edges, a sliding window, GQA
groups 1, 2 and 4, and table slots past each row's live count that hold
other rows' blocks. ``paged_decode_attention`` under every value of
``PADDLE_TPU_PAGED_ATTN`` is held against the JAX function under the same
value, and must take the same route (multi-query rows under ``grid``
excepted: the port sends them to the ragged kernel); the port's ``PagedEngine`` under
``grid`` must give the JAX engine's greedy tokens.
The mma kernel's static rules are pinned here too: its route depends on
the dtype and head_dim alone, its chunk / cluster / heads-per-block split
on the static shapes and the SM count alone, and its plain spec of which
(row, chunk) blocks stream K/V (``grid_live_chunks``) is held against the
ragged kernel's chunk schedule at one query a row and against the TPU
kernel's own ``run`` predicate and index-map clamp, recomputed in numpy.
``test_torch_kernels_gpu.py`` holds the CUDA kernels against the plain
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
    CLUSTER, MAX_CLUSTER, grid_live_chunks, grid_route, grid_split,
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
    build_chunk_schedule

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
    ("grid", 1, "grid"), ("grid", 3, "ragged"), ("ragged", 1, "ragged"),
    ("ragged", 3, "ragged"), ("dense", 1, "dense"), ("bogus", 1, "ragged"),
    (None, 3, "ragged"),
], ids=["grid", "grid-multi-query", "ragged", "ragged-multi-query",
        "dense", "unknown-value", "unset-multi-query"])
@pytest.mark.parametrize("window", [None, 6], ids=["full", "window"])
def test_paged_decode_attention_routes_as_jax(monkeypatch, routes, mode, T,
                                              route, window):
    """The variable is read at call time, value for value as the JAX
    package reads it, except that multi-query rows under ``grid`` take
    the ragged kernel where the JAX package takes its dense gather; both
    packages give the same numbers."""
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


def test_grid_route_depends_on_dtype_and_head_dim_alone():
    for dtype in (torch.bfloat16, torch.float16):
        assert grid_route(dtype, 64) == grid_route(dtype, 128) == "mma"
        assert grid_route(dtype, 256) == "simt"
    assert {grid_route(torch.float32, d) for d in (64, 128, 256)} == {
        "simt"}


def test_grid_split_depends_on_static_shapes_and_sm_count_alone():
    """At the paged engine's geometry (16 rows, 64 slots, 8 kv heads, 132
    SMs) a row is a cluster of 8 chunks of 8 slots, 2 kv heads a block
    (512 blocks); one row of 512 slots takes 16 chunks of 32 slots, one kv
    head a block. Every split covers the table with a power-of-two number
    of chunks, no more than the table needs."""
    assert grid_split(16, 64, 8, 132) == (8, 8, 2)
    assert grid_split(1, 512, 8, 132) == (16, 32, 1)
    assert grid_split(64, 64, 8, 132) == (8, 8, 4)
    assert grid_split(16, 64, 8, 132, cluster=16) == (16, 4, 4)
    for R, M, kvh, sms in ((1, 1, 1, 132), (1, 5, 8, 132), (4, 63, 2, 132),
                           (3, 7, 1, 16), (256, 64, 8, 132),
                           (16, 2048, 8, 78)):
        for cluster in (None, 1, 2, CLUSTER, MAX_CLUSTER):
            chunks, C, hpb = grid_split(R, M, kvh, sms, cluster)
            assert (chunks, C, hpb) == grid_split(R, M, kvh, sms, cluster)
            assert chunks & (chunks - 1) == 0
            assert chunks <= (cluster or MAX_CLUSTER)
            assert chunks * C >= M and (chunks == 1 or chunks // 2 < M)
            assert hpb in (1, 2, 4) and hpb <= kvh
    with pytest.raises(ValueError, match="cluster"):
        grid_split(16, 64, 8, 132, cluster=32)


def _live_case(seed, R, M, B):
    rs = np.random.RandomState(seed)
    lens = rs.randint(0, M * B, R).astype(np.int32)
    lens[:3] = [0, M * B - 1, B - 1]
    return torch.from_numpy(np.zeros((R, M), np.int32)), \
        torch.from_numpy(lens)


@pytest.mark.parametrize("B,M,C", [(8, 12, 3), (16, 64, 8), (16, 63, 8),
                                   (4, 5, 1), (16, 64, 4)])
@pytest.mark.parametrize("window", [None, 1, 20, 100, 5000],
                         ids=["none", "w1", "w20", "w100", "wide"])
def test_grid_live_chunks_match_the_chunk_schedule(B, M, C, window):
    """The (row, chunk) blocks the grid kernel streams are the live items
    of the ragged kernel's chunk schedule at one query a row (itself the
    JAX package's ``build_schedule`` merged C blocks at a time); chunks
    past the table are never live."""
    tbl, sl = _live_case(B + M + C, 9, M, B)
    chunks = -(-M // C) + 2
    live = grid_live_chunks(sl, M, chunks, C, B, window=window)
    row, chunk, ok = build_chunk_schedule(tbl, sl, C, B, window=window)
    want = {(r, c) for r, c, v in zip(row.tolist(), chunk.tolist(),
                                      ok.tolist()) if v}
    got = {tuple(x) for x in torch.nonzero(live).tolist()}
    assert got == want
    assert live.sum(dim=1).min() >= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("window", [None, 1, 7, 50, 5000],
                         ids=["none", "w1", "w7", "w50", "wide"])
def test_grid_live_chunks_match_the_tpu_predicate(seed, B, window):
    """The TPU kernel (``paged_attention.py:58-61``) runs grid step (r, ti)
    when ti B < valid and, with a window, (ti + 1) B > valid - window; its
    K/V index map (``:110-118``) clamps every step to [lo, last], so the
    blocks it fetches are the ones it runs. A chunk of C blocks is live in
    the grid kernel exactly when one of its blocks runs there."""
    rs = np.random.RandomState(seed)
    R, M = 12, 20
    lens = rs.randint(0, M * B, R)
    lens[:2] = [0, M * B - 1]
    for C in (1, 3, 4, 8):
        chunks = -(-M // C)
        live = grid_live_chunks(torch.from_numpy(lens.astype(np.int32)), M,
                                chunks, C, B, window=window).numpy()
        for r in range(R):
            valid = int(lens[r]) + 1
            ti = np.arange(M)
            run = ti * B < valid
            if window is not None:
                run &= (ti + 1) * B > valid - window
            last = max(-(-valid // B) - 1, 0)
            lo = 0 if window is None else max(valid - window, 0) // B
            fetched = set(np.clip(ti, lo, last).tolist())
            assert fetched == set(ti[run].tolist())
            want = [bool(run[j * C:(j + 1) * C].any())
                    for j in range(chunks)]
            assert live[r].tolist() == want, (r, C)
