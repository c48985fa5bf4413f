"""The port's ragged paged attention and its dispatch against the JAX
package's, on the CPU.

The plain version (what the wrapper runs on CPU tensors) is held against
``ragged_paged_attention_pallas`` in interpret mode, fp32, same numpy
inputs, within 1e-5. ``paged_decode_attention`` is held against the JAX
package's dense paged route on both of its own routes (the gate admits:
the plain ragged version; the gate refuses: the dense gather).
``test_torch_kernels_gpu.py`` holds the CUDA kernel against the plain
version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.generation.paged import PagedKV as JaxPagedKV
from paddle_tpu.generation.paged import \
    paged_decode_attention as jax_paged_decode_attention
from paddle_tpu.generation.paged import paged_decode_write as jax_write
from paddle_tpu.generation.paged import paged_prefill_write as jax_prefill
from paddle_tpu.ops.pallas.ragged_paged_attention import \
    build_schedule as jax_build_schedule
from paddle_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_attention_pallas
from paddle_tpu.ops.pallas.ragged_paged_attention import \
    schedule_capacity as jax_schedule_capacity
from paddle_tpu_torch.generation import paged as port_paged
from paddle_tpu_torch.generation.paged import (PagedKV,
                                               paged_decode_attention,
                                               paged_decode_write,
                                               paged_prefill_write)
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    build_chunk_schedule, build_schedule, ragged_chunk_blocks,
    ragged_paged_attention, ragged_paged_attention_plain, ragged_route,
    schedule_capacity)

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
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)


@pytest.fixture
def jax_dense(monkeypatch):
    """The JAX side takes its dense paged route; the variable is set
    around its call only, since the port reads it too (and would then
    take its own dense gather instead of the route the case names)."""
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)

    def run(fn, *args, **kw):
        monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "dense")
        try:
            return fn(*args, **kw)
        finally:
            monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN")
    return run


def _case(seed, R=4, T=1, h=4, kvh=2, d=64, B=8, M=6, P=24, lens=None):
    """Random q and pools; each row's table a random draw of distinct
    physical blocks (never block 0), rows 1 and 2 sharing row 0's first
    blocks as prefix sharing does; idle rows (len 0) keep an all-zero
    table."""
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
    tables[lens == 0] = 0
    return q, kp, vp, tables, lens


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,window,group,lens", [
    (1, None, 2, [0, 7, 8, 47]),            # idle row, block edges, full
    (1, 5, 2, [0, 7, 8, 47]),
    (1, None, 1, [3, 16, 30, 47]),
    (1, 13, 4, [1, 9, 24, 40]),
    (3, None, 2, [0, 7, 8, 45]),            # multi-query, full row
    (3, 6, 4, [2, 8, 15, 45]),
], ids=["decode", "window", "mha", "group4-window", "multi-query",
        "multi-query-window-group4"])
def test_ragged_plain_matches_pallas(pallas_interpret, T, window, group,
                                     lens):
    q, kp, vp, tables, sl = _case(T + group, T=T, h=2 * group, lens=lens)
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = ragged_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(sl), scale, window=window)
    got = ragged_paged_attention(*_torch(q, kp, vp, tables, sl),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_FP32,
                               rtol=0)


@pytest.mark.parametrize("T,window,h", [(1, None, 4), (1, 6, 4),
                                        (2, None, 4), (1, None, 3)],
                         ids=["kernel", "kernel-window", "kernel-multi",
                              "dense-gather"])
def test_paged_decode_attention_matches_jax_dense(jax_dense, monkeypatch,
                                                  T, window, h):
    """Both routes of the port's dispatch, under the default
    ``PADDLE_TPU_PAGED_ATTN``, against the JAX package's dense paged
    route. h = 3 over 3 kv heads at d = 48 is refused by the gate
    (head_dim), so it takes the dense gather; the others take the ragged
    kernel's wrapper."""
    d = 48 if h == 3 else 64
    kvh = 3 if h == 3 else 2
    q, kp, vp, tables, sl = _case(11, T=T, h=h, kvh=kvh, d=d,
                                  lens=[0, 8, 21, 44])
    q4 = q if T > 1 else q[:, None]
    ref = jax_dense(
        jax_paged_decode_attention,
        jnp.asarray(q4), JaxPagedKV(jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(tables), jnp.asarray(sl)),
        window=window)
    tq, tkp, tvp, ttb, tsl = _torch(q4, kp, vp, tables, sl)
    assert port_attn.use_paged_kernel(tq, tkp) == (h != 3)
    calls = []
    monkeypatch.setattr(port_paged, "ragged_paged_attention",
                        lambda *a, **kw: calls.append(1)
                        or ragged_paged_attention(*a, **kw))
    got = paged_decode_attention(tq, PagedKV(tkp, tvp, ttb, tsl),
                                 window=window)
    assert len(calls) == (h != 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_FP32,
                               rtol=0)


def test_gate_takes_shapes_only():
    kp = torch.zeros(4, 8, 2, 64)
    assert port_attn.use_paged_kernel(torch.zeros(2, 1, 4, 64), kp)
    assert port_attn.use_paged_kernel(torch.zeros(2, 16, 4, 64), kp)
    # any T: the wrapper splits a window of more than 32 query rows
    assert port_attn.use_paged_kernel(torch.zeros(2, 17, 4, 64), kp)
    assert not port_attn.use_paged_kernel(torch.zeros(2, 1, 66, 64), kp)
    assert not port_attn.use_paged_kernel(torch.zeros(2, 1, 3, 64), kp)
    assert not port_attn.use_paged_kernel(torch.zeros(2, 1, 4, 96),
                                          torch.zeros(4, 8, 2, 96))
    # B % 8 and d % 128 were Mosaic's rules: not inherited
    assert port_attn.use_paged_kernel(torch.zeros(2, 1, 4, 64),
                                      torch.zeros(4, 5, 2, 64))


@pytest.mark.parametrize("T", [1, 3])
def test_paged_writes_match_jax(T):
    """Decode writes (T = 1 and T > 1, positions past M to the garbage
    block) and prefill writes (pads to the garbage block) leave the same
    pools as the JAX package's, and write the port's pools in place."""
    q, kp, vp, tables, sl = _case(5, T=T, lens=[0, 7, 8, 46])
    rs = np.random.RandomState(6)
    k = rs.randn(4, T, 2, 64).astype(np.float32)
    v = rs.randn(4, T, 2, 64).astype(np.float32)
    ref = jax_write(JaxPagedKV(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(tables), jnp.asarray(sl)),
                    jnp.asarray(k), jnp.asarray(v))
    tkp, tvp = _torch(kp.copy(), vp.copy())
    pk = paged_decode_write(PagedKV(tkp, tvp, *_torch(tables, sl)),
                            *_torch(k, v))
    assert pk.kp is tkp
    live = np.ones(kp.shape[0], bool)
    live[0] = False                 # colliding garbage writes: unordered
    np.testing.assert_array_equal(tkp.numpy()[live],
                                  np.asarray(ref.kp)[live])
    np.testing.assert_array_equal(tvp.numpy()[live],
                                  np.asarray(ref.vp)[live])

    kc = rs.randn(1, 16, 2, 64).astype(np.float32)
    lens0 = np.array([11], np.int32)
    positions = np.arange(8, 24, dtype=np.int32)
    ref = jax_prefill(JaxPagedKV(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(tables[:1]),
                                 jnp.asarray(lens0)),
                      jnp.asarray(kc), jnp.asarray(kc),
                      positions=jnp.asarray(positions))
    tkp, tvp = _torch(kp.copy(), vp.copy())
    paged_prefill_write(PagedKV(tkp, tvp, *_torch(tables[:1], lens0)),
                        *_torch(kc, kc),
                        positions=torch.from_numpy(positions))
    np.testing.assert_array_equal(tkp.numpy()[live],
                                  np.asarray(ref.kp)[live])


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, kp, vp, tables, sl = _torch(*_case(2))
    n = ragged_paged_attention.launches
    out = ragged_paged_attention(q, kp, vp, tables, sl)
    assert torch.equal(out, ragged_paged_attention_plain(q, kp, vp, tables,
                                                         sl))
    assert ragged_paged_attention.launches == n


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, tables, sl = _torch(*_case(3))
    with pytest.raises(TypeError, match="int32"):
        ragged_paged_attention(q, kp, vp, tables.long(), sl)
    with pytest.raises(TypeError):
        ragged_paged_attention(q, kp.double(), vp, tables, sl)
    with pytest.raises(ValueError, match="head_dim"):
        ragged_paged_attention(q[..., :48], kp[..., :48], vp[..., :48],
                               tables, sl)
    # more query heads a kv head than one launch holds (a long window of
    # queries is split instead)
    with pytest.raises(ValueError, match="query rows"):
        ragged_paged_attention(torch.zeros(4, 1, 66, 64), kp, vp, tables,
                               sl)
    with pytest.raises(ValueError, match="seq_lens"):
        ragged_paged_attention(q, kp, vp, tables, sl[:2])
    with pytest.raises(ValueError, match="window"):
        ragged_paged_attention(q, kp, vp, tables, sl, window=0)


# ------------------------------------------------- the mma kernel's work list
def _schedule_case(seed, q_len, R=8, M=6, B=8, P=24):
    """seq_lens with idle rows, block edges and a row at M * B - q_len;
    tables of distinct random blocks, rows 1 and 2 sharing row 0's first
    half (prefix sharing), idle rows all zeros."""
    rs = np.random.RandomState(seed)
    lens = np.array([0, B - 1, B, M * B - q_len] + list(
        rs.randint(0, M * B - q_len, R - 4)), np.int32)
    tables = np.stack([rs.permutation(np.arange(1, P))[:M]
                       for _ in range(R)]).astype(np.int32)
    tables[1:3, :M // 2] = tables[0, :M // 2]
    tables[lens == 0] = 0
    return tables, lens


@pytest.mark.parametrize("q_len", [1, 4])
@pytest.mark.parametrize("window", [None, 1, 100, 5000],
                         ids=["none", "w1", "w100", "wide"])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_schedule_bitwise_equals_jax(seed, window, q_len):
    """The port's plain ``build_schedule`` and ``schedule_capacity`` give
    the JAX functions' arrays bit for bit."""
    tables, lens = _schedule_case(seed, q_len, B=16)
    R, M = tables.shape
    S = schedule_capacity(R, M, 24)
    assert S == jax_schedule_capacity(R, M, 24)
    want = jax_build_schedule(jnp.asarray(tables), jnp.asarray(lens), S, 16,
                              window=window, q_len=q_len)
    got = build_schedule(torch.from_numpy(tables), torch.from_numpy(lens),
                         S, 16, window=window, q_len=q_len)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _runs(row, idx, live, C):
    """The live steps of a schedule as (row, idx // C) runs, in order."""
    out = []
    for r, i, v in zip(row.tolist(), idx.tolist(), live.tolist()):
        if v and (not out or out[-1] != (r, i // C)):
            out.append((r, i // C))
    return out


@pytest.mark.parametrize("C", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("q_len", [1, 4])
@pytest.mark.parametrize("window", [None, 1, 20], ids=["none", "w1", "w20"])
def test_chunk_schedule_is_the_block_schedule_merged_run_by_run(C, q_len,
                                                                window):
    """The mma kernel's list of (row, chunk) items: the block schedule's
    live steps grouped C blocks at a time, in the same order, live-first
    in a capacity of R x ceil(M / C), the dead tail repeating the last
    live item; every row has at least one item."""
    tables, lens = _schedule_case(3, q_len)
    R, M = tables.shape
    tbl, sl = torch.from_numpy(tables), torch.from_numpy(lens)
    blocks = build_schedule(tbl, sl, schedule_capacity(R, M, 24), 8,
                            window=window, q_len=q_len)
    row, chunk, live = build_chunk_schedule(tbl, sl, C, 8, window=window,
                                            q_len=q_len)
    assert row.shape == (R * -(-M // C),)
    assert _runs(row, chunk, live, 1) == _runs(*blocks, C)
    n = int(live.sum())
    assert live[:n].all() and not live[n:].any()
    assert (row[n:] == row[n - 1]).all() and (chunk[n:] == chunk[n - 1]).all()
    assert sorted(set(row[:n].tolist())) == list(range(R))


def test_chunk_blocks_depend_on_static_shapes_alone():
    """At the paged engine's geometry (16 rows, 64 blocks of 16, 8 kv
    heads, 132 SMs) a chunk is 4 blocks (64 positions): 512 blocks, live
    or not. More rows take longer chunks; a row never has more than 32."""
    assert ragged_chunk_blocks(16, 64, 16, 8, 132) == 4
    assert ragged_chunk_blocks(64, 64, 16, 8, 132) > 4
    for R, M, B, kvh in ((1, 2048, 16, 8), (4, 16, 8, 2), (256, 64, 16, 8)):
        c = ragged_chunk_blocks(R, M, B, kvh, 132)
        assert 1 <= c <= M and -(-M // c) <= 32


def test_ragged_route_depends_on_dtype_and_head_dim_alone():
    for dtype in (torch.bfloat16, torch.float16):
        assert ragged_route(dtype, 64) == ragged_route(dtype, 128) == "mma"
        assert ragged_route(dtype, 256) == "simt"
    assert {ragged_route(torch.float32, d) for d in (64, 128, 256)} == {
        "simt"}
