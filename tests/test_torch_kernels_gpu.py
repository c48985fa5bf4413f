"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain, decode_splits)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttentionFunction, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels import paged_attention as grid_module
from paddle_tpu_torch.ops.kernels.paged_attention import (
    grid_route, grid_split, paged_attention, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain,
                                                       quant_route)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain, ragged_route)

pytestmark = pytest.mark.gpu

# bf16: kernel and plain version round p and out to bf16 at the same
# points but sum in another order, and round p against another running
# max; 2e-2 covers that for outputs of magnitude up to ~2. fp16: the same
# roundings with 3 more bits of significand, about 2.5 fp16 steps at
# magnitude 2 as 2e-2 is for bf16. fp32: the same sums in another order.
ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
DTYPE_IDS = ["bf16", "fp16", "fp32"]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    return torch.device("cuda")


def _randn(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


def _want_route(dtype, d):
    """The route the wrappers must take: tensor cores for bf16 or fp16 at d
    64 or 128, the CUDA-core kernel for fp32 and for d 256."""
    return ("wgmma" if dtype in (torch.bfloat16, torch.float16)
            and d in (64, 128) else "simt")


@pytest.mark.parametrize("case", [
    dict(b=2, s=256, h=8, kv=2, d=128, causal=True),
    dict(b=1, s=200, h=4, kv=4, d=64, causal=False),
    dict(b=1, s=256, h=4, kv=1, d=256, causal=True, window=70),
    dict(b=2, s=256, h=4, kv=2, d=64, causal=True, seg=True),
    dict(b=1, s=128, sk=256, h=8, kv=2, d=128, causal=True),
    dict(b=1, s=384, h=4, kv=1, d=128, causal=True, window=100),
], ids=["gqa-causal", "ragged-full", "d256-window", "segments",
        "longer-keys", "window"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_flash_kernel_matches_plain(cuda_card, case, dtype):
    rs = np.random.RandomState(0)
    b, s, h, kv, d = (case[k] for k in ("b", "s", "h", "kv", "d"))
    sk = case.get("sk", s)
    q = _randn(rs, b, s, h, d, scale=0.5).to(cuda_card, dtype)
    k = _randn(rs, b, sk, kv, d, scale=0.5).to(cuda_card, dtype)
    v = _randn(rs, b, sk, kv, d).to(cuda_card, dtype)
    seg = None
    if case.get("seg"):
        seg = torch.ones(b, s, dtype=torch.int32)
        seg[:, 100:] = 2
        seg[:, -8:] = 0
        seg = seg.to(cuda_card)
    kw = dict(causal=case["causal"], window=case.get("window"),
              segment_ids=seg)
    route = _want_route(dtype, d)
    n = flash_attention_fwd.launches
    by_route = dict(flash_attention_fwd.launches_by_route)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == n + 1
    by_route[route] += 1
    assert flash_attention_fwd.launches_by_route == by_route
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def _decode_case(dev, dtype, b=4, T=640, h=32, kv=8, d=128, seed=0):
    rs = np.random.RandomState(seed)
    return [_randn(rs, *shape).to(dev, dtype)
            for shape in ((b, h, d), (b, T, kv, d), (b, T, kv, d))]


def _chunk(T, b, kv):
    """Positions per split of the decode kernel on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-T // decode_splits(T, b * kv, sms))


# cache_index (from the split length c) and window: the first position;
# the last of split 0 and the first of split 1 (one live split, then two);
# a window from inside split 0 into split 1, and one inside split 1 alone;
# the whole cache
DECODE_EDGES = [(lambda c: 0, None), (lambda c: c - 1, None),
                (lambda c: c, None), (lambda c: c + 10, 20),
                (lambda c: 2 * c - 1, 5), (lambda c: 639, None),
                (lambda c: 639, 100)]
DECODE_EDGE_IDS = ["first", "split0-end", "split1-start", "window-across",
                   "window-inside", "last", "last-window"]


@pytest.mark.parametrize("edge", DECODE_EDGES, ids=DECODE_EDGE_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_decode_kernel_matches_plain(cuda_card, edge, dtype):
    """The decode kernel at Llama-3-8B's decode shape (q [4, 32, 128],
    cache [4, 640, 8, 128]) at cache indices on the edges of its splits,
    with and without a window: one launch, within ATOL of the plain
    version."""
    q, ck, cv = _decode_case(cuda_card, dtype)
    ci, window = edge[0](_chunk(640, 4, 8)), edge[1]
    n = decode_attention_fwd.launches
    by_route = dict(decode_attention_fwd.launches_by_route)
    out = decode_attention_fwd(q, ck, cv, ci, window=window)
    torch.cuda.synchronize()
    assert decode_attention_fwd.launches == n + 1
    by_route["simt" if dtype == torch.float32 else "mma"] += 1
    assert decode_attention_fwd.launches_by_route == by_route
    ref = decode_attention_fwd_plain(q, ck, cv, ci, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("d,group,T", [(64, 2, 300), (256, 1, 130),
                                       (128, 8, 8192), (64, 3, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_decode_kernel_other_shapes(cuda_card, d, group, T, dtype):
    """Other head dims and groups (3 is held by the kernels for 4), and
    one row over a long cache (many splits merged), at the last position
    and with a window."""
    q, ck, cv = _decode_case(cuda_card, dtype, b=1 + (T < 1000), T=T,
                             h=2 * group, kv=2, d=d, seed=d)
    for ci, window in ((T - 1, None), (T // 2, 37)):
        out = decode_attention_fwd(q, ck, cv, ci, window=window)
        torch.cuda.synchronize()
        ref = decode_attention_fwd_plain(q, ck, cv, ci, window=window)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=ATOL[dtype], rtol=0)


def test_decode_kernel_repeats_bitwise(cuda_card):
    """The splits merge in split order whatever the order in which the
    blocks finish: two calls give the same bits, at cache indices with
    several live splits."""
    q, ck, cv = _decode_case(cuda_card, torch.bfloat16, seed=3)
    for ci, window in ((639, None), (400, 250)):
        a = decode_attention_fwd(q, ck, cv, ci, window=window)
        b = decode_attention_fwd(q, ck, cv, ci, window=window)
        assert torch.equal(a, b)


def test_decode_kernel_replays_in_a_cuda_graph(cuda_card):
    """One call at a fixed cache_index captured in a CUDA graph; the
    cache and the query changed in place between replays; each replay
    agrees with the plain version on the new values (the counters the
    merge uses are left at 0 by every launch)."""
    q, ck, cv = _decode_case(cuda_card, torch.bfloat16, seed=4)
    decode_attention_fwd(q, ck, cv, 600)             # warm-up, uncaptured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, ck, cv, 600)
    for seed in (1, 2):
        for t, new in zip((q, ck, cv), _decode_case(cuda_card,
                                                    torch.bfloat16,
                                                    seed=seed)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        ref = decode_attention_fwd_plain(q, ck, cv, 600)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0)


def _paged_case(rs, R, T, h, kvh, d, B, M, P, lens):
    """Pools of random values, tables of distinct random physical blocks
    per row (never block 0), rows 1 and 2 sharing row 0's first blocks as
    prefix sharing does, and the given seq_lens (idle rows keep an
    all-zero table)."""
    q = _randn(rs, R, T, h, d) if T > 1 else _randn(rs, R, h, d)
    kp = _randn(rs, P, B, kvh, d)
    vp = _randn(rs, P, B, kvh, d)
    tables = np.zeros((R, M), np.int32)
    for r in range(R):
        tables[r] = rs.permutation(np.arange(1, P))[:M]
    tables[1:3, :M // 2] = tables[0, :M // 2]
    lens = np.asarray(lens, np.int32)
    tables[lens == 0] = 0
    return q, kp, vp, torch.from_numpy(tables), torch.from_numpy(lens)


def _ragged_on(dev, dtype, q, kp, vp, tbl, sl):
    return [x.to(dev) for x in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                                tbl, sl)]


def _ragged_checked(args, window, dtype):
    """One counted call on its route, held against the plain version."""
    route = ragged_route(dtype, args[0].shape[-1])
    n = ragged_paged_attention.launches
    by_route = dict(ragged_paged_attention.launches_by_route)
    out = ragged_paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == n + 1
    by_route[route] += 1
    assert ragged_paged_attention.launches_by_route == by_route
    ref = ragged_paged_attention_plain(*args, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    return out


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 1, 100, 5000],
                         ids=["full", "window1", "window100", "window-wide"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ragged_kernel_matches_plain(cuda_card, T, window, dtype):
    """The paged engine's geometry: idle rows, block edges, a row at
    M * B - T, rows 1 and 2 borrowing row 0's blocks; bf16 and fp16 on
    the mma route, fp32 on simt."""
    rs = np.random.RandomState(T)
    R, h, kvh, d, B, M, P = 16, 32, 8, 128, 16, 64, 1025
    lens = [0, B - 1, B, M * B - T, 1, 100, 257, 640] + list(
        rs.randint(1, M * B - T, R - 8))
    args = _ragged_on(cuda_card, dtype, *_paged_case(
        rs, R, T, h, kvh, d, B, M, P, lens))
    _ragged_checked(args, window, dtype)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ragged_kernel_one_long_row(cuda_card, T, dtype):
    """Imbalance: one row at M * B - T, every other row short; its chunks
    run side by side and merge in order."""
    rs = np.random.RandomState(20 + T)
    R, h, kvh, d, B, M, P = 16, 32, 8, 128, 16, 64, 1025
    lens = [M * B - T] + list(rs.randint(0, 20, R - 1))
    args = _ragged_on(cuda_card, dtype, *_paged_case(
        rs, R, T, h, kvh, d, B, M, P, lens))
    _ragged_checked(args, None, dtype)


@pytest.mark.parametrize("d,group,T", [(64, 1, 1), (64, 8, 4), (128, 1, 2),
                                       (128, 8, 4), (256, 4, 1),
                                       (256, 8, 2)])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ragged_kernel_other_head_dims(cuda_card, d, group, T, dtype):
    """Group 1, 4 and 8, head_dim 64, 128 and 256, a small pool with
    blocks of 8 and a window: d 256 takes simt in every dtype."""
    rs = np.random.RandomState(d + group + T)
    R, kvh, B, M, P = 4, 2, 8, 16, 80
    args = _ragged_on(cuda_card, dtype, *_paged_case(
        rs, R, T, kvh * group, kvh, d, B, M, P, [0, 7, 8, M * B - T]))
    _ragged_checked(args, None, dtype)
    _ragged_checked(args, 20, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_ragged_kernel_repeats_bitwise(cuda_card, dtype):
    """Chunks merge in chunk order whatever the order in which the blocks
    finish: two calls give the same bits."""
    rs = np.random.RandomState(31)
    R, h, kvh, d, B, M, P = 16, 32, 8, 128, 16, 64, 1025
    for T in (1, 4):
        args = _ragged_on(cuda_card, dtype, *_paged_case(
            rs, R, T, h, kvh, d, B, M, P, rs.randint(0, M * B - T, R)))
        a = ragged_paged_attention(*args, window=300)
        b = ragged_paged_attention(*args, window=300)
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [1, 4])
def test_ragged_kernel_replays_in_a_cuda_graph(cuda_card, T):
    """One call captured in a CUDA graph; seq_lens and table contents
    changed in place between replays (which changes every row's chunk
    count); each replay agrees with the plain version on the new values
    (the counters the merge uses are left at 0 by every launch)."""
    rs = np.random.RandomState(7)
    R, h, kvh, d, B, M, P = 16, 32, 8, 128, 16, 64, 1025
    q, kp, vp, tbl, sl = _paged_case(rs, R, T, h, kvh, d, B, M, P,
                                     rs.randint(1, 900, R))
    q, kp, vp = (x.to(cuda_card, torch.bfloat16) for x in (q, kp, vp))
    tbl, sl = tbl.to(cuda_card), sl.to(cuda_card)
    ragged_paged_attention(q, kp, vp, tbl, sl)      # warm-up, uncaptured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ragged_paged_attention(q, kp, vp, tbl, sl)
    for seed in (1, 2):
        rs2 = np.random.RandomState(seed)
        _, _, _, tbl2, sl2 = _paged_case(rs2, R, T, h, kvh, d, B, M, P,
                                         rs2.randint(0, M * B - T, R))
        tbl.copy_(tbl2)
        sl.copy_(sl2)
        graph.replay()
        torch.cuda.synchronize()
        ref = ragged_paged_attention_plain(q, kp, vp, tbl, sl)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0)


# backward, bf16: kernel and plain version round p and ds at the same
# points and sum in another order; relative to the largest reference
# gradient, as the magnitudes grow with the sequence. fp16 rounds the same
# values with 3 more bits.
BWD_RTOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2, torch.float32: 1e-4}


def _bwd_case(dev, dtype, b, sq, sk, h, kv, d, seg=False, seed=0):
    rs = np.random.RandomState(seed)
    q = _randn(rs, b, sq, h, d, scale=0.5).to(dev, dtype)
    k = _randn(rs, b, sk, kv, d, scale=0.5).to(dev, dtype)
    v = _randn(rs, b, sk, kv, d).to(dev, dtype)
    g = _randn(rs, b, sq, h, d).to(dev, dtype)
    ids = None
    if seg:
        ids = torch.zeros(b, sq, dtype=torch.int32)
        ids[:, :sq // 3], ids[:, sq // 3:sq // 2] = 1, 2
        ids[:, sq // 2:sq - 24] = 3
        ids = ids.to(dev)
    return q, k, v, g, ids


def _assert_grads_close(got, want, dtype):
    for a, b in zip(got, want):
        tol = BWD_RTOL[dtype] * max(float(b.float().abs().max()), 1.0)
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", [
    dict(b=2, sq=256, sk=256, h=8, kv=2, d=128, causal=True),
    dict(b=1, sq=256, sk=256, h=8, kv=2, d=128, causal=True, window=70),
    dict(b=2, sq=256, sk=256, h=4, kv=2, d=64, causal=True, seg=True),
    dict(b=1, sq=128, sk=128, h=4, kv=4, d=64, causal=False),
    dict(b=1, sq=128, sk=256, h=4, kv=1, d=128, causal=True),
    dict(b=1, sq=192, sk=192, h=4, kv=1, d=256, causal=True),
    dict(b=1, sq=200, sk=200, h=4, kv=2, d=64, causal=False),
], ids=["gqa-causal", "window", "segments", "full", "longer-keys", "d256",
        "ragged-full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_flash_bwd_kernels_match_plain(cuda_card, case, dtype):
    """dq and dk/dv kernels against the plain FA-2 formula on the same
    out and lse; each kernel launches once, on the route of its dtype and
    head dim (wgmma for bf16 and fp16 at d 64 and 128)."""
    q, k, v, g, seg = _bwd_case(cuda_card, dtype, case["b"], case["sq"],
                                case["sk"], case["h"], case["kv"], case["d"],
                                case.get("seg", False))
    kw = dict(causal=case["causal"], window=case.get("window"),
              segment_ids=seg)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    n = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    fns = (flash_attention_bwd_dq, flash_attention_bwd_dkv)
    by_route = [dict(fn.launches_by_route) for fn in fns]
    got = flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    for fn, before in zip(fns, by_route):
        before[_want_route(dtype, case["d"])] += 1
        assert fn.launches_by_route == before
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    _assert_grads_close(got, want, dtype)


def test_flash_bwd_kernels_repeat_bitwise(cuda_card):
    """No atomics: two runs on the same inputs give the same bits."""
    q, k, v, g, _ = _bwd_case(cuda_card, torch.bfloat16, 2, 512, 512, 8, 2,
                              128, seed=3)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    a = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    b = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(causal=True, window=300),
                                dict(causal=False, seg=True)],
                         ids=["window", "segments"])
def test_flash_dkv_wgmma_repeats_bitwise(cuda_card, kw):
    """The tensor-core dk/dv kernel at GQA group 4 (each block sums four
    query heads): two launches give the same bits, and both took the
    wgmma route."""
    kw = dict(kw)
    q, k, v, g, seg = _bwd_case(cuda_card, torch.bfloat16, 2, 640, 640, 16,
                                4, 128, kw.pop("seg", False), seed=5)
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, **kw)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    n = flash_attention_bwd_dkv.launches_by_route["wgmma"]
    args = (q, k, v, g, lse, delta, seg)
    opts = dict(causal=kw["causal"], scale=128 ** -0.5,
                window=kw.get("window"))
    a = flash_attention_bwd_dkv(*args, **opts)
    b = flash_attention_bwd_dkv(*args, **opts)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dkv.launches_by_route["wgmma"] == n + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(causal=True, window=300),
                                dict(causal=False, seg=True)],
                         ids=["window", "segments"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_flash_dq_wgmma_repeats_bitwise(cuda_card, kw, dtype):
    """The tensor-core dq kernel at GQA group 4: each dq element is summed
    by one block in a fixed order, so two launches give the same bits,
    and both took the wgmma route."""
    kw = dict(kw)
    q, k, v, g, seg = _bwd_case(cuda_card, dtype, 2, 640, 640, 16, 4, 128,
                                kw.pop("seg", False), seed=6)
    out, lse = flash_attention_fwd(q, k, v, segment_ids=seg, **kw)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    n = flash_attention_bwd_dq.launches_by_route["wgmma"]
    args = (q, k, v, g, lse, delta, seg)
    opts = dict(causal=kw["causal"], scale=128 ** -0.5,
                window=kw.get("window"))
    a = flash_attention_bwd_dq(*args, **opts)
    b = flash_attention_bwd_dq(*args, **opts)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches_by_route["wgmma"] == n + 2
    assert torch.equal(a, b)
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, segment_ids=seg,
                                     **kw)[0]
    _assert_grads_close([a], [want], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_flash_function_grads_on_the_card(cuda_card, dtype):
    """``FlashAttentionFunction`` on CUDA tensors: every input gets a
    non-null gradient from the kernels, equal to the plain backward's on
    the CPU copies of the same values."""
    q, k, v, g, _ = _bwd_case(cuda_card, dtype, 1, 256, 256, 8, 2, 64,
                              seed=4)
    fns = (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
    before = [dict(fn.launches_by_route) for fn in fns]
    grads = []
    for dev in (cuda_card, torch.device("cpu")):
        xs = [t.to(dev).detach().requires_grad_() for t in (q, k, v)]
        out = FlashAttentionFunction.apply(*xs, True)
        assert type(out.grad_fn).__name__ == \
            "FlashAttentionFunctionBackward"
        out.backward(g.to(dev))
        assert all(x.grad is not None for x in xs)
        grads.append([x.grad.cpu() for x in xs])
    for fn, counts in zip(fns, before):     # the card's run, by route
        counts[_want_route(dtype, 64)] += 1
        assert fn.launches_by_route == counts
    _assert_grads_close(grads[0], grads[1], dtype)


# ------------------------------------------------------------- quant matmul
# Llama-3-8B's projections: q/o 4096 -> 4096, k/v 4096 -> 1024, gate/up
# 4096 -> 14336, down 14336 -> 4096
QUANT_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# kernel vs plain version: both dequantize in fp32 and sum in fp32, in
# another order (split partials, warp partials), then round once to the
# output type. bf16: the two fp32 sums may round to neighbouring bf16
# values (rtol 2^-7, one bf16 step); fp32: the sums' order alone. The
# atol share covers elements near 0 from cancelling sums.
QUANT_TOL = {torch.bfloat16: (2.0 ** -7, 1e-3),
             torch.float16: (2.0 ** -10, 1e-3),
             torch.float32: (1e-5, 1e-5)}


def _quant_case(dev, dtype, m, din, dout, bits, seed=0):
    """Activations and random codes / scales made on the card: int8 codes
    in [-127, 127], int4 bytes of any value (both nibbles in [-8, 7], the
    kernel must sign-extend -8 too), bf16 scales of the magnitude
    quantize_blockwise gives 0.05-scale weights."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(m, din, generator=g, device=dev).to(dtype)
    rows = din if bits == 8 else din // 2
    lo, hi = (-127, 128) if bits == 8 else (-128, 128)
    q = torch.randint(lo, hi, (rows, dout), generator=g, device=dev,
                      dtype=torch.int16).to(torch.int8)
    s = (torch.rand(din // 128, dout, generator=g, device=dev) * 2e-3
         + 1e-4).to(torch.bfloat16)
    return x, q, s


def _assert_quant_close(out, ref, dtype):
    rtol, atol_share = QUANT_TOL[dtype]
    atol = atol_share * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


QUANT_MS = [1, 3, 4, 8, 9, 16, 17, 32, 33, 63, 64]


def _quant_checked(x, q, s, bits):
    """One counted call on its route, held against the plain version."""
    route = quant_route(x.dtype)
    n = quant_matmul.launches
    by_route = dict(quant_matmul.launches_by_route)
    out = quant_matmul(x, q, s, bits)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n + 1
    by_route[route] += 1
    assert quant_matmul.launches_by_route == by_route
    assert out.dtype == x.dtype and out.shape == (x.shape[0], q.shape[1])
    _assert_quant_close(out, quant_matmul_plain(x, q, s, bits), x.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("m", QUANT_MS)
@pytest.mark.parametrize("din,dout", QUANT_SHAPES,
                         ids=[f"{a}x{b}" for a, b in QUANT_SHAPES])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_kernel_matches_plain(cuda_card, bits, din, dout, m, dtype):
    """Every Llama-3-8B projection, m from 1 to 64 (partial n-tiles of 8
    included), on the mma route."""
    x, q, s = _quant_case(cuda_card, dtype, m, din, dout, bits, seed=m)
    _quant_checked(x, q, s, bits)


@pytest.mark.parametrize("m", [1, 2, 5, 64])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_kernel_fp32(cuda_card, bits, m):
    """fp32 activations on the simt route."""
    x, q, s = _quant_case(cuda_card, torch.float32, m, 1024, 640, bits,
                          seed=m)
    _quant_checked(x, q, s, bits)


@pytest.mark.parametrize("m", [1, 4, 16, 64])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_kernel_fp16(cuda_card, bits, m):
    """fp16 activations with the bf16 scales: fp32 dequant and sums, the
    output rounded once to fp16; the k/v shape splits the contraction."""
    x, q, s = _quant_case(cuda_card, torch.float16, m, 4096, 1024, bits,
                          seed=m)
    _quant_checked(x, q, s, bits)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_kernel_repeats_bitwise(cuda_card, bits):
    """The k/v shape splits the contraction and the splits merge in split
    order whatever the order in which the blocks finish: two calls give
    the same bits."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for m in (4, 16, 64):
            x, q, s = _quant_case(cuda_card, dtype, m, 4096, 1024, bits,
                                  seed=9)
            a = quant_matmul(x, q, s, bits)
            b = quant_matmul(x, q, s, bits)
            assert torch.equal(a, b)


@pytest.mark.parametrize("m", [4, 16, 64])
def test_quant_kernel_one_launch_and_only_the_output(cuda_card, m):
    """The mma route makes one kernel launch a call (the splits merge in
    it) and, once its per-card scratch exists, allocates only the
    output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, q, s = _quant_case(cuda_card, torch.bfloat16, m, 4096, 1024, 8)
    quant_matmul(x, q, s, 8)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = quant_matmul(x, q, s, 8)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_card) - before == (
        out.numel() * out.element_size() + 511) // 512 * 512
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert kernels and all("qmm_mma_kernel" in k for k in kernels), kernels
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_kernel_replays_in_a_cuda_graph(cuda_card, bits):
    """One split call captured in a CUDA graph; x changed in place between
    replays; each replay agrees with the plain version on the new values
    (the split counters are left at 0 by every launch)."""
    x, q, s = _quant_case(cuda_card, torch.bfloat16, 16, 4096, 1024, bits)
    quant_matmul(x, q, s, bits)                      # warm-up, uncaptured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant_matmul(x, q, s, bits)
    for seed in (1, 2):
        x.copy_(_quant_case(cuda_card, torch.bfloat16, 16, 4096, 1024, bits,
                            seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        _assert_quant_close(out, quant_matmul_plain(x, q, s, bits),
                            torch.bfloat16)


def test_quant_kernel_rejects_bad_shapes(cuda_card):
    x, q, s = _quant_case(cuda_card, torch.bfloat16, 4, 256, 256, 8)
    with pytest.raises(ValueError, match="do not fit"):
        quant_matmul(x[:, :200], q[:200], s)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant_matmul(x, q[:, :200].contiguous(), s[:, :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        quant_matmul(x.cpu(), q, s)


# ------------------------------------------------------- grid paged attention
def _grid_args(dev, dtype, rs, lens, h=32, kvh=8, d=128, B=16, M=64, P=1025):
    q, kp, vp, tbl, sl = _paged_case(rs, len(lens), 1, h, kvh, d, B, M, P,
                                     lens)
    return [x.to(dev) for x in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                                tbl, sl)]


GRID_LENS = [0, 15, 16, 1023, 1, 100, 257, 640, 31, 32, 500, 999, 2, 47,
             48, 700]


def _grid_dead(tbl, sl, B):
    """(tables whose slots past each row's live count hold an index far
    outside the pool, which the kernel must never read; the same tables
    with those slots zeroed, for the plain version, which gathers whole
    tables)."""
    M = tbl.shape[1]
    live = (sl.long() + B) // B
    dead = torch.arange(M, device=tbl.device)[None, :] >= live[:, None]
    return tbl.masked_fill(dead, 1 << 30), tbl.masked_fill(dead, 0)


def _grid_checked(args, window, dtype, B):
    """One counted call on its route, with dead table slots set to 2^30,
    held against the plain version."""
    q, kp, vp, tbl, sl = args
    bad, clean = _grid_dead(tbl, sl, B)
    route = grid_route(dtype, q.shape[-1])
    n = paged_attention.launches
    by_route = dict(paged_attention.launches_by_route)
    out = paged_attention(q, kp, vp, bad, sl, window=window)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    by_route[route] += 1
    assert paged_attention.launches_by_route == by_route
    ref = paged_attention_plain(q, kp, vp, clean, sl, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    return out


@pytest.mark.parametrize("window", [None, 100, 7, 1, 5000],
                         ids=["full", "window", "short-window", "window1",
                              "window-wide"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_grid_kernel_matches_plain(cuda_card, dtype, window):
    """The paged engine's geometry (16 rows, 32 heads over 8 kv heads, d
    128, blocks of 16, 64 slots a row), lens with 0, block edges and a row
    at M * B - 1; every slot past a row's live count holds an index far
    outside the pool, which the kernel must never read. bf16 and fp16 on
    the mma route, fp32 on simt."""
    rs = np.random.RandomState(11)
    args = _grid_args(cuda_card, dtype, rs, GRID_LENS)
    _grid_checked(args, window, dtype, 16)


@pytest.mark.parametrize("case", ["alone", "among-short"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_grid_kernel_one_long_row(cuda_card, dtype, case):
    """One row of 8192 positions (512 slots of 16) alone, and one row at
    M * B - 1 among short ones: a cluster's chunks all live beside
    clusters with one live chunk."""
    rs = np.random.RandomState(21)
    if case == "alone":
        args = _grid_args(cuda_card, dtype, rs, [8191], M=512, P=513)
    else:
        args = _grid_args(cuda_card, dtype, rs,
                          [1023] + list(rs.randint(0, 20, 15)))
    for window in (None, 1000):
        _grid_checked(args, window, dtype, 16)


@pytest.mark.parametrize("M", [5, 63])
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_grid_kernel_uneven_chunks(cuda_card, dtype, R, M):
    """M not a multiple of the cluster: the last chunk runs past the
    table (M 63), whole chunks lie past it (M 5); a single row."""
    rs = np.random.RandomState(M + R)
    lens = ([M * 16 - 1] + list(rs.randint(0, M * 16, R - 1)))[:R]
    args = _grid_args(cuda_card, dtype, rs, lens, M=M, P=4 * M + 1)
    for window in (None, 20):
        _grid_checked(args, window, dtype, 16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_grid_kernel_groups(cuda_card, dtype, group, d):
    """Query heads per kv head 1, 4, 8, 16 and 32 (1, 2 and 4 tiles of 8
    query rows; at d 128 and 32 rows the query sits in shared memory) at
    head_dim 64 and 128, a small pool with blocks of 8, with and without a
    window."""
    rs = np.random.RandomState(d + group)
    args = _grid_args(cuda_card, dtype, rs, [0, 7, 8, 127], h=2 * group,
                      kvh=2, d=d, B=8, M=16, P=80)
    for window in (None, 20):
        _grid_checked(args, window, dtype, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_grid_kernel_repeats_bitwise(cuda_card, dtype):
    """Each row's chunks merge in chunk order, whatever the order in which
    the cluster's blocks finish: two calls give the same bits."""
    rs = np.random.RandomState(32)
    args = _grid_args(cuda_card, dtype, rs, rs.randint(0, 1024, 16))
    for window in (None, 300):
        a = paged_attention(*args, window=window)
        b = paged_attention(*args, window=window)
        assert torch.equal(a, b)


def test_grid_kernel_cluster_of_16(cuda_card):
    """The mma kernel with a row's chunks in a cluster of 16 (beyond the
    portable 8) and with one kv head a block: the same function."""
    rs = np.random.RandomState(33)
    q, kp, vp, tbl, sl = _grid_args(cuda_card, torch.bfloat16, rs,
                                    GRID_LENS)
    ref = paged_attention_plain(q, kp, vp, tbl, sl, window=100)
    for split in (grid_split(16, 64, 8, 132, cluster=16), (8, 8, 1)):
        out = grid_module._launch("mma", q, kp, vp, tbl, sl, None, 100,
                                  split)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0)


def _graph_node_types(graph):
    """The node types of a captured CUDA graph (its handle is a CUgraph),
    read through the driver API: 0 is a kernel node."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        types.append(t.value)
    return types


def test_grid_kernel_one_launch_and_only_the_output(cuda_card):
    """The mma route makes one kernel launch a call (the chunks merge in
    their cluster): a captured call is a graph of one kernel node. An
    eager call allocates only the output. (torch.profiler dropped this
    cluster launch's device event in some sessions, so the launch is
    counted in the graph.)"""
    rs = np.random.RandomState(34)
    args = _grid_args(cuda_card, torch.bfloat16, rs, GRID_LENS)
    paged_attention(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_card)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_card) - before == (
        out.numel() * out.element_size() + 511) // 512 * 512
    n = paged_attention.launches_by_route["mma"]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        paged_attention(*args)
    assert paged_attention.launches_by_route["mma"] == n + 1
    assert _graph_node_types(graph) == [0]


@pytest.mark.parametrize("d,group", [(64, 2), (256, 1), (128, 16)])
def test_grid_kernel_other_head_dims(cuda_card, d, group):
    rs = np.random.RandomState(d)
    args = _grid_args(cuda_card, torch.float32, rs, [0, 7, 8, 127],
                      h=2 * group, kvh=2, d=d, B=8, M=16, P=80)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, paged_attention_plain(*args),
                               atol=ATOL[torch.float32], rtol=0)


def test_grid_kernel_equals_ragged_bitwise_and_repeats(cuda_card):
    """fp32, where the ragged kernel keeps its first design (simt): without
    a window the grid kernel keeps its tiles and order of sums, so the two
    agree bit for bit, and each call repeats. In bf16 the ragged kernel
    runs split-KV on the tensor cores: the two agree within the bf16
    tolerance, and the grid kernel still repeats."""
    rs = np.random.RandomState(12)
    args = _grid_args(cuda_card, torch.float32, rs, GRID_LENS)
    a = paged_attention(*args)
    b = paged_attention(*args)
    c = ragged_paged_attention(*args)
    assert torch.equal(a, b)
    assert torch.equal(a, c)
    args = [x.to(torch.bfloat16) if x.is_floating_point() else x
            for x in args]
    a = paged_attention(*args)
    assert torch.equal(a, paged_attention(*args))
    torch.testing.assert_close(a.float(),
                               ragged_paged_attention(*args).float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_grid_kernel_replays_in_a_cuda_graph(cuda_card, dtype):
    """One call captured in a CUDA graph; seq_lens and table contents
    changed in place between replays (which changes which chunks are
    live); each replay agrees with the plain version on the new values."""
    rs = np.random.RandomState(13)
    q, kp, vp, tbl, sl = _grid_args(cuda_card, dtype, rs,
                                    rs.randint(1, 900, 16))
    paged_attention(q, kp, vp, tbl, sl, window=200)  # warm-up, uncaptured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention(q, kp, vp, tbl, sl, window=200)
    for seed in (1, 2):
        rs2 = np.random.RandomState(seed)
        _, _, _, tbl2, sl2 = _grid_args(cuda_card, dtype, rs2,
                                        rs2.randint(0, 64 * 16 - 1, 16))
        tbl.copy_(tbl2)
        sl.copy_(sl2)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention_plain(q, kp, vp, tbl, sl, window=200)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=ATOL[dtype], rtol=0)
