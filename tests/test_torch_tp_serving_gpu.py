"""Tensor-parallel serving on one card, at the per-rank shapes tp serving
launches: ``chip_smoke.py``'s phase ``tp`` (a) and (b) at small sizes.
Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_tp_serving_gpu.py -m gpu --noconftest

(a) The flash forward, decode and ragged kernels at a rank's head counts
under Llama-3-70B at tp 2, 4 and 8 and Llama-3-8B at tp 8, and the quant
kernel at a row rank's offset into the whole scales table, each against
its plain version on its tensor-core route; (b) a small bf16 Llama
(head_dim 128, so every kernel runs) sharded on a world-one NCCL mesh
and bound once: ``generate()`` and the ``PagedEngine`` (chunked prefill,
the prefix cache, a sampled row, then speculative ticks) bit for bit the
same weights unsharded. The card machine has one GPU: tp > 1 is proved
on the CPU (tests/test_torch_tp_serving.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    query_windows, ragged_paged_attention, ragged_paged_attention_plain)

# bf16 kernel against its plain version (chip_smoke.TOL_BF16)
TOL_BF16 = 2e-2
# the quant kernel: one bf16 rounding of fp32 sums in another order
TOL_QUANT_REL = 2.0 ** -7
TOL_QUANT_ABS = 1e-3
# a rank's (query heads, kv heads): 70B at tp 2, 4, 8; 8B at tp 8
HEADS = [(32, 4), (16, 2), (8, 1), (4, 1)]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _routed(fn, route):
    return fn.launches_by_route[route], fn.launches_by_route["simt"]


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", HEADS)
def test_flash_and_decode_at_rank_heads(cuda_card, h, kvh):
    g = _gen(cuda_card)
    bf = torch.bfloat16
    q = (torch.randn(2, 256, h, 128, generator=g, device=cuda_card)
         * 0.5).to(bf)
    k = (torch.randn(2, 256, kvh, 128, generator=g, device=cuda_card)
         * 0.5).to(bf)
    v = torch.randn(2, 256, kvh, 128, generator=g, device=cuda_card).to(bf)
    n0 = _routed(flash_attention_fwd, "wgmma")
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    assert _routed(flash_attention_fwd, "wgmma") == (n0[0] + 1, n0[1])
    assert _err(out, flash_attention_fwd_plain(q, k, v, causal=True)[0]) \
        <= TOL_BF16
    qd = torch.randn(4, h, 128, generator=g, device=cuda_card).to(bf)
    ck = torch.randn(4, 320, kvh, 128, generator=g, device=cuda_card).to(bf)
    cv = torch.randn(4, 320, kvh, 128, generator=g, device=cuda_card).to(bf)
    ci = torch.tensor([319, 200, 17, 0], dtype=torch.int32,
                      device=cuda_card)
    n0 = _routed(decode_attention_fwd, "mma")
    out = decode_attention_fwd(qd, ck, cv, ci)
    assert _routed(decode_attention_fwd, "mma") == (n0[0] + 1, n0[1])
    assert _err(out, decode_attention_fwd_plain(qd, ck, cv, ci)) <= TOL_BF16


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", HEADS)
@pytest.mark.parametrize("T", [1, 5])
def test_ragged_at_rank_heads(cuda_card, h, kvh, T):
    g = _gen(cuda_card, T)
    bf, R, P, B, M = torch.bfloat16, 8, 129, 16, 8
    q = torch.randn(R, T, h, 128, generator=g, device=cuda_card).to(bf)
    kp = torch.randn(P, B, kvh, 128, generator=g, device=cuda_card).to(bf)
    vp = torch.randn(P, B, kvh, 128, generator=g, device=cuda_card).to(bf)
    tables = torch.stack([torch.randperm(P - 1, generator=g,
                                         device=cuda_card)[:M] + 1
                          for _ in range(R)]).to(torch.int32)
    lens = torch.tensor([0, 1, 15, 16, 40, 77, 100, M * B - T],
                        dtype=torch.int32, device=cuda_card)
    tables[lens == 0] = 0
    n0 = _routed(ragged_paged_attention, "mma")
    out = ragged_paged_attention(q, kp, vp, tables, lens)
    windows = len(query_windows(T, h // kvh))
    assert _routed(ragged_paged_attention, "mma") == (n0[0] + windows,
                                                      n0[1])
    ref = ragged_paged_attention_plain(q, kp, vp, tables, lens)
    assert _err(out, ref) <= TOL_BF16
    assert torch.equal(out, ragged_paged_attention(q, kp, vp, tables, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [4, 16])
def test_quant_row_rank_offset_matches_plain(cuda_card, bits, m):
    """A row rank's codes (1024 of 4096 input rows, rank 3) through the
    wrapper's offset into the whole [32, 512] scales table."""
    from paddle_tpu_torch.quant import quantize_blockwise
    g = _gen(cuda_card, bits + m)
    w = torch.randn(4096, 512, generator=g, device=cuda_card) * 0.02
    codes, scales = quantize_blockwise(w, bits)
    rows = 1024 if bits == 8 else 512
    mine = codes[3 * rows:4 * rows].contiguous()
    x = torch.randn(m, 1024, generator=g, device=cuda_card).to(torch.bfloat16)
    n0 = _routed(quant_matmul, "mma")
    got = quant_matmul(x, mine, scales, bits, block_offset=24)
    assert _routed(quant_matmul, "mma") == (n0[0] + 1, n0[1])
    ref = quant_matmul_plain(x, mine, scales[24:32], bits).float()
    bad = (got.float() - ref).abs() > TOL_QUANT_REL * ref.abs() \
        + TOL_QUANT_ABS * ref.abs().max()
    assert not bool(bad.any())


@pytest.fixture
def tp_one(cuda_card):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    mesh = env.init_parallel_env({"tp": 1})
    yield mesh
    env.clear_mesh()
    dist.destroy_process_group()


def _small(dev):
    cfg = ptt.llama_tiny(vocab_size=512, hidden_size=512,
                         intermediate_size=1024, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=512,
                         dtype=torch.bfloat16)
    return ptt.LlamaForCausalLM(cfg, device=dev,
                                generator=ptt.make_generator(0, dev))


def _serve(eng, subs):
    for rid, ids, kw in subs:
        eng.submit(rid, ids, **kw)
    return eng.run(), dict(eng.logprobs)


@pytest.mark.gpu
def test_world_one_sharded_serving_is_the_unsharded(tp_one):
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    dev = tp_one.device
    plain = _small(dev)
    with sharded_build(fsdp_min_size=1 << 30):
        sharded = _small(dev)
    shard_layer(sharded, fsdp_min_size=1 << 30)
    bound = bind_static(sharded)
    for name, p in sharded.named_parameters():
        assert bound[name].data_ptr() == local(p).data_ptr(), name
    ids = torch.randint(0, 512, (2, 96), device=dev,
                        generator=ptt.make_generator(1, dev))
    a = ptt.generate(plain, ids, max_new_tokens=24)
    b = ptt.generate(sharded, ids, max_new_tokens=24)
    assert torch.equal(a, b)
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 512, 64).tolist()
    subs = [(f"r{i}", prefix + rs.randint(0, 512, 20).tolist(),
             dict(max_new_tokens=12,
                  **(dict(temperature=0.8, seed=4) if i == 2 else {})))
            for i in range(4)]
    for spec in (0, 4):
        kw = dict(max_slots=4, num_blocks=64, block_size=16,
                  max_blocks_per_seq=8, chunk_prefill_tokens=32,
                  enable_prefix_cache=True, spec_tokens=spec)
        ra = _serve(PagedEngine(plain, **kw), subs)
        eng = PagedEngine(sharded, **kw)
        rb = _serve(eng, subs)
        assert ra == rb, spec
        assert not eng.rank_check
        assert eng.pools[0][0].shape[2] == 2
