"""The MoE families and MLA served on a tp (x ep) mesh, on one card: the
world-one checks of ``chip_smoke.py``'s phase ``tp-moe`` at small sizes,
and the kernels at ERNIE-4.5-21B-A3B's per-rank shapes. Every test here
is marked ``gpu`` and skips, from its fixture, on a machine without a
CUDA card. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_tp_moe_gpu.py -m gpu --noconftest

(a) The flash forward, decode and ragged kernels at a rank's heads of
ERNIE-4.5-21B-A3B (20 query heads over 4 kv heads) at tp 2 (10 / 2) and
tp 4 (5 / 1), and the quant kernel at its per-rank projections (column
shards, and row shards reading their blocks of the whole scales table),
each against its plain version on its tensor-core route; (b) a small
bf16 ERNIE-shaped MoE model (head_dim 128, group 5 as ERNIE's ranks at
tp 4) built sharded on a world-one ``{"tp": 1, "ep": 1}`` NCCL mesh and
bound once: ``generate()`` and the ``PagedEngine`` bit for bit the same
weights unsharded; a small bf16 DeepSeek-V3-style model the same through
``generate()`` and ``mtp_speculative_generate``. The card machine has one GPU: tp and ep
> 1 are proved on the CPU (tests/test_torch_tp_moe.py)."""
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
# a rank's (query heads, kv heads) of ERNIE-4.5-21B-A3B at tp 2 and tp 4
HEADS = [(10, 2), (5, 1)]
# ERNIE-4.5-21B-A3B's per-rank projections: (din of the rank's codes,
# dout, scale blocks of the whole table, block offset); rows at tp 2, 4
QUANT = [(2560, 1280, 20, 0), (2560, 640, 20, 0), (2560, 256, 20, 0),
         (2560, 128, 20, 0), (2560, 6144, 20, 0), (2560, 3072, 20, 0),
         (1280, 2560, 20, 10), (640, 2560, 20, 15), (6144, 2560, 96, 48),
         (3072, 2560, 96, 72)]


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
def test_flash_and_decode_at_ernie_rank_heads(cuda_card, h, kvh):
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
def test_ragged_at_ernie_rank_heads(cuda_card, h, kvh, T):
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
    assert windows == 1      # group 5: 25 query rows fit one launch
    assert _routed(ragged_paged_attention, "mma") == (n0[0] + windows,
                                                      n0[1])
    ref = ragged_paged_attention_plain(q, kp, vp, tables, lens)
    assert _err(out, ref) <= TOL_BF16
    assert torch.equal(out, ragged_paged_attention(q, kp, vp, tables, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("din,dout,blocks,offset", QUANT)
def test_quant_at_ernie_rank_projections(cuda_card, din, dout, blocks,
                                         offset):
    """int8 codes of a rank's shard, m = 4: a column shard over its own
    scales, a row shard through the wrapper's offset into the whole
    table."""
    from paddle_tpu_torch.quant import quantize_blockwise
    g = _gen(cuda_card, din + dout)
    w = torch.randn(din, dout, generator=g, device=cuda_card) * 0.02
    codes, scales = quantize_blockwise(w, 8)
    nb = din // 128
    whole = torch.cat([torch.rand(offset, dout, generator=g,
                                  device=cuda_card).to(scales.dtype),
                       scales,
                       torch.rand(blocks - offset - nb, dout, generator=g,
                                  device=cuda_card).to(scales.dtype)])
    x = torch.randn(4, din, generator=g, device=cuda_card).to(torch.bfloat16)
    n0 = _routed(quant_matmul, "mma")
    got = quant_matmul(x, codes, whole, 8, block_offset=offset)
    assert _routed(quant_matmul, "mma") == (n0[0] + 1, n0[1])
    ref = quant_matmul_plain(x, codes, scales, 8).float()
    bad = (got.float() - ref).abs() > TOL_QUANT_REL * ref.abs() \
        + TOL_QUANT_ABS * ref.abs().max()
    assert not bool(bad.any())


@pytest.fixture
def world_one(cuda_card):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    mesh = env.init_parallel_env({"tp": 1, "ep": 1})
    yield mesh
    env.clear_mesh()
    dist.destroy_process_group()


def _ernie_small(dev):
    cfg = ptt.models.ernie45_moe_tiny(
        vocab_size=512, hidden_size=640, intermediate_size=1024,
        moe_intermediate_size=256, num_experts=8, num_experts_per_tok=2,
        num_attention_heads=5, num_key_value_heads=1,
        max_position_embeddings=512, dtype=torch.bfloat16)
    return ptt.models.Ernie45MoeForCausalLM(
        cfg, device=dev, generator=ptt.make_generator(0, dev))


def _deepseek_small(dev):
    from paddle_tpu_torch.models import deepseek_v2 as ds
    cfg = ds.deepseek_v2_tiny(
        vocab_size=512, hidden_size=256, num_attention_heads=4,
        kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, num_experts=8, n_group=4, topk_group=2,
        scoring="sigmoid", group_score_mode="top2_sum", norm_topk_prob=True,
        num_nextn_predict_layers=1, max_position_embeddings=512,
        dtype=torch.bfloat16)
    return ds.DeepseekV2ForCausalLM(cfg, device=dev,
                                    generator=ptt.make_generator(1, dev))


def _sharded(build, dev):
    from paddle_tpu_torch.parallel.sharding import (bind_static, local,
                                                    shard_layer,
                                                    sharded_build)
    with sharded_build(fsdp_min_size=1 << 30):
        m = build(dev)
    shard_layer(m, fsdp_min_size=1 << 30)
    bound = bind_static(m)
    for name, p in m.named_parameters():
        assert bound[name].data_ptr() == local(p).data_ptr(), name
    return m


@pytest.mark.gpu
def test_world_one_sharded_ernie_is_the_unsharded(world_one):
    from paddle_tpu_torch.generation.paged import PagedEngine
    dev = world_one.device
    plain, sharded = _ernie_small(dev), _sharded(_ernie_small, dev)
    ids = torch.randint(0, 512, (2, 96), device=dev,
                        generator=ptt.make_generator(2, dev))
    assert torch.equal(ptt.generate(plain, ids, max_new_tokens=24),
                       ptt.generate(sharded, ids, max_new_tokens=24))
    rs = np.random.RandomState(0)
    subs = [(f"r{i}", rs.randint(0, 512, int(rs.randint(20, 90))).tolist(),
             dict(max_new_tokens=12,
                  **(dict(temperature=0.8, seed=4) if i == 2 else {})))
            for i in range(4)]
    kw = dict(max_slots=4, num_blocks=64, block_size=16,
              max_blocks_per_seq=8)
    out = []
    for m in (plain, sharded):
        eng = PagedEngine(m, **kw)
        for rid, p, k in subs:
            eng.submit(rid, p, **k)
        out.append((eng.run(), dict(eng.logprobs)))
    assert out[0] == out[1]
    assert not eng.rank_check and eng.pools[0][0].shape[2] == 1


@pytest.mark.gpu
def test_world_one_sharded_deepseek_is_the_unsharded(world_one):
    from paddle_tpu_torch.generation.speculative import \
        mtp_speculative_generate
    dev = world_one.device
    plain, sharded = _deepseek_small(dev), _sharded(_deepseek_small, dev)
    ids = torch.randint(0, 512, (2, 64), device=dev,
                        generator=ptt.make_generator(3, dev))
    a = ptt.generate(plain, ids, max_new_tokens=16)
    assert torch.equal(a, ptt.generate(sharded, ids, max_new_tokens=16))
    assert torch.equal(
        mtp_speculative_generate(plain, ids, max_new_tokens=16),
        mtp_speculative_generate(sharded, ids, max_new_tokens=16))
    # the latent cache is whole on a rank: no heads to split
    assert sharded.init_kv_caches(1, 4)[0][0].shape == (1, 4, 64)
