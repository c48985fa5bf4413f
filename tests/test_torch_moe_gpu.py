"""The MoE families on the card. Every test here is marked ``gpu`` and
skips, from its fixture, on a machine without a CUDA card. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_moe_gpu.py -m gpu --noconftest

- The routing path reads nothing on the host: an MoE layer's forward
  runs under ``torch.cuda.set_sync_debug_mode("error")`` and is captured
  into a CUDA graph (a capture fails on a synchronizing call), whose
  replay gives the eager output bit for bit.
- The decode step of a small bf16 ERNIE-4.5-shaped model (20 query heads
  on 4 kv heads, head_dim 128: GQA group 5) and of a DeepSeek-V2-shaped
  one (MLA's absorbed decode) is captured, and ``generate``'s streams,
  greedy and sampled, equal the uncaptured step's (``eager_steps``) bit
  for bit; so does ``mtp_speculative_generate``'s.
- Idle rows' colliding garbage-block writes carry the last row's K/V,
  and the ERNIE-shaped ``PagedEngine``'s graphed tick equals its host
  tick bit for bit (idle rows route beside live ones).
- The flash forward, decode and ragged paged kernels at GQA groups 5 and
  1 (head_dim 128) against their plain versions, within the tolerances
  of ``tests/test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import models
from paddle_tpu_torch.generation import eager_steps
from paddle_tpu_torch.generation.paged import (PagedEngine, PagedKV,
                                               paged_decode_write)
from paddle_tpu_torch.generation.speculative import mtp_speculative_generate
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)
from paddle_tpu_torch.parallel.moe import MoEMLP

pytestmark = pytest.mark.gpu

# as tests/test_torch_kernels_gpu.py states them
ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
DTYPES = [torch.bfloat16, torch.float16]
DTYPE_IDS = ["bf16", "fp16"]

# ERNIE-4.5-21B-A3B's attention shape (20/4 heads, head_dim 128) and
# routing (top-6 of 64, two shared experts, layer 0 dense), narrow
ERNIE_SMALL = dict(vocab_size=1024, hidden_size=2560, intermediate_size=512,
                   moe_intermediate_size=128, num_hidden_layers=3,
                   num_experts=64, num_experts_per_tok=6,
                   num_shared_experts=2, shared_expert_intermediate_size=256,
                   max_position_embeddings=1024, dtype=torch.bfloat16)
DSV2_SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  q_lora_rank=None, kv_lora_rank=128, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64, num_experts=16,
                  num_experts_per_tok=4, moe_intermediate_size=128,
                  num_shared_experts=1, n_group=4, topk_group=2,
                  scoring="sigmoid", group_score_mode="top2_sum",
                  norm_topk_prob=True, num_nextn_predict_layers=1,
                  max_position_embeddings=1024, dtype=torch.bfloat16)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    return torch.device("cuda")


def _ids(dev, b, n, seed=1, vocab=1024):
    return torch.randint(0, vocab, (b, n), device=dev,
                         generator=ptt.make_generator(seed, dev))


@pytest.mark.parametrize("kw", [
    dict(num_experts=64, top_k=6, num_shared_experts=2),
    dict(num_experts=16, top_k=4, num_shared_experts=1, n_group=4,
         topk_group=2, scoring="sigmoid", group_score_mode="top2_sum",
         norm_topk_prob=True, use_shared_expert_gate=True)],
    ids=["softmax", "grouped-sigmoid"])
@pytest.mark.parametrize("tokens", [16, 2048])
def test_routing_path_syncs_nothing_and_captures(cuda_card, kw, tokens):
    mlp = MoEMLP(256, 128, **kw, device=cuda_card, dtype=torch.bfloat16,
                 generator=ptt.make_generator(3, cuda_card))
    x = torch.randn(tokens, 256, device=cuda_card,
                    generator=ptt.make_generator(4, cuda_card)) \
        .to(torch.bfloat16)
    torch.cuda.synchronize()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = mlp(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mlp(x)                                   # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = mlp(x)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _ernie(dev, seed=0):
    cfg = models.Ernie45MoeConfig(**ERNIE_SMALL)
    return models.Ernie45MoeForCausalLM(cfg, device=dev,
                                        generator=ptt.make_generator(seed,
                                                                     dev))


def _deepseek(dev, seed=0):
    return models.DeepseekV2ForCausalLM(
        models.DeepseekV2Config(**DSV2_SMALL), device=dev,
        generator=ptt.make_generator(seed, dev))


@pytest.mark.parametrize("family", ["ernie", "deepseek"])
def test_moe_decode_step_graphed_equals_eager(cuda_card, family):
    """``generate``'s decode step captured once and replayed: greedy and
    sampled streams bit for bit the uncaptured step's; the ERNIE step's
    graph holds one decode kernel a layer (group 5 on the mma route)."""
    model = (_ernie if family == "ernie" else _deepseek)(cuda_card)
    ids = _ids(cuda_card, 4, 128)
    greedy = ptt.GenerationConfig(max_new_tokens=24)
    sampled = ptt.GenerationConfig(max_new_tokens=24, do_sample=True,
                                   temperature=0.8, top_p=0.95)
    n = decode_attention_fwd.launches
    out = ptt.generate(model, ids, greedy)
    with eager_steps():
        ref = ptt.generate(model, ids, greedy)
    assert torch.equal(out, ref)
    if family == "ernie":   # 23 steps x 3 layers, from the graph's replays
        assert decode_attention_fwd.launches - n == 2 * 23 * 3
    s = ptt.generate(model, ids, sampled,
                     generator=ptt.make_generator(5, cuda_card))
    with eager_steps():
        s_ref = ptt.generate(model, ids, sampled,
                             generator=ptt.make_generator(5, cuda_card))
    assert torch.equal(s, s_ref)
    prog = next(p for k, p in model._gen_exec_cache.programs.items()
                if k[:4] == ("generate", 4, 152, False))
    assert prog.step.graph is not None


def test_mtp_speculative_graphed_equals_eager(cuda_card):
    model = _deepseek(cuda_card)
    ids = _ids(cuda_card, 2, 64, seed=6)
    out, stats = mtp_speculative_generate(model, ids, max_new_tokens=20,
                                          num_draft_tokens=3,
                                          return_stats=True)
    with eager_steps():
        ref, ref_stats = mtp_speculative_generate(
            model, ids, max_new_tokens=20, num_draft_tokens=3,
            return_stats=True)
    assert torch.equal(out, ref) and stats == ref_stats
    # the rows decode one at a time (MoE), each through one captured
    # iteration program
    prog = next(p for k, p in model._gen_exec_cache.programs.items()
                if k[0] == "mtp")
    assert prog.b == 1 and prog.step.graph is not None


def test_colliding_paged_writes_carry_the_last_rows_kv(cuda_card):
    """Idle rows all write position 0 of the garbage block; on the card
    the block must hold the last row's K/V every time, as the
    sequential write gives (the rows then read it back and route)."""
    R, kvh, d = 16, 4, 128
    kp = torch.zeros(8, 16, kvh, d, device=cuda_card, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    pk = PagedKV(kp, vp, torch.zeros(R, 4, dtype=torch.int32,
                                     device=cuda_card),
                 torch.zeros(R, dtype=torch.int32, device=cuda_card))
    g = ptt.make_generator(8, cuda_card)
    for _ in range(50):
        k = torch.randn(R, 1, kvh, d, device=cuda_card, generator=g)
        v = torch.randn(R, 1, kvh, d, device=cuda_card, generator=g)
        paged_decode_write(pk, k, v)
        assert torch.equal(kp[0, 0], k[-1, 0].to(kp.dtype))
        assert torch.equal(vp[0, 0], v[-1, 0].to(vp.dtype))


def test_moe_engine_graphed_tick_equals_host_tick(cuda_card):
    """The ERNIE-shaped model in the PagedEngine at its defaults
    (graphed ticks) against the host tick (``fused_tick=False``):
    requests finish at different ticks, so idle rows route beside live
    ones; tokens and logprobs bit for bit, and a rerun the same."""
    model = _ernie(cuda_card)
    rs = np.random.RandomState(9)
    subs = [(f"r{i}", torch.from_numpy(rs.randint(0, 1024, rs.randint(
        8, 60))), dict(max_new_tokens=int(rs.randint(4, 24))))
        for i in range(12)]

    def serve(eng):
        eng.results.clear()
        eng.logprobs.clear()
        for i, (rid, ids, kw) in enumerate(subs):
            eng.submit(rid, ids, **kw)
            if i % 3 == 2:
                eng.step()
        return eng.run(), dict(eng.logprobs)

    kw = dict(max_slots=8, block_size=16, max_blocks_per_seq=8)
    eng = PagedEngine(model, **kw)
    got = serve(eng)
    assert serve(eng) == got
    assert serve(PagedEngine(model, fused_tick=False, **kw)) == got
    assert len(eng._graphs) and all(eng._graphs[k].graph is not None
                                    for k in eng._graphs)


def _randn(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("group", [5, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_flash_at_group(cuda_card, group, dtype):
    rs = np.random.RandomState(group)
    b, s, kv, d = 2, 512, 4, 128
    q = _randn(rs, b, s, kv * group, d, scale=0.5).to(cuda_card, dtype)
    k = _randn(rs, b, s, kv, d, scale=0.5).to(cuda_card, dtype)
    v = _randn(rs, b, s, kv, d).to(cuda_card, dtype)
    n = flash_attention_fwd.launches_by_route["wgmma"]
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches_by_route["wgmma"] == n + 1
    ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("group", [5, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_decode_at_group(cuda_card, group, dtype):
    """Per-row device indices over a [4, 576, 4, 128] cache."""
    rs = np.random.RandomState(10 + group)
    b, T, kv, d = 4, 576, 4, 128
    q = _randn(rs, b, kv * group, d).to(cuda_card, dtype)
    ck = _randn(rs, b, T, kv, d).to(cuda_card, dtype)
    cv = _randn(rs, b, T, kv, d).to(cuda_card, dtype)
    ci = torch.tensor([0, 200, 511, 575], dtype=torch.int32,
                      device=cuda_card)
    n = decode_attention_fwd.launches_by_route["mma"]
    out = decode_attention_fwd(q, ck, cv, ci)
    torch.cuda.synchronize()
    assert decode_attention_fwd.launches_by_route["mma"] == n + 1
    ref = decode_attention_fwd_plain(q, ck, cv, ci)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("group", [5, 1])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ragged_at_group(cuda_card, group, T, dtype):
    """The engine's geometry (16 rows, blocks of 16, 64 a row), idle
    rows and a row at the table's end, kv 4."""
    rs = np.random.RandomState(20 + group + T)
    R, kvh, d, B, M, P = 16, 4, 128, 16, 64, 1025
    lens = np.array([0, B - 1, B, M * B - T] + list(
        rs.randint(0, M * B - T, R - 4)), np.int32)
    tables = np.zeros((R, M), np.int32)
    for r in range(R):
        tables[r] = rs.permutation(np.arange(1, P))[:M]
    tables[lens == 0] = 0
    q = _randn(rs, R, T, kvh * group, d).to(cuda_card, dtype)
    kp = _randn(rs, P, B, kvh, d).to(cuda_card, dtype)
    vp = _randn(rs, P, B, kvh, d).to(cuda_card, dtype)
    args = (q, kp, vp, torch.from_numpy(tables).to(cuda_card),
            torch.from_numpy(lens).to(cuda_card))
    n = ragged_paged_attention.launches_by_route["mma"]
    out = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches_by_route["mma"] == n + 1
    ref = ragged_paged_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
