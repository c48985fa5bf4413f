"""The port's device-resident ``PagedEngine`` tick on the card: each tick
program captured once into a CUDA graph and replayed. Every test here is
marked ``gpu`` and skips, from its fixture, on a machine without a CUDA
card. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_fused_tick_gpu.py -m gpu --noconftest

On a small bf16 Llama (head_dim 128, so the paged kernels take the
engine's attention): the graphed default engine bit for bit against the
host tick (``fused_tick=False``), sampled rows included; the kernels'
launch counts per replay (ragged, grid, quant) with no wrapper called
from the host on a steady tick; recapture after ``hard_reset``, after a
change of ``PADDLE_TPU_PAGED_ATTN`` and after the weights are quantized
in place."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation import paged as paged_module
from paddle_tpu_torch.generation.paged import PagedEngine
from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention
from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
    ragged_paged_attention

pytestmark = pytest.mark.gpu

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             dtype=torch.bfloat16)
GEO = dict(max_slots=4, num_blocks=64, block_size=16, max_blocks_per_seq=8,
           prefill_buckets=(32, 64))


@pytest.fixture
def cuda_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    return torch.device("cuda")


def _model(dev, seed=0):
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**SMALL), device=dev,
                                generator=ptt.make_generator(seed, dev))


def _script(seed=0, sampled=True):
    rs = np.random.RandomState(seed)

    def ids(n):
        return rs.randint(1, 1000, (1, n))

    samp = dict(temperature=0.8, top_p=0.9, seed=7) if sampled else {}
    return [("a", ids(20), dict(max_new_tokens=24)),
            ("b", ids(45), dict(max_new_tokens=18, **samp)),
            ("c", ids(9), dict(max_new_tokens=30, repetition_penalty=1.3)),
            ("d", ids(33), dict(max_new_tokens=12,
                                stop_sequences=[[5, 6]]))]


def _serve(eng, script, late=3):
    for rid, ids, kw in script[:2]:
        eng.submit(rid, ids, **kw)
    for _ in range(late):
        eng.step()
    for rid, ids, kw in script[2:]:
        eng.submit(rid, ids, **kw)
    out = eng.run()
    return out, dict(eng.logprobs)


def _bitwise(model, script, **kw):
    host = PagedEngine(model, **dict(GEO, fused_tick=False))
    fused = PagedEngine(model, **dict(GEO, **kw))
    ref = _serve(host, script)
    got = _serve(fused, script)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    return fused


def _steady(eng, n=8, prompt=33):
    """Fill every slot with a greedy request whose three blocks (48
    positions) hold ``prompt`` + 3 + n tokens, so no block grows (a
    transition) in the window; tick until the graph is captured. Returns
    a function running ``n`` steady steps and the ticks they took."""
    rs = np.random.RandomState(5)
    for i in range(eng.R):
        eng.submit(f"s{i}", rs.randint(1, 1000, (1, prompt)),
                   max_new_tokens=3 * n + 8)
    for _ in range(3):
        eng.step()

    def run():
        t0 = eng.stats["decode_steps"]
        for _ in range(n):
            eng.step()
        return eng.stats["decode_steps"] - t0
    return run


def _zero(*fns):
    for fn in fns:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


@pytest.mark.parametrize("kw", [{}, dict(ring_mode=False),
                                dict(ticks_per_dispatch=4),
                                dict(delta_transitions=False)],
                         ids=["default", "ring_off", "scan4", "rebuild"])
def test_graphed_engine_bitwise_host_tick(cuda_card, kw):
    model = _model(cuda_card)
    eng = _bitwise(model, _script(), **kw)
    assert eng._graphs, "the tick never replayed from a graph"
    greedy_keys = {k[0] for k in eng._graphs}
    assert greedy_keys == {True, False}       # both programs captured


def test_steady_tick_is_one_replay_with_no_wrapper_call(cuda_card,
                                                        monkeypatch):
    model = _model(cuda_card)
    eng = PagedEngine(model, **GEO)
    run = _steady(eng)
    calls = [0]
    real = paged_module.ragged_paged_attention

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(paged_module, "ragged_paged_attention", spy)
    _zero(ragged_paged_attention)
    d0, u0 = eng.dispatch_count, eng.h2d_uploads
    ticks = run()
    L = model.config.num_hidden_layers
    assert calls[0] == 0                      # no wrapper call per tick
    assert eng.dispatch_count - d0 == ticks and eng.h2d_uploads == u0
    assert ragged_paged_attention.launches == L * ticks
    assert ragged_paged_attention.launches_by_route["mma"] == L * ticks


def test_recapture_after_hard_reset_and_route_change(cuda_card,
                                                     monkeypatch):
    model = _model(cuda_card)
    eng = PagedEngine(model, **GEO)
    first = _serve(eng, _script(1))
    assert eng._graphs
    eng.hard_reset()
    assert not eng._graphs
    assert _serve(eng, _script(1)) == first   # recaptured, same bits
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "grid")
    _zero(ragged_paged_attention, paged_attention)
    got = _bitwise(model, _script(2))
    L = model.config.num_hidden_layers
    assert {k[2] for k in got._graphs} == {"grid"}
    assert ragged_paged_attention.launches == 0
    # the host tick and the graphed tick each launch L a tick
    grid = paged_attention.launches_by_route
    assert grid["simt"] == 0 and grid["mma"] == paged_attention.launches
    assert paged_attention.launches % L == 0
    run = _steady(got)
    _zero(paged_attention)
    ticks = run()
    assert paged_attention.launches_by_route["mma"] == L * ticks


def test_quantized_in_place_recaptures_with_quant_counts(cuda_card):
    model = _model(cuda_card)
    eng = PagedEngine(model, **GEO)
    run = _steady(eng)
    run()
    ptt.Predictor(model, ptt.Config().enable_weight_only_quant(8),
                  device=cuda_card)
    _zero(quant_matmul, ragged_paged_attention)
    ticks = run()                             # new weights: a new graph
    L = model.config.num_hidden_layers
    assert quant_matmul.launches_by_route["mma"] == 7 * L * ticks
    assert ragged_paged_attention.launches == L * ticks
    _bitwise(model, _script(3))
