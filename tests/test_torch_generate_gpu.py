"""The port's ``generate()`` family on the card: each decode step one
CUDA-graph replay at a device cache index. Every test here is marked
``gpu`` and skips, from its fixture, on a machine without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_generate_gpu.py -m gpu --noconftest

The decode kernel at a device ``cache_index`` (one for all rows, or one
a row) against its host-int launch and its plain version, also replayed
from a CUDA graph after the index changed in place; on a small bf16
Llama (head_dim 128, so decode runs the kernel's mma route): the graphed
step bit for bit the uncaptured step (``eager_steps``), greedy and
sampled, in beam search, in both speculative generates and in int8; a
replay after ``cur`` and the caches changed in place; a capture on one
thread while another thread replays."""
import threading

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation import eager_steps
from paddle_tpu_torch.generation.speculative import (
    ngram_speculative_generate, speculative_generate)
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain)

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             dtype=torch.bfloat16)
# the decode kernel against its plain version (as chip_smoke.py states
# them): bf16 2e-2, fp16 2.5e-3, fp32 2e-5
TOLS = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3, torch.float32: 2e-5}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    return torch.device("cuda")


def _model(dev, seed=0, **kw):
    return ptt.LlamaForCausalLM(ptt.LlamaConfig(**dict(SMALL, **kw)),
                                device=dev,
                                generator=ptt.make_generator(seed, dev))


def _ids(dev, b=4, n=64, seed=1, vocab=1024):
    return torch.randint(0, vocab, (b, n), device=dev,
                         generator=ptt.make_generator(seed, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("window", [None, 40])
def test_decode_kernel_at_a_device_index(cuda_card, dtype, window):
    g = torch.Generator(device=cuda_card).manual_seed(2)
    b, T, h, kv, d = 4, 640, 32, 8, 128
    q = torch.randn(b, h, d, generator=g, device=cuda_card).to(dtype)
    ck = torch.randn(b, T, kv, d, generator=g, device=cuda_card).to(dtype)
    cv = torch.randn(b, T, kv, d, generator=g, device=cuda_card).to(dtype)
    for ci in (0, 63, 64, 300, T - 1):
        host = decode_attention_fwd(q, ck, cv, ci, window=window)
        one = torch.tensor(ci, dtype=torch.int32, device=cuda_card)
        rows = torch.full((b,), ci, dtype=torch.int32, device=cuda_card)
        assert torch.equal(decode_attention_fwd(q, ck, cv, one,
                                                window=window), host)
        assert torch.equal(decode_attention_fwd(q, ck, cv, rows,
                                                window=window), host)
    per_row = torch.tensor([5, 130, 511, T - 1], dtype=torch.int32,
                           device=cuda_card)
    got = decode_attention_fwd(q, ck, cv, per_row, window=window)
    ref = decode_attention_fwd_plain(q, ck, cv, per_row, window=window)
    assert float((got.float() - ref.float()).abs().max()) <= TOLS[dtype]
    for r in range(b):              # each row at its own index
        alone = decode_attention_fwd(q[r:r + 1], ck[r:r + 1], cv[r:r + 1],
                                     int(per_row[r]), window=window)
        err = float((got[r:r + 1].float() - alone.float()).abs().max())
        assert err <= TOLS[dtype], (r, err)


@pytest.mark.gpu
def test_decode_kernel_per_row_indices_at_the_draft_shape(cuda_card):
    """Distinct indices a row at head_dim 64 (a Llama-3.2-1B draft's
    shape): the plain version within bf16's tolerance, and each row bit
    for bit that row of the host-int launch at its own index."""
    g = torch.Generator(device=cuda_card).manual_seed(3)
    b, T, h, kv, d = 4, 581, 32, 8, 64
    q = torch.randn(b, h, d, generator=g,
                    device=cuda_card).to(torch.bfloat16)
    ck, cv = (torch.randn(b, T, kv, d, generator=g, device=cuda_card)
              .to(torch.bfloat16) for _ in range(2))
    rows = [131, 262, 400, 579]
    ci = torch.tensor(rows, dtype=torch.int32, device=cuda_card)
    got = decode_attention_fwd(q, ck, cv, ci)
    ref = decode_attention_fwd_plain(q, ck, cv, ci)
    assert float((got.float() - ref.float()).abs().max()) \
        <= TOLS[torch.bfloat16]
    for r, at in enumerate(rows):
        assert torch.equal(got[r], decode_attention_fwd(q, ck, cv, at)[r])


@pytest.mark.gpu
def test_decode_kernel_replays_at_the_index_written_in_place(cuda_card):
    """A graph of the launch, replayed after the device index changed in
    place, gives the host-int launch's bits at the new index."""
    g = torch.Generator(device=cuda_card).manual_seed(3)
    b, T, h, kv, d = 4, 640, 32, 8, 128
    q = torch.randn(b, h, d, generator=g, device=cuda_card).bfloat16()
    ck = torch.randn(b, T, kv, d, generator=g, device=cuda_card).bfloat16()
    cv = torch.randn(b, T, kv, d, generator=g, device=cuda_card).bfloat16()
    ci = torch.tensor(10, dtype=torch.int32, device=cuda_card)
    out = decode_attention_fwd(q, ck, cv, ci)        # sizes the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, ck, cv, ci)
    for i in (10, 64, 127, 128, 639, 3):
        ci.fill_(i)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_fwd(q, ck, cv, i)), i


def _both(fn):
    """(graphed run, uncaptured run) of ``fn``; the graphed one first,
    so it captures."""
    fn()                                     # capture
    graphed = fn()
    with eager_steps():
        eager = fn()
    return graphed, eager


@pytest.mark.gpu
def test_graphed_step_equals_the_uncaptured_step(cuda_card):
    from paddle_tpu_torch.ops.kernels.decode_attention import \
        decode_attention_fwd as dfn
    model = _model(cuda_card)
    ids = _ids(cuda_card)
    for cfg in (ptt.GenerationConfig(max_new_tokens=24),
                ptt.GenerationConfig(max_new_tokens=24, do_sample=True,
                                     temperature=0.8, top_p=0.9),
                ptt.GenerationConfig(max_new_tokens=24,
                                     repetition_penalty=1.3,
                                     no_repeat_ngram_size=3,
                                     min_new_tokens=4, eos_token_id=7)):
        def run():
            return ptt.generate(model, ids, cfg,
                                generator=ptt.make_generator(5, cuda_card))
        graphed, eager = _both(run)
        assert torch.equal(graphed, eager), cfg
    prog = next(iter(model._gen_exec_cache.programs.values()))
    assert prog.step.graph is not None and prog.step.pool_bytes >= 0
    # the counts a replay adds are the capture's: one decode a layer
    dfn.launches = 0
    ptt.generate(model, ids, max_new_tokens=24)
    assert dfn.launches == SMALL["num_hidden_layers"] * 23


@pytest.mark.gpu
def test_replay_after_cur_and_caches_changed_in_place(cuda_card):
    """The same program serves other prompts: its buffers (caches,
    tokens, cur) are rewritten in place and the graph replays them."""
    model = _model(cuda_card)
    cfg = ptt.GenerationConfig(max_new_tokens=16)
    a = ptt.generate(model, _ids(cuda_card, seed=1), cfg)
    progs = dict(model._gen_exec_cache.programs)
    b = ptt.generate(model, _ids(cuda_card, seed=2), cfg)
    assert dict(model._gen_exec_cache.programs) == progs
    with eager_steps():
        b_eager = ptt.generate(model, _ids(cuda_card, seed=2), cfg)
        a_eager = ptt.generate(model, _ids(cuda_card, seed=1), cfg)
    assert torch.equal(a, a_eager) and torch.equal(b, b_eager)


@pytest.mark.gpu
def test_capture_on_one_thread_while_another_replays(cuda_card):
    """Two models on two threads: one replays its captured step while
    the other captures its first (under ``card_lock``: the capture runs
    alone); both streams equal their uncaptured runs."""
    models = [_model(cuda_card, 0), _model(cuda_card, 1)]
    ids = _ids(cuda_card)
    cfg = ptt.GenerationConfig(max_new_tokens=48)
    ptt.generate(models[0], ids, cfg)              # captured already
    out, errors = {}, []
    started = threading.Event()

    def replayer():
        try:
            started.set()
            out[0] = [ptt.generate(models[0], ids, cfg) for _ in range(4)]
        except Exception as e:      # reported by the main thread
            errors.append(e)

    def capturer():
        try:
            started.wait(timeout=60)
            out[1] = ptt.generate(models[1], ids, cfg)
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=replayer), threading.Thread(target=capturer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    with eager_steps():
        ref0 = ptt.generate(models[0], ids, cfg)
        ref1 = ptt.generate(models[1], ids, cfg)
    assert all(torch.equal(o, ref0) for o in out[0])
    assert torch.equal(out[1], ref1)


@pytest.mark.gpu
def test_capture_with_a_dropped_models_graph_awaiting_the_collector(
        cuda_card):
    """A dropped model's programs (model -> cache -> program -> model, a
    cycle) keep a CUDA graph that only the garbage collector frees. With
    the collector at its most eager, another model's capture must not
    free it mid-capture (``capture`` collects before and not during)."""
    import gc
    ids = _ids(cuda_card)
    cfg = ptt.GenerationConfig(max_new_tokens=8)
    dead = _model(cuda_card, 0)
    ptt.generate(dead, ids, cfg)
    live = _model(cuda_card, 1)
    prev = gc.get_threshold()
    gc.set_threshold(1)
    try:
        del dead
        got = ptt.generate(live, ids, cfg)
    finally:
        gc.set_threshold(*prev)
    with eager_steps():
        assert torch.equal(got, ptt.generate(live, ids, cfg))


@pytest.mark.gpu
def test_beam_and_speculative_generates_are_graphed(cuda_card):
    model = _model(cuda_card)
    draft = _model(cuda_card, 9, hidden_size=256, num_attention_heads=2,
                   num_key_value_heads=1, num_hidden_layers=1)
    ids = _ids(cuda_card, b=2)
    pattern = torch.arange(16, device=cuda_card).repeat(2, 4)
    runs = {
        "beam": lambda: ptt.generate(model, ids, max_new_tokens=16,
                                     num_beams=4, length_penalty=1.2),
        "draft": lambda: speculative_generate(model, draft, ids,
                                              max_new_tokens=24,
                                              num_draft_tokens=3),
        "ngram": lambda: ngram_speculative_generate(
            model, pattern, max_new_tokens=24, num_draft_tokens=4),
        "ngram-sampled": lambda: ngram_speculative_generate(
            model, pattern, max_new_tokens=24, num_draft_tokens=4,
            temperature=0.8, generator=ptt.make_generator(3, cuda_card)),
    }
    for name, fn in runs.items():
        graphed, eager = _both(fn)
        assert torch.equal(graphed, eager), name
    assert all(p.step.graph is not None
               for p in model._gen_exec_cache.programs.values())


@pytest.mark.gpu
def test_int8_generate_is_graphed(cuda_card):
    from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
    model = _model(cuda_card)
    pred = ptt.Predictor(model, ptt.Config().enable_weight_only_quant(8),
                         device=cuda_card)
    ids = _ids(cuda_card)
    cfg = ptt.GenerationConfig(max_new_tokens=16)
    graphed, eager = _both(lambda: pred.generate(ids, config=cfg))
    assert torch.equal(graphed, eager)
    quant_matmul.launches = 0
    pred.generate(ids, config=cfg)
    assert quant_matmul.launches == 7 * SMALL["num_hidden_layers"] * 15


@pytest.mark.gpu
def test_step_graph_keeps_every_workspace_its_capture_used(cuda_card):
    """The int8 step's projections ask the quant kernel's workspace for
    sizes that alternate (more floats, or more counters). It grows to the
    largest ask, so an uncaptured step replaces no workspace (a capture
    after the warm-up allocates none), and the step graph keeps the
    pairs it writes: after every workspace grew past them and the cache
    was emptied, a replay is still bit for bit the uncaptured step."""
    from paddle_tpu_torch.ops import kernels
    model = _model(cuda_card)
    pred = ptt.Predictor(model, ptt.Config().enable_weight_only_quant(8),
                         device=cuda_card)
    ids = _ids(cuda_card)
    cfg = ptt.GenerationConfig(max_new_tokens=16)
    pred.generate(ids, config=cfg)                      # capture
    idx = torch.cuda.current_device()
    names = ("decode_attention", "quant_matmul")
    before = {n: kernels._workspaces[(n, idx)] for n in names}
    with eager_steps():
        eager = pred.generate(ids, config=cfg)
    for n in names:
        now = kernels._workspaces[(n, idx)]
        assert now[0] is before[n][0] and now[1] is before[n][1], n
    prog = next(p for k, p in model._gen_exec_cache.programs.items()
                if k[0] == "generate")
    kept = {id(t) for pair in prog.step.graph.keep for t in pair}
    for n in names:
        assert {id(t) for t in before[n]} <= kept, n
    for n in names:
        work, arrivals = before[n]
        kernels.workspace(n, cuda_card, 4 * work.numel(),
                          4 * arrivals.numel())
    del before, work, arrivals
    torch.cuda.empty_cache()
    assert torch.equal(pred.generate(ids, config=cfg), eager)
