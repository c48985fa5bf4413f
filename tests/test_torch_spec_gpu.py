"""The port's speculative ``PagedEngine`` ticks on the card: the spec
program captured once into a CUDA graph and replayed. Every test here is
marked ``gpu`` and skips, from its fixture, on a machine without a CUDA
card. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_spec_gpu.py -m gpu --noconftest

On a small bf16 Llama (head_dim 128, so each verify runs the ragged
kernel at T = k+1): the graphed spec engine bit for bit against the same
program run eagerly on the card; a steady spec tick is one replay whose
graph holds one ragged kernel a layer (two at k = 16, whose 34 query
rows a kv head run as two windows; one under ``PADDLE_TPU_PAGED_ATTN=grid``
too); the ragged wrapper's split against its plain version; recapture
after ``hard_reset``.
On ``LookupStub`` (logits read from a table, head_dim 128, bf16): spec
streams bit for bit the spec-off streams, greedy and sampled.

``LookupStub`` lives here, with no JAX in it, so that the CPU tests
(``tests/test_torch_spec.py``) and ``chip_smoke.py`` share it."""
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.generation.paged import (PagedEngine,
                                               paged_chunk_attention,
                                               paged_decode_attention,
                                               paged_decode_write,
                                               paged_prefill_write)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    query_windows, ragged_paged_attention, ragged_paged_attention_plain)

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             dtype=torch.bfloat16)
GEO = dict(max_slots=4, num_blocks=64, block_size=16, max_blocks_per_seq=8,
           prefill_buckets=(32, 64))


class LookupStub(torch.nn.Module):
    """The JAX tests' ``LookupStub`` (``tests/test_paged_spec.py``): token
    t's logits are a table row that argmaxes to (t + 1) % period with a
    margin of 8.0. The paged cache write and attention still run every
    call and join the logits with weight 0.0, so the logits cannot depend
    on the query count and spec streams are comparable bit for bit with
    spec-off streams. ``period`` small: the stream cycles and prompt
    lookup accepts; past prompt and budget: nothing is accepted.
    ``head_dim`` 128 in bf16 on a card sends the attention through the
    ragged kernel's mma route."""

    def __init__(self, period=7, device="cpu", head_dim=8,
                 dtype=torch.float32):
        super().__init__()
        V = 64
        self.config = SimpleNamespace(vocab_size=V, num_hidden_layers=1,
                                      num_key_value_heads=1,
                                      head_dim=head_dim, dtype=dtype)
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(0)
        self.register_buffer("emb", torch.randn(V, head_dim, generator=gen)
                             .to(self.device, dtype))
        table = torch.nn.functional.one_hot(
            (torch.arange(V) + 1) % period, V).float() * 8.0
        self.register_buffer("table", table.to(self.device))

    def forward(self, tokens, kv_caches=None, positions=None,
                paged_chunk=False, paged_decode=False):
        x = self.emb[tokens]                               # [R, s, d]
        kv = x[:, :, None, :]
        pk = kv_caches[0]
        if tokens.shape[1] == 1 or paged_decode:
            pk = paged_decode_write(pk, kv, kv)
            o = paged_decode_attention(kv, pk)[:, :, 0]
        else:
            pk = paged_prefill_write(
                pk, kv, kv, positions=positions[0] if paged_chunk else None)
            o = paged_chunk_attention(kv, pk, positions)[:, :, 0]
        logits = self.table[tokens] + 0.0 * o.float().sum(-1, keepdim=True)
        return logits, [pk]


@pytest.fixture
def cuda_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    monkeypatch.delenv("PADDLE_TPU_PAGED_ATTN", raising=False)
    return torch.device("cuda")


def _graph_nodes():
    """``chip_smoke.graph_nodes``: the kernel names a captured graph
    holds, read through libcuda."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graph_nodes


def _model(dev, seed=0):
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**SMALL), device=dev,
                                generator=ptt.make_generator(seed, dev))


def _script(seed=0):
    """Prompts repeating a seeded pattern (drafts find matches), greedy,
    sampled, penalised and stopped rows, two of them admitted late."""
    rs = np.random.RandomState(seed)

    def rep(n, period):
        return np.tile(rs.randint(1, 1000, period), n // period + 1)[None,
                                                                     :n]

    return [("a", rep(20, 5), dict(max_new_tokens=24)),
            ("b", rep(45, 7), dict(max_new_tokens=18, temperature=0.8,
                                   top_p=0.9, seed=7)),
            ("c", rep(9, 3), dict(max_new_tokens=30,
                                  repetition_penalty=1.3)),
            ("d", rep(33, 4), dict(max_new_tokens=12,
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


def _zero(*fns):
    for fn in fns:
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


@pytest.mark.gpu
def test_graphed_spec_bitwise_eager_on_card(cuda_card):
    """The captured spec programs against the same programs run eagerly
    on the card: tokens and logprobs bit for bit, sampled rows
    included."""
    model = _model(cuda_card)
    eager = PagedEngine(model, **dict(GEO, spec_tokens=4))
    eager._dispatch = lambda greedy, K, spec=False: eager._program(
        greedy, K, spec)
    graphed = PagedEngine(model, **dict(GEO, spec_tokens=4))
    ref = _serve(eager, _script())
    _zero(ragged_paged_attention)
    got = _serve(graphed, _script())
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert {k[:2] for k in graphed._graphs} == {(True, "spec"),
                                                (False, "spec")}
    assert graphed.stats["spec_proposed"] > 0
    L = model.config.num_hidden_layers
    by_route = ragged_paged_attention.launches_by_route
    assert by_route["simt"] == 0
    assert by_route["mma"] == L * graphed.stats["decode_steps"]


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_stub_spec_streams_bitwise_spec_off_on_card(cuda_card, sampled):
    kw = dict(temperature=0.9, top_k=12, seed=3) if sampled else {}
    subs = [("a", np.asarray([[(1 + i) % 7 for i in range(6)]]),
             dict(max_new_tokens=30, **kw)),
            ("b", np.asarray([[(3 + i) % 7 for i in range(9)]]),
             dict(max_new_tokens=25, eos_token_id=5, **kw)),
            ("c", np.asarray([[2, 9, 4]]), dict(max_new_tokens=20))]

    def run(**spec):
        eng = PagedEngine(LookupStub(device=cuda_card, head_dim=128,
                                     dtype=torch.bfloat16),
                          **dict(GEO, **spec))
        for rid, ids, skw in subs:
            eng.submit(rid, ids, **skw)
        return eng.run(), dict(eng.logprobs), eng

    r_off, lp_off, _ = run()
    _zero(ragged_paged_attention)
    r_on, lp_on, eng = run(spec_tokens=4)
    assert r_on == r_off and lp_on == lp_off
    assert eng.stats["spec_accepted"] > 0
    assert ragged_paged_attention.launches_by_route["mma"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k,mode", [(4, "ragged"), (16, "ragged"),
                                    (4, "grid")],
                         ids=["k4", "k16-split", "k4-grid"])
def test_steady_spec_tick_is_one_replay(cuda_card, monkeypatch, k, mode):
    """Every row holds all its blocks, so no transition: each steady step
    is one dispatch, no upload, and the replay launches the ragged kernel
    once a layer for each window of queries that fits a launch (k = 16 at
    2 query heads a kv head: 34 query rows, two windows), under either
    route (the graph's nodes, read through libcuda)."""
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", mode)
    model = _model(cuda_card)
    eng = PagedEngine(model, **dict(GEO, spec_tokens=k))
    rs = np.random.RandomState(5)
    for i in range(eng.R):
        eng.submit(f"s{i}", np.tile(rs.randint(1, 1000, 4), 5)[None],
                   max_new_tokens=80)
    for _ in range(3):
        eng.step()
    for i in range(eng.R):
        assert eng._grow_blocks(i, eng.M)
    eng.step()                                # the growth's patches land
    cfg = model.config
    L = cfg.num_hidden_layers * len(query_windows(
        k + 1, cfg.num_attention_heads // cfg.num_key_value_heads))
    _zero(ragged_paged_attention)
    d0, u0 = eng.dispatch_count, eng.h2d_uploads
    t0 = eng.stats["decode_steps"]
    for _ in range(6):
        eng.step()
    ticks = eng.stats["decode_steps"] - t0
    assert ticks == 6
    assert eng.dispatch_count - d0 == ticks and eng.h2d_uploads == u0
    assert ragged_paged_attention.launches_by_route["mma"] == L * ticks
    names, _ = _graph_nodes()(eng._graphs[(True, "spec", mode)].graph.graph)
    assert sum("ragged_" in n.lower() for n in names) == L
    eng.run()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)],
                         ids=["bf16", "fp16"])
def test_ragged_splits_a_long_window_on_card(cuda_card, dtype, tol):
    """q [4, 9, 8, 128] over 2 kv heads (36 query rows a kv head) runs as
    two launches, against the plain version over the whole window, within
    chip_smoke.py's tolerance for the dtype."""
    gen = torch.Generator(device=cuda_card).manual_seed(0)
    R, T, h, kvh, d, B, M, P = 4, 9, 8, 2, 128, 16, 8, 40
    q = torch.randn(R, T, h, d, generator=gen, device=cuda_card).to(dtype)
    kp = torch.randn(P, B, kvh, d, generator=gen,
                     device=cuda_card).to(dtype)
    vp = torch.randn(P, B, kvh, d, generator=gen,
                     device=cuda_card).to(dtype)
    tables = torch.stack([torch.randperm(P - 1, generator=gen,
                                         device=cuda_card)[:M] + 1
                          for _ in range(R)]).to(torch.int32)
    lens = torch.tensor([0, 15, 60, M * B - T], dtype=torch.int32,
                        device=cuda_card)
    _zero(ragged_paged_attention)
    out = ragged_paged_attention(q, kp, vp, tables, lens)
    assert ragged_paged_attention.launches_by_route["mma"] == 2
    ref = ragged_paged_attention_plain(q, kp, vp, tables, lens)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_spec_recaptures_after_hard_reset(cuda_card):
    model = _model(cuda_card)
    eng = PagedEngine(model, **dict(GEO, spec_tokens=4))
    first = _serve(eng, _script(1))
    assert eng._graphs
    eng.hard_reset()
    assert not eng._graphs
    assert _serve(eng, _script(1)) == first
    assert eng._graphs
