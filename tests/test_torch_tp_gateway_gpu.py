"""Tensor-parallel serving behind the gateway, on one card at a world of
one: ``chip_smoke.py``'s phase ``tp-serve`` (a) and (b) at small sizes.
Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_tp_gateway_gpu.py -m gpu --noconftest

(a) A small bf16 Llama (head_dim 128, so every tick runs the ragged
kernel on its mma route) built sharded on a world-one NCCL mesh and bound
once, its engine behind a ``SequencedEngine`` served by a ``Gateway``:
greedy and sampled SSE streams bit for bit a plain ``PagedEngine`` on the
same weights unsharded, ragged launches one a layer and tick. (b)
``from_pretrained`` of a small bf16 checkpoint inside ``sharded_build``:
every parameter bit for bit the whole loader's. The card machine has one
GPU: tp > 1 is proved on the CPU (tests/test_torch_tp_gateway.py,
tests/test_torch_tp_load.py)."""
import asyncio
import json
import os
import struct

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt

SMALL = dict(vocab_size=512, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512,
             dtype=torch.bfloat16)
GEO = dict(max_slots=4, num_blocks=64, block_size=16, max_blocks_per_seq=8,
           chunk_prefill_tokens=32, enable_prefix_cache=True)


@pytest.fixture
def tp_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = env.init_parallel_env({"tp": 1})
    yield mesh
    env.clear_mesh()
    dist.destroy_process_group()


def _model(dev, seed=0):
    return ptt.LlamaForCausalLM(ptt.llama_tiny(**SMALL), device=dev,
                                generator=ptt.make_generator(seed, dev))


def _sharded(dev, seed=0):
    from paddle_tpu_torch.parallel.sharding import (bind_static,
                                                    shard_layer,
                                                    sharded_build)
    with sharded_build(fsdp_min_size=1 << 30):
        m = _model(dev, seed)
    shard_layer(m, fsdp_min_size=1 << 30)
    bind_static(m)
    return m


@pytest.mark.gpu
def test_sequenced_gateway_at_tp1_is_the_plain_engine(tp_one):
    from paddle_tpu_torch.generation.paged import PagedEngine
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        ragged_paged_attention
    from paddle_tpu_torch.serving import Gateway
    from paddle_tpu_torch.serving.tp_replica import SequencedEngine
    from test_torch_gateway_gpu import sse
    dev = tp_one.device
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 512, 64).tolist()
    reqs = [dict(request_id=f"r{i}",
                 prompt=prefix + rs.randint(0, 512, 20).tolist(),
                 max_new_tokens=12) for i in range(3)]
    reqs.append(dict(request_id="s", prompt=rs.randint(0, 512, 40).tolist(),
                     max_new_tokens=12, temperature=0.8, seed=4))
    seq = SequencedEngine(PagedEngine(_sharded(dev), **GEO))

    async def run():
        gw = Gateway(seq, name="tp1-gpu")
        await gw.start()
        try:
            return await asyncio.gather(*[sse(gw.port, r) for r in reqs])
        finally:
            await gw.drain()
    steps0 = seq.stats["decode_steps"]
    rag0 = ragged_paged_attention.launches_by_route.get("mma", 0)
    got = asyncio.run(run())
    ticks = seq.stats["decode_steps"] - steps0
    rag = ragged_paged_attention.launches_by_route.get("mma", 0) - rag0
    plain = PagedEngine(_model(dev), **GEO)
    for r in reqs:
        plain.submit(r["request_id"], torch.as_tensor(r["prompt"]),
                     **{k: v for k, v in r.items()
                        if k not in ("request_id", "prompt")})
    want = plain.run()
    for r, (st, _, toks, fin) in zip(reqs, got):
        rid = r["request_id"]
        assert st == 200 and toks == want[rid], rid
        assert fin["logprobs"] == plain.logprobs[rid], rid
    assert ticks > 0 and rag == SMALL["num_hidden_layers"] * ticks
    assert seq.sequencer_stats()["stopped"]


def _write_checkpoint(d, model):
    """``model``'s bf16 tensors as one safetensors file and a config."""
    header, off, blobs = {}, 0, []
    for name, t in model.state_dict().items():
        raw = t.detach().cpu().contiguous().view(torch.uint8).numpy() \
            .tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        off += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    cfg = model.config
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "num_key_value_heads": cfg.num_key_value_heads,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)


@pytest.mark.gpu
def test_per_rank_from_pretrained_at_tp1_is_the_whole_load(tp_one, tmp_path):
    from paddle_tpu_torch.models import hf_interop
    from paddle_tpu_torch.parallel.sharding import local, sharded_build
    dev = tp_one.device
    _write_checkpoint(str(tmp_path), _model(dev, seed=3))
    whole = hf_interop.from_pretrained(str(tmp_path), device=dev)
    with sharded_build(fsdp_min_size=1 << 30):
        per = hf_interop.from_pretrained(str(tmp_path), device=dev)
    want, got = whole.state_dict(), per.state_dict()
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(local(got[k]), want[k]), k
