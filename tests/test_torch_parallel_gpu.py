"""The multi-device slice on one card, at small sizes: ``chip_smoke.py``'s
phase ``parallel`` (a)-(c). Every test here is marked ``gpu`` and skips,
from its fixture, on a machine without a CUDA card. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu --noconftest

(a) ``flash_attention_with_lse`` on the kernels (the lse cotangent folded
into delta) against its dense plain twin, causal and not, bf16 and fp16
on the wgmma route and fp32 on simt, bits repeating, and the fold alone
(dout 0) against the dense lse terms; (b) the ring's
block math (``ring_flash_step`` in each sp index's order) against one
flash attention over the whole sequence, with the launch counts; (c)
``fleet.init`` at a world of one on NCCL: collectives over every axis
are the identity, a default-group all-reduce works, and the Trainer on
DTensor parameters gives the plain Trainer's losses bit for bit. The
card machine has one GPU: multi-rank results are proved on the CPU
(tests/test_torch_distributed.py, test_torch_parallel.py,
test_torch_ring.py)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.kernels import flash_attention as fa

# kernel against plain version: as the flash backward checks (16-bit
# products summed in another order), relative to the largest entry
TOL_16 = 2e-2
TOL_32 = 1e-4


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, b, s, h, kv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    q, k, v = (rnd(b, s, h, d, scale=0.5), rnd(b, s, kv, d, scale=0.5),
               rnd(b, s, kv, d))
    go, gl = rnd(b, s, h, d), rnd(b, h, s, scale=0.5)
    return [t.to(dtype) for t in (q, k, v, go)] + [gl]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 64),
                                     (torch.float32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_kernels_match_twin(cuda_card, dtype, d, causal):
    q, k, v, go, gl = _case(cuda_card, dtype, 2, 384, 8, 2, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = fa.flash_attention_with_lse_bwd(q, k, v, out, lse, go, gl,
                                          causal=causal)
    again = fa.flash_attention_with_lse_bwd(q, k, v, out, lse, go, gl,
                                            causal=causal)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    ref = fa.flash_attention_with_lse_bwd_plain(q, k, v, out, lse, go, gl,
                                                causal=causal)
    tol = TOL_32 if dtype == torch.float32 else TOL_16
    assert _rel(out, ref_out) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-2
    for a, r in zip(got, ref):
        assert _rel(a, r) <= tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the lse term is really there: the twin without it differs
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, go,
                                         causal=causal)
    assert _rel(plain[0], ref[0]) > tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_fold_alone_matches_dense_terms(cuda_card, dtype, d, causal):
    """With dout = 0 the kernels' dq and dk are the lse cotangent's share
    alone (ds = p g_lse scale): they match the dense lse_grad_terms at
    full relative tolerance, and dv is 0."""
    q, k, v, go, gl = _case(cuda_card, dtype, 2, 384, 8, 2, d, seed=1)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    dq, dk, dv = fa.flash_attention_with_lse_bwd(
        q, k, v, out, lse, torch.zeros_like(go), gl, causal=causal)
    rq, rk = fa.lse_grad_terms(q, k, lse, gl, causal=causal)
    tol = TOL_32 if dtype == torch.float32 else TOL_16
    assert _rel(dq, rq) <= tol
    assert _rel(dk, rk) <= tol
    assert float(dv.float().abs().max()) == 0.0


@pytest.mark.gpu
def test_flash_with_lse_function_counts_and_routes(cuda_card):
    q, k, v, go, gl = _case(cuda_card, torch.bfloat16, 1, 256, 4, 1, 128)
    for fn in (fa.flash_attention_with_lse, fa.flash_attention_with_lse_bwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*xs)
    grads = torch.autograd.grad([o, lse], xs, [go, gl])
    out, lse2 = fa.flash_attention_fwd(q, k, v)
    direct = fa.flash_attention_with_lse_bwd(q, k, v, out, lse2, go, gl)
    assert torch.equal(o, out) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))
    assert fa.flash_attention_with_lse.launches_by_route == {"wgmma": 1,
                                                             "simt": 0}
    assert fa.flash_attention_with_lse_bwd.launches == 2
    assert fa.flash_attention_bwd_dq.launches_by_route["wgmma"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
def test_ring_block_math_matches_one_flash(cuda_card, n):
    from paddle_tpu_torch.ops.attention import flash_attention
    from paddle_tpu_torch.parallel.ring import ring_flash_step
    sb, h, kv, d = 256, 8, 2, 128
    q, k, v, go, _ = _case(cuda_card, torch.bfloat16, 1, n * sb, h, kv, d)
    scale = 1.0 / math.sqrt(d)
    fa.flash_attention_with_lse.launches = 0
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    blk = lambda t, j: t[:, j * sb:(j + 1) * sb].contiguous()  # noqa: E731
    outs = []
    for idx in range(n):
        o, lse, _ = ring_flash_step(blk(xs[0], idx), blk(xs[1], idx),
                                    blk(xs[2], idx), None, None, 0, idx,
                                    True, scale)
        for step in range(1, n):
            j = (idx - step) % n
            o, lse, _ = ring_flash_step(blk(xs[0], idx), blk(xs[1], j),
                                        blk(xs[2], j), o, lse, step, idx,
                                        True, scale)
        outs.append(o.to(q.dtype))
    out = torch.cat(outs, dim=1)
    grads = torch.autograd.grad(out, xs, go)
    assert fa.flash_attention_with_lse.launches == n * (n + 1) // 2
    ys = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = flash_attention(*ys, causal=True)
    ref_grads = torch.autograd.grad(ref, ys, go)
    for a, r in zip((out,) + grads, (ref,) + ref_grads):
        assert _rel(a.detach(), r.detach()) <= TOL_16


@pytest.fixture
def world_of_one(cuda_card):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env, fleet
    fleet.init(strategy=fleet.DistributedStrategy(hybrid_configs={}))
    yield env.get_mesh()
    env.clear_mesh()
    dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_of_one_collectives(world_of_one):
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as D
    mesh = world_of_one
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert mesh.shape == dict.fromkeys(D.HYBRID_AXES, 1)
    x = torch.randn(4, 6, 8, device="cuda")
    for axis in D.HYBRID_AXES:
        assert D.get_world_size(axis) == 1 and D.get_rank(axis) == 0
        for op in ("sum", "max", "min", "avg"):
            assert torch.equal(D.all_reduce(x, op, axis), x)
        assert torch.equal(D.all_gather(x, axis, axis=1), x)
        assert torch.equal(D.reduce_scatter(x, axis, axis=1), x)
        assert torch.equal(D.all_to_all(x, axis, 2, 1), x)
        assert torch.equal(D.ppermute(x, [(0, 0)], axis), x)
        assert torch.equal(D.broadcast(x, 0, axis), x)
        assert torch.equal(D.eager_all_reduce(x, "sum", axis), x)
    y = x.clone()
    dist.all_reduce(y)                     # NCCL itself, one rank
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    D.barrier()


@pytest.mark.gpu
def test_mesh_trainer_equals_plain_trainer(world_of_one, tmp_path):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel.sharding import is_sharded
    cfg = ptt.llama_tiny(hidden_size=256, num_attention_heads=2,
                         num_key_value_heads=1, dtype=torch.bfloat16)
    batches = [np.random.RandomState(i).randint(0, 256, (2, 256))
               for i in range(2)]
    losses = {}
    for arm in ("plain", "mesh"):
        model = ptt.LlamaForCausalLM(cfg, device="cuda",
                                     generator=ptt.make_generator(3, "cuda"))
        if arm == "mesh":
            fleet.distributed_model(model)
            assert all(is_sharded(p) for p in model.parameters())
        opt = ptt.optimizer.AdamW(
            learning_rate=1e-3, multi_precision=True,
            grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
        args = ptt.TrainingArguments(output_dir=str(tmp_path / arm),
                                     max_steps=4, logging_steps=1)
        tr = ptt.Trainer(model, opt, args, train_dataloader=batches)
        tr.train()
        losses[arm] = [v for _, v in tr.logger.history["loss"]]
    assert losses["plain"] == losses["mesh"]
