"""The fused-qkv families built sharded, and BatchNorm's statistics, on the
card. Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_tp_zoo_gpu.py -m gpu --noconftest

On a world-one NCCL mesh ({"tp": 1}) a small GPT built inside
``sharded_build`` (its fused qkv tagged as three blocks) serves greedy
tokens and int8 weight-only tokens bit for bit the plain model's, and its
state dict is the plain model's. A BatchNorm in training at a world of
one issues no collective and gives the per-rank statistics' output and
gradients bit for bit (tp > 1 and dp > 1 are proved by the CPU gloo
tests)."""
import pytest
import torch

import paddle_tpu_torch as ptt

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=8,
             max_position_embeddings=512)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def tp_one(cuda_card):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    mesh = env.init_parallel_env({"tp": 1})
    yield mesh
    env.clear_mesh()
    dist.destroy_process_group()


def _gpt(dev, sharded=False):
    from paddle_tpu_torch.parallel.sharding import (bind_static,
                                                    shard_layer,
                                                    sharded_build)
    cfg = ptt.GPTConfig(**SMALL, dtype=torch.bfloat16)

    def make():
        return ptt.GPTForCausalLM(cfg, device=dev,
                                  generator=ptt.make_generator(0, dev))
    if not sharded:
        return make()
    with sharded_build(fsdp_min_size=1 << 30):
        m = make()
    shard_layer(m, fsdp_min_size=1 << 30)
    bind_static(m)
    return m


@pytest.mark.gpu
def test_sharded_gpt_at_tp1_is_the_plain_model(tp_one):
    dev = tp_one.device
    plain, sharded = _gpt(dev), _gpt(dev, sharded=True)
    qkv = sharded.model.layers[0].attn.qkv_proj
    assert qkv._parameters["weight"].fused_parts == 3
    sd, want = sharded.state_dict(), plain.state_dict()
    assert sd.keys() == want.keys()
    from paddle_tpu_torch.parallel.sharding import full_tensor
    assert all(torch.equal(full_tensor(sd[k]), want[k]) for k in want)
    ids = torch.randint(0, SMALL["vocab_size"], (2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    a = ptt.generate(plain, ids, max_new_tokens=16)
    b = ptt.generate(sharded, ids, max_new_tokens=16)
    assert torch.equal(a, b)
    cfg = ptt.Config().enable_weight_only_quant(8)
    qa = ptt.Predictor(_gpt(dev), cfg, device=dev).generate(
        ids, max_new_tokens=16)
    qb = ptt.Predictor(_gpt(dev, sharded=True), cfg, device=dev).generate(
        ids, max_new_tokens=16)
    assert torch.equal(qa, qb)


@pytest.mark.gpu
def test_batch_norm_at_a_world_of_one_issues_no_collective(tp_one):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import norm
    dev = tp_one.device
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(8, 16, 14, 14, device=dev, generator=gen,
                    dtype=torch.bfloat16).requires_grad_()
    g = torch.randn(8, 16, 14, 14, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    for cls in (nn.BatchNorm2D, nn.SyncBatchNorm):
        bn = cls(16, device=dev, dtype=torch.bfloat16)
        before = norm.stat_reductions
        y = bn(x)
        gx, gw = torch.autograd.grad((y * g).sum(), [x, bn.weight])
        assert norm.stat_reductions == before
        ref_bn = cls(16, device=dev, dtype=torch.bfloat16)
        ref, mean, var = F.batch_norm(x, ref_bn._mean, ref_bn._variance,
                                      ref_bn.weight, ref_bn.bias,
                                      training=True)
        rx, rw = torch.autograd.grad((ref * g).sum(), [x, ref_bn.weight])
        assert torch.equal(y, ref) and torch.equal(gx, rx)
        assert torch.equal(gw, rw)
        # the buffers keep their dtype: the moved statistics land rounded
        assert torch.equal(bn._mean, mean.to(bn._mean.dtype))
        assert torch.equal(bn._variance, var.to(bn._variance.dtype))
