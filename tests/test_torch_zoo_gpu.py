"""The model zoo's slice on the card: GPT through ``generate()`` and the
weight-only ``Predictor``, and Paddle's ``nn.TransformerEncoder`` on the
flash kernels. Every test here is marked ``gpu`` and skips, from its
fixture, on a machine without a CUDA card. The file imports neither JAX
nor the JAX package:

    python -m pytest tests/test_torch_zoo_gpu.py -m gpu --noconftest

A small GPT (hidden 512, 8 heads of 64) serves greedy and sampled
streams from its captured decode step bit for bit the uncaptured step's,
with no attention kernel in the step (GPT attends its cache densely, as
the JAX module does); quantized to int8 its step runs 4 quant kernels a
layer on the mma route; its fp32 logits on the card (the flash kernels'
simt route) equal the CPU's (their plain versions). An encoder of two
post-norm layers in bf16 on the flash kernels (wgmma) is held against
the same module on the kernels' plain versions, output and gradients."""
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn
from paddle_tpu_torch.generation import eager_steps
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels.decode_attention import decode_attention_fwd
from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=8,
             max_position_embeddings=512)
# fp32 logits, the card (simt kernels, fp32 matmuls without TF32) against
# the CPU (plain versions): the same sums in another order
TOL_FP32 = 2e-3
# the bf16 encoder on the kernels against the fp32 module, over the same
# on the kernels' plain versions, relative l2 (1.00-1.04 seen), as
# chip_smoke.py's TOL_ZOO_RATIO
TOL_RATIO = 1.25


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpt(dev, dtype=torch.bfloat16, seed=0):
    return ptt.GPTForCausalLM(ptt.GPTConfig(**SMALL, dtype=dtype),
                              device=dev,
                              generator=ptt.make_generator(seed, "cpu")
                              if dev.type == "cpu" else
                              ptt.make_generator(seed, dev))


def _reset(*fns):
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.gpu
def test_gpt_step_graph_is_bit_for_bit_the_eager_step(cuda_card):
    pred = ptt.Predictor(_gpt(cuda_card), device=cuda_card)
    ids = torch.randint(0, SMALL["vocab_size"], (2, 64), device=cuda_card,
                        generator=ptt.make_generator(1, cuda_card))
    greedy = ptt.GenerationConfig(max_new_tokens=16)
    pred.generate(ids, config=greedy)             # captures the step
    _reset(decode_attention_fwd, fa.flash_attention_fwd)
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    assert decode_attention_fwd.launches == 0
    assert fa.flash_attention_fwd.launches == 0
    with eager_steps():
        eager = pred.generate(ids, config=greedy)
    assert torch.equal(out, eager)
    sampled = ptt.GenerationConfig(max_new_tokens=16, do_sample=True,
                                   temperature=0.8, top_p=0.95)
    a = pred.generate(ids, config=sampled,
                      generator=ptt.make_generator(7, cuda_card))
    with eager_steps():
        b = pred.generate(ids, config=sampled,
                          generator=ptt.make_generator(7, cuda_card))
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_int8_gpt_step_takes_the_quant_kernel_on_mma(cuda_card):
    """Four biased projections a layer on the quant kernel each decode
    step (the 128-row prefill dequantizes instead), all on mma, and the
    stream bit for bit the uncaptured step's."""
    pred = ptt.Predictor(_gpt(cuda_card),
                         ptt.Config().enable_weight_only_quant(8),
                         device=cuda_card)
    ids = torch.randint(0, SMALL["vocab_size"], (2, 64), device=cuda_card,
                        generator=ptt.make_generator(2, cuda_card))
    greedy = ptt.GenerationConfig(max_new_tokens=16)
    pred.generate(ids, config=greedy)
    _reset(quant_matmul)
    out = pred.generate(ids, config=greedy)
    torch.cuda.synchronize()
    want = 4 * SMALL["num_hidden_layers"] * 15
    assert quant_matmul.launches_by_route == {"mma": want, "simt": 0}
    with eager_steps():
        assert torch.equal(pred.generate(ids, config=greedy), out)


@pytest.mark.gpu
def test_gpt_fp32_logits_on_the_card_match_the_cpu(cuda_card):
    """At 128 positions the forward takes the flash route: the simt
    kernel in fp32 on the card, the plain version on the CPU."""
    cpu = _gpt(torch.device("cpu"), torch.float32)
    card = _gpt(cuda_card, torch.float32)
    card.load_state_dict({k: v.to(cuda_card)
                          for k, v in cpu.state_dict().items()})
    ids = torch.randint(0, SMALL["vocab_size"], (2, 128),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = cpu(ids)
        got = card(ids.to(cuda_card)).cpu()
    assert float((got - ref).abs().max()) <= TOL_FP32


@pytest.mark.gpu
def test_encoder_flash_route_matches_its_plain_twin(cuda_card):
    """Two post-norm layers in bf16, the output and the input's and every
    parameter's gradient: on the flash kernels (2 launches each of the
    forward, dq and dk/dv, on wgmma) and on their plain versions, each
    against the same module in fp32 on the plain versions. Both round to
    bf16 at other points (~3e-2 apart in relative l2, each ~3e-2 from
    fp32): the kernels' error stays within ``TOL_RATIO`` times the plain
    versions' (k_proj's bias has a zero gradient up to rounding: both are
    noise against it, the ratio still holds)."""
    import copy
    layer = nn.TransformerEncoderLayer(512, 8, 1024, dropout=0.0,
                                       device=cuda_card,
                                       generator=ptt.make_generator(
                                           4, cuda_card))
    enc32 = nn.TransformerEncoder(layer, 2)
    enc = copy.deepcopy(enc32).to(torch.bfloat16)
    g = torch.Generator(device=cuda_card).manual_seed(5)
    x = torch.randn(2, 256, 512, generator=g, device=cuda_card).to(
        torch.bfloat16)
    target = torch.randn(x.shape, generator=g, device=cuda_card)

    def run(module, inp, plain):
        inp = inp.detach().requires_grad_()
        params = [inp] + list(module.parameters())
        real = fa.flash_attention_fwd, fa.flash_attention_bwd
        if plain:
            fa.flash_attention_fwd = fa.flash_attention_fwd_plain
            fa.flash_attention_bwd = fa.flash_attention_bwd_plain
        try:
            y = module(inp)
            grads = torch.autograd.grad(
                (y.float() - target).square().mean(), params)
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = real
        return [y.detach().float()] + [t.float() for t in grads]

    ref = run(enc32, x.float(), plain=True)
    _reset(fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)
    kern = run(enc, x, plain=False)
    torch.cuda.synchronize()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        assert fn.launches_by_route == {"wgmma": 2, "simt": 0}
    plain = run(enc, x, plain=True)
    names = ["output", "x"] + [n for n, _ in enc.named_parameters()]
    for name, a, p, r in zip(names, kern, plain, ref):
        assert _rel(a, r) <= TOL_RATIO * _rel(p, r), name
