"""Paddle's layer API on the card. Every test here is marked ``gpu`` and
skips, from its fixture, on a machine without a CUDA card. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_api_gpu.py -m gpu --noconftest

``incubate.nn.functional.fused_dot_product_attention``, causal with no
mask, launches the flash forward and, in its backward, the dq and dk/dv
kernels (on the wgmma route in bf16), and equals the same call's plain
version on the CPU within ``TOL_BF16``; with a mask it launches none.
Layers built with no generator draw their weights from the ambient
stream on the card: ``seed(s)`` repeats them."""
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

# bf16 against the CPU's plain version, relative to the largest value:
# the kernels round their tiles at other points than the plain math
TOL_BF16 = 2.0 ** -6


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    fns = (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
    for fn in fns:
        fn.launches = 0
    return lambda: [fn.launches for fn in fns]


@pytest.mark.gpu
def test_fused_attention_runs_the_flash_kernels(cuda_card):
    gen = ptt.make_generator(0, "cpu")
    q, k, v = (torch.randn(2, 256, h, 128, generator=gen).bfloat16()
               for h in (8, 2, 2))
    ref = IF.fused_dot_product_attention(q, k, v, is_causal=True).float()
    qc, kc, vc = (t.to(cuda_card).requires_grad_(True) for t in (q, k, v))
    read = _launches()
    out = IF.fused_dot_product_attention(qc, kc, vc, is_causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert read() == [1, 1, 1]
    assert float((out.float().cpu() - ref).abs().max()
                 / ref.abs().max()) < TOL_BF16
    read = _launches()
    IF.fused_dot_product_attention(
        qc, kc, vc, is_causal=True,
        attn_mask=torch.ones(2, 1, 1, 256, dtype=torch.bool,
                             device=cuda_card))
    assert read() == [0, 0, 0]


@pytest.mark.gpu
def test_seed_repeats_layers_built_on_the_card(cuda_card):
    ptt.seed(3)
    a = nn.Sequential(nn.Linear(16, 8), nn.PReLU(8), nn.Dropout(0.5))
    ptt.seed(3)
    b = nn.Sequential(nn.Linear(16, 8), nn.PReLU(8), nn.Dropout(0.5))
    x = torch.randn(4, 16, device=cuda_card)
    assert a[0].weight.device.type == "cuda"
    assert torch.equal(a(x), b(x))
