"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_fwd, decode_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)

pytestmark = pytest.mark.gpu

# bf16: kernel and plain version round p and out to bf16 at the same
# points but sum in another order, and round p against another running
# max; 2e-2 covers that for outputs of magnitude up to ~2. fp32: the same
# sums in another order.
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    return torch.device("cuda")


def _randn(rs, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("case", [
    dict(b=2, s=256, h=8, kv=2, d=128, causal=True),
    dict(b=1, s=200, h=4, kv=4, d=64, causal=False),
    dict(b=1, s=256, h=4, kv=1, d=256, causal=True, window=70),
    dict(b=2, s=256, h=4, kv=2, d=64, causal=True, seg=True),
], ids=["gqa-causal", "ragged-full", "d256-window", "segments"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_kernel_matches_plain(cuda_card, case, dtype):
    rs = np.random.RandomState(0)
    b, s, h, kv, d = (case[k] for k in ("b", "s", "h", "kv", "d"))
    q = _randn(rs, b, s, h, d, scale=0.5).to(cuda_card, dtype)
    k = _randn(rs, b, s, kv, d, scale=0.5).to(cuda_card, dtype)
    v = _randn(rs, b, s, kv, d).to(cuda_card, dtype)
    seg = None
    if case.get("seg"):
        seg = torch.ones(b, s, dtype=torch.int32)
        seg[:, 100:] = 2
        seg[:, -8:] = 0
        seg = seg.to(cuda_card)
    kw = dict(causal=case["causal"], window=case.get("window"),
              segment_ids=seg)
    n = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == n + 1
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("cache_index,window", [(0, None), (127, None),
                                                (639, None), (400, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_decode_kernel_matches_plain(cuda_card, cache_index, window, dtype):
    rs = np.random.RandomState(cache_index)
    b, T, h, kv, d = 4, 640, 32, 8, 128
    q = _randn(rs, b, h, d).to(cuda_card, dtype)
    ck = _randn(rs, b, T, kv, d).to(cuda_card, dtype)
    cv = _randn(rs, b, T, kv, d).to(cuda_card, dtype)
    n = decode_attention_fwd.launches
    out = decode_attention_fwd(q, ck, cv, cache_index, window=window)
    torch.cuda.synchronize()
    assert decode_attention_fwd.launches == n + 1
    ref = decode_attention_fwd_plain(q, ck, cv, cache_index, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)
