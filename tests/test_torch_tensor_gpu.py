"""The tensor-level API's transforms on the card. Every test here is
marked ``gpu`` and skips, from its fixture, on a machine without a CUDA
card. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_tensor_gpu.py -m gpu --noconftest

``ptt.vmap`` over the flash kernel folds the mapped dim into the batch
dim: one forward launch serves the mapped call, each slice bit for bit
its own call; ``ptt.grad`` of the mapped sum launches dq and dk/dv once
each, bit for bit the slices' eager gradients; forward mode through the
kernel raises. A user ``PyLayer`` gives the same gradients under eager
``.backward()`` and under ``ptt.grad``, equal to the CPU's; ``no_grad``
inside ``ptt.grad`` cuts nothing. ``histogram`` and ``lstsq`` run on the
card and equal the CPU's.
"""
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import autograd, linalg, nn
from paddle_tpu_torch import tensor as P
from paddle_tpu_torch.ops.attention import flash_attention
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

# fp32 card math against the CPU's (the same products, other sum order)
TOL_FP32 = 1e-4


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


def _qkv(dev, lead=2, b=1, s=256, h=8, kv=2, d=128):
    gen = ptt.make_generator(3, dev)
    return [torch.randn(lead, b, s, n, d, generator=gen, device=dev,
                        dtype=torch.bfloat16) for n in (h, kv, kv)]


def _flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


@pytest.mark.gpu
def test_vmap_of_flash_is_one_launch_and_the_slices(cuda_card):
    q, k, v = _qkv(cuda_card)
    read = _launches()
    out = ptt.vmap(_flash)(q, k, v)
    torch.cuda.synchronize()
    assert read() == [1, 0, 0]
    for i in range(2):
        assert torch.equal(out[i], _flash(q[i], k[i], v[i]))


@pytest.mark.gpu
def test_grad_of_vmapped_flash_is_one_launch_each(cuda_card):
    q, k, v = _qkv(cuda_card)
    cot = torch.randn_like(q)

    def loss(q, k, v):
        return (ptt.vmap(_flash)(q, k, v).float() * cot.float()).sum()
    read = _launches()
    grads = ptt.grad(loss, argnums=(0, 1, 2))(q, k, v)
    torch.cuda.synchronize()
    assert read() == [1, 1, 1]
    for i in range(2):
        xs = [t[i].detach().requires_grad_() for t in (q, k, v)]
        (_flash(*xs).float() * cot[i].float()).sum().backward()
        for g, x in zip(grads, xs):
            assert torch.equal(g[i], x.grad)


@pytest.mark.gpu
def test_forward_mode_through_flash_raises(cuda_card):
    q, k, v = (t[0] for t in _qkv(cuda_card))
    with pytest.raises(NotImplementedError, match="jvp"):
        ptt.jvp(lambda q: _flash(q, k, v), (q,), (torch.ones_like(q),))


class _ClippedSTE(autograd.PyLayer):
    """Ternary forward (sign where |x| > 0.5, else 0), the gradient passed
    straight through where |x| <= 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x) * (x.abs() > 0.5).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensor()
        return g * (x.abs() <= 1).to(g.dtype)


class _Quantized(nn.Layer):
    def __init__(self, device):
        super().__init__()
        self.fc = nn.Linear(16, 8, device=device,
                            generator=ptt.make_generator(5, device))

    def forward(self, x):
        with ptt.no_grad():
            scale = x.abs().amax() + 1
        return _ClippedSTE.apply(self.fc(x) / scale) * scale


def _grads(layer, x):
    pure, params = layer.functional()
    layer.zero_grad()
    layer(x).square().sum().backward()
    eager = {n: p.grad.clone() for n, p in layer.named_parameters()}
    func = ptt.grad(lambda p: pure(p, x).square().sum())(
        {n: p.detach() for n, p in params.items()})
    return eager, func


@pytest.mark.gpu
def test_pylayer_on_the_card_both_routes_and_the_cpu(cuda_card):
    x = torch.randn(32, 16, generator=ptt.make_generator(6, "cpu"))
    card, cpu = _Quantized(cuda_card), _Quantized("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    eager, func = _grads(card, x.to(cuda_card))
    c_eager, c_func = _grads(cpu, x)
    for n in eager:
        assert torch.equal(eager[n], func[n]), n
        torch.testing.assert_close(eager[n].cpu(), c_eager[n], rtol=TOL_FP32,
                                   atol=TOL_FP32)
        assert torch.equal(c_eager[n], c_func[n]), n

    def f(x):
        with ptt.no_grad():
            y = 2 * x
        return (y * x).sum()
    assert ptt.grad(f)(torch.ones(3, device=cuda_card)).tolist() == [4.] * 3


@pytest.mark.gpu
def test_histogram_and_lstsq_on_the_card(cuda_card):
    a = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0, 1.0, -0.1, 1.1])
    for kw in (dict(bins=4, min=0, max=1), dict(bins=3),
               dict(bins=4, min=0, max=1, density=True)):
        got = P.histogram(a.to(cuda_card), **kw)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), P.histogram(a, **kw))
    gen = ptt.make_generator(7, "cpu")
    x = torch.randn(6, 3, generator=gen)
    x = torch.cat([x[:, :2], x[:, :1] + x[:, 1:2]], 1)     # rank 2
    y = torch.randn(6, 2, generator=gen)
    got = linalg.lstsq(x.to(cuda_card), y.to(cuda_card))
    want = linalg.lstsq(x, y)
    assert int(got[2]) == int(want[2]) == 2
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=TOL_FP32, atol=TOL_FP32)
