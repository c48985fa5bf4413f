"""The second training slice on the card: the fused Adam / AdamW kernel
against its plain version, and the Trainer's fp16 and checkpoint paths.
Every test here is marked ``gpu`` and skips, from its fixture, on a
machine without a CUDA card. The file imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_train_gpu.py -m gpu --noconftest

The kernel (``csrc/fused_adam.cu``) is held against
``fused_adam_reference`` on the same card and inputs: bf16, fp16 and
fp32 parameters, with and without fp32 masters, fp32 and 16-bit
gradients, Adam and AdamW, decay on some tensors only, a clip scale
below 1, a GradScaler's inverse scale; tensors whose sizes leave ragged
tails; ``found_inf`` set leaves every byte as it was; a repeat gives the
same bits; one launch per (parameter type, gradient type) group, and the
device table is reused until a pointer moves. Then a small bf16 Llama
through ``Trainer`` (AdamW, fp32 masters): one launch a step; an fp16
Llama with a GradScaler; a checkpoint of the bf16 run restored bit for
bit."""
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.kernels.fused_adam import (fused_adam,
                                                     fused_adam_reference)

# kernel vs plain version, max |d| over a tensor against max |ref| of it:
# the kernel rounds every fp32 op on its own as the plain ops do, but
# PyTorch divides a CUDA tensor by a Python scalar through its
# reciprocal, so u may differ by an ulp and the fp32 master by an ulp of
# its largest element (2^-22 leaves a factor of 2); m and v take no
# division. A 16-bit parameter is the master rounded once: one step of
# its type where a master's ulp crosses a rounding boundary.
TOL_ADAM = {torch.float32: 2.0 ** -22, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}
# sizes with ragged tails: not multiples of 4 nor of the 2048-element
# chunk, one below a vector, one of several chunks
SHAPES = [(257, 37), (4096,), (3,), (2049, 3), (8, 1024)]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    return torch.device("cuda")


def adam_case(dev, pdtype, gdtype, masters, seed=0, shapes=SHAPES):
    """Parameters, gradients, masters, m and v on ``dev`` from a seed, the
    state as after a few steps (m, v nonzero)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    ws = [rnd(s) for s in shapes]
    params = [w.to(pdtype) for w in ws]
    grads = [rnd(s, 1e-2).to(gdtype) for s in shapes]
    ms = [rnd(s, 1e-3) for s in shapes]
    vs = [rnd(s, 1e-3).square() for s in shapes]
    mas = [w.clone() for w in ws] if masters else None
    return params, grads, mas, ms, vs


def clone_case(case):
    params, grads, mas, ms, vs = case
    return ([t.clone() for t in params], grads,
            [t.clone() for t in mas] if mas is not None else None,
            [t.clone() for t in ms], [t.clone() for t in vs])


def worst_share(got, want, dtype):
    d = (got.float() - want.float()).abs().max()
    return float(d / (TOL_ADAM[dtype] * want.float().abs().max()
                      + 1e-30))


HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
             step=7)


def run_both(dev, pdtype, gdtype, masters, decoupled, clip, inv):
    case = adam_case(dev, pdtype, gdtype, masters)
    decay = [i % 2 == 0 for i in range(len(SHAPES))]
    clip_t = (torch.tensor(clip, device=dev) if clip is not None
              else None)
    inv_t = torch.tensor(inv, device=dev) if inv is not None else None
    a, b = clone_case(case), clone_case(case)
    kw = dict(HYPER, decoupled=decoupled, clip_scale=clip_t,
              inv_scale=inv_t)
    fused_adam(a[0], a[1], a[2], a[3], a[4], decay, **kw)
    fused_adam_reference(b[0], b[1], b[2], b[3], b[4], decay, **kw)
    torch.cuda.synchronize()
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype,gdtype,masters", [
    (torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.float32, False),
    (torch.float16, torch.float16, True),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.float32, torch.bfloat16, True)])
@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("clip,inv", [(None, None), (0.25, None),
                                      (0.5, 2.0 ** -15)])
def test_fused_adam_kernel_matches_plain(cuda_card, pdtype, gdtype, masters,
                                         decoupled, clip, inv):
    a, b = run_both(cuda_card, pdtype, gdtype, masters, decoupled, clip,
                    inv)
    shares = []
    for i in range(len(SHAPES)):
        shares.append(worst_share(a[0][i], b[0][i], pdtype))
        shares.append(worst_share(a[3][i], b[3][i], torch.float32))
        shares.append(worst_share(a[4][i], b[4][i], torch.float32))
        if masters:
            shares.append(worst_share(a[2][i], b[2][i], torch.float32))
    assert max(shares) <= 1.0, shares


@pytest.mark.gpu
def test_fused_adam_skips_on_found_inf_and_repeats(cuda_card):
    case = adam_case(cuda_card, torch.bfloat16, torch.bfloat16, True)
    decay = [True] * len(SHAPES)
    before = clone_case(case)
    kw = dict(HYPER, decoupled=True,
              inv_scale=torch.tensor(0.5, device=cuda_card))
    fused_adam(case[0], case[1], case[2], case[3], case[4], decay,
               found_inf=torch.tensor(True, device=cuda_card), **kw)
    torch.cuda.synchronize()
    for got, want in zip(case[0] + case[2] + case[3] + case[4],
                         before[0] + before[2] + before[3] + before[4]):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    runs = []
    for _ in range(2):
        c = clone_case(before)
        fused_adam(c[0], c[1], c[2], c[3], c[4], decay,
                   found_inf=torch.tensor(False, device=cuda_card), **kw)
        runs.append(c)
    torch.cuda.synchronize()
    for x, y in zip(runs[0][0] + runs[0][2], runs[1][0] + runs[1][2]):
        assert torch.equal(x, y)
    assert not torch.equal(runs[0][2][0], before[2][0])


@pytest.mark.gpu
def test_fused_adam_one_launch_a_group_and_table_reuse(cuda_card):
    case = adam_case(cuda_card, torch.bfloat16, torch.bfloat16, True)
    mixed = adam_case(cuda_card, torch.float32, torch.float32, True,
                      seed=1, shapes=[(64, 8), (5,)])
    cache = {}
    decay = [True] * len(SHAPES)
    fused_adam.launches = 0
    fused_adam(case[0], case[1], case[2], case[3], case[4], decay,
               decoupled=True, cache=cache, **HYPER)
    table = cache["table"]
    fused_adam(case[0], [g.clone() for g in case[1]], case[2], case[3],
               case[4], decay, decoupled=True, cache=cache, **HYPER)
    assert cache["table"] is table          # new gradients, same table
    assert fused_adam.launches == 2
    both = [a + b for a, b in zip(case, mixed)]
    fused_adam(*both, decay + [False, True], decoupled=True, cache=cache,
               **HYPER)
    assert cache["table"] is not table
    assert fused_adam.launches == 4          # two groups: two launches
    torch.cuda.synchronize()


SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512)


def _batches(dev, n=2, b=2, s=128):
    g = torch.Generator(device="cpu").manual_seed(4)
    return [torch.randint(0, 1024, (b, s), generator=g) for _ in range(n)]


def _trainer(dev, dtype, out, steps, scaler=None, **kw):
    model = ptt.LlamaForCausalLM(ptt.LlamaConfig(**SMALL, dtype=dtype),
                                 device=dev,
                                 generator=ptt.make_generator(0, dev))
    opt = ptt.optimizer.AdamW(
        learning_rate=1e-3, multi_precision=True,
        grad_clip=ptt.optimizer.ClipGradByGlobalNorm(1.0))
    args = ptt.TrainingArguments(output_dir=str(out), max_steps=steps,
                                 logging_steps=1, **kw)
    return ptt.Trainer(model, opt, args, train_dataloader=_batches(dev),
                       scaler=scaler)


@pytest.mark.gpu
def test_trainer_steps_through_the_kernel_and_resumes(cuda_card, tmp_path):
    fused_adam.launches = 0
    tr = _trainer(cuda_card, torch.bfloat16, tmp_path / "a", 4,
                  save_steps=2)
    tr.train()
    assert fused_adam.launches == 4
    losses = [v for _, v in tr.logger.history["loss"]]
    assert losses[-1] < losses[0]
    params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    tr.save_checkpoint(wait=True)
    # a fresh trainer on fresh weights restores step 4 bit for bit
    tr2 = _trainer(cuda_card, torch.bfloat16, tmp_path / "a", 4,
                   save_steps=2)
    tr2._opt_state = tr2.optimizer.init(tr2._trainable)
    assert tr2._try_resume() == 4
    for k, p in tr2.model.named_parameters():
        assert torch.equal(p, params[k]), k
    for k in tr._opt_state["master"]:
        assert torch.equal(tr2._opt_state["master"][k],
                           tr._opt_state["master"][k])


@pytest.mark.gpu
def test_fp16_trainer_with_a_grad_scaler(cuda_card, tmp_path):
    from paddle_tpu_torch.amp import GradScaler
    scaler = GradScaler(init_loss_scaling=2.0 ** 30)  # overflows at first
    tr = _trainer(cuda_card, torch.float16, tmp_path / "b", 6,
                  scaler=scaler)
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    fused_adam.launches = 0
    tr.train(max_steps=1)
    scale = float(tr._scaler_state["scale"])
    if scale < 2.0 ** 30:                   # step 1 skipped: bits kept
        for k, p in tr.model.named_parameters():
            assert torch.equal(p, before[k]), k
    tr.train()
    assert fused_adam.launches == 6
    losses = [v for _, v in tr.logger.history["loss"]]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert float(tr._scaler_state["scale"]) < 2.0 ** 30
