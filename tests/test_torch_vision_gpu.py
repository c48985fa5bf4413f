"""The vision and diffusion families on the card. Every test here is marked
``gpu`` and skips, from its fixture, on a machine without a CUDA card.
The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_vision_gpu.py -m gpu --noconftest

``DiTPipeline`` and ``StableDiffusion3Pipeline`` under ``amp.auto_cast``:
the denoising loop replayed from its captured graph equals the eager
loop (``generation.eager_steps``) bit for bit; a second call at a new
guidance scale replays the same graph (no recapture) and equals its
eager loop too. Each family's bf16 forward is held to the same weights
in fp32 on the card within ``TOL_BF16`` (relative l2), and one
``DiTBlock``, one VAE ``ResnetBlock`` and one ``ConvBNLayer`` alone, so
that a rounding point out of place shows where it is."""
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.diffusion import (DiTPipeline, FlowMatchScheduler,
                                        StableDiffusion3Pipeline)
from paddle_tpu_torch.generation import eager_steps
from paddle_tpu_torch.models import dit, ppocr, resnet, vae
from paddle_tpu_torch.models import clip as clip_m
from paddle_tpu_torch.models import vit as vit_m

# bf16 against fp32 on the same weights, relative l2 of the output: bf16
# keeps 8 bits of mantissa (2^-8 = 3.9e-3 a rounding), and a few layers
# of rounded activations and weights compound it
TOL_BF16 = 3e-2


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@torch.no_grad()
def _randomize(model, seed, std=0.02):
    """Seeded noise on every floating parameter (adaLN-Zero layers start
    at zero: without it a DiT block is the identity)."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    for p in model.parameters():
        if p.is_floating_point():
            p.add_(std * torch.randn(p.shape, generator=gen,
                                     device=p.device).to(p.dtype))
    return model


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _pair(cls, cfg32, cfg16, dev, seed=0):
    """(fp32 model, the same weights in a bf16 model)."""
    m32 = _randomize(cls(cfg32, device=dev,
                         generator=ptt.make_generator(seed, dev)), seed + 1)
    m16 = cls(cfg16, device=dev, generator=ptt.make_generator(seed, dev))
    m16.load_state_dict(m32.state_dict())
    return m32.eval(), m16.eval()


def _dit_pipeline(dev):
    cfg = dict(input_size=16, hidden_size=256, num_hidden_layers=3,
               num_attention_heads=4, num_classes=10)
    model = _randomize(dit.DiT(dit.DiTConfig(**cfg, dtype=torch.bfloat16),
                               device=dev,
                               generator=ptt.make_generator(1, dev)), 2)
    ae = _randomize(vae.AutoencoderKL(vae.vae_tiny(dtype=torch.bfloat16),
                                      device=dev,
                                      generator=ptt.make_generator(3, dev)),
                    4)
    return DiTPipeline(model, ae), ([1, 5, 9],)


def _sd3_pipeline(dev):
    cfg = dit.mmdit_tiny(input_size=16, hidden_size=128, context_dim=64,
                         pooled_dim=32, dtype=torch.bfloat16)
    model = _randomize(dit.MMDiT(cfg, device=dev,
                                 generator=ptt.make_generator(5, dev)), 6)
    ae = _randomize(vae.AutoencoderKL(vae.vae_tiny(dtype=torch.bfloat16),
                                      device=dev,
                                      generator=ptt.make_generator(7, dev)),
                    8)
    gen = torch.Generator(device=dev).manual_seed(9)
    ctx = torch.randn(2, 12, 64, generator=gen, device=dev)
    pooled = torch.randn(2, 32, generator=gen, device=dev)
    return StableDiffusion3Pipeline(
        model, ae, scheduler=FlowMatchScheduler(shift=3.0)), (ctx, pooled)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("dit", "sd3"))
def test_pipeline_graph_equals_its_eager_loop(cuda_card, kind):
    pipe, args = (_dit_pipeline if kind == "dit" else _sd3_pipeline)(
        cuda_card)

    def run(scale, eager=False):
        gen = torch.Generator(device=cuda_card).manual_seed(11)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            if eager:
                with eager_steps():
                    return pipe(*args, num_inference_steps=4,
                                guidance_scale=scale, generator=gen)
            return pipe(*args, num_inference_steps=4, guidance_scale=scale,
                        generator=gen)
    graphed = run(4.0)
    (prog,) = pipe._programs.programs.values()
    graph = prog.step.graph
    assert graph is not None
    assert torch.equal(graphed, run(4.0, eager=True))
    assert torch.equal(graphed, run(4.0))
    again = run(6.5)
    assert prog.step.graph is graph and len(pipe._programs) == 1
    assert not torch.equal(again, graphed)
    assert torch.equal(again, run(6.5, eager=True))
    assert torch.isfinite(graphed.float()).all()


def _inputs(dev, *shape, seed=12):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.gpu
def test_families_bf16_against_fp32(cuda_card):
    dev = cuda_card
    bf = torch.bfloat16
    errs = {}
    with torch.no_grad():
        m32, m16 = _pair(vit_m.ViTForImageClassification, vit_m.vit_tiny(),
                         vit_m.vit_tiny(dtype=bf), dev)
        x = _inputs(dev, 4, 3, 32, 32)
        errs["vit"] = _rel(m16(x.to(bf)), m32(x))
        c32 = clip_m.clip_tiny()
        c16 = clip_m.clip_tiny()
        c16.text.dtype = c16.vision.dtype = bf
        m32, m16 = _pair(clip_m.CLIPModel, c32, c16, dev)
        ids = torch.randint(0, 128, (4, 16), device=dev)
        px = _inputs(dev, 4, 3, 16, 16)
        errs["clip"] = _rel(m16(ids, px.to(bf))[0], m32(ids, px)[0])
        m32, m16 = _pair(resnet.ResNet, resnet.resnet_tiny(),
                         resnet.resnet_tiny(dtype=bf), dev)
        x = _inputs(dev, 4, 3, 64, 64)
        errs["resnet"] = _rel(m16(x.to(bf)), m32(x))
        m32, m16 = _pair(ppocr.DBNet, ppocr.dbnet_tiny(),
                         ppocr.dbnet_tiny(dtype=bf), dev)
        errs["dbnet"] = _rel(m16(x.to(bf))["maps"], m32(x)["maps"])
        m32, m16 = _pair(ppocr.SVTRNet, ppocr.svtr_tiny(),
                         ppocr.svtr_tiny(dtype=bf), dev)
        x = _inputs(dev, 4, 3, 16, 32)
        errs["svtr"] = _rel(m16(x.to(bf)), m32(x))
        lat = _inputs(dev, 4, 4, 8, 8)
        t = torch.tensor([1, 200, 600, 999], device=dev)
        y = torch.tensor([0, 3, 5, 9], device=dev)
        m32, m16 = _pair(dit.DiT, dit.dit_tiny(), dit.dit_tiny(dtype=bf),
                         dev)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            errs["dit"] = _rel(m16(lat, t, y), m32(lat, t, y))
            errs["dit_block"] = _rel(
                m16.blocks[0](_inputs(dev, 4, 16, 64).to(bf),
                              _inputs(dev, 4, 64, seed=13).to(bf)),
                m32.blocks[0](_inputs(dev, 4, 16, 64),
                              _inputs(dev, 4, 64, seed=13)))
        m32, m16 = _pair(dit.MMDiT, dit.mmdit_tiny(),
                         dit.mmdit_tiny(dtype=bf), dev)
        ctx, pooled = _inputs(dev, 4, 5, 48), _inputs(dev, 4, 32)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            errs["mmdit"] = _rel(m16(lat, t, ctx, pooled),
                                 m32(lat, t, ctx, pooled))
        m32, m16 = _pair(vae.AutoencoderKL, vae.vae_tiny(),
                         vae.vae_tiny(dtype=bf), dev)
        img = _inputs(dev, 2, 3, 32, 32)
        with ptt.amp.auto_cast(dtype="bfloat16"):
            errs["vae"] = _rel(m16(img)[0], m32(img)[0])
        blk = m32.decoder.mid[0]
        blk16 = m16.decoder.mid[0]
        h = _inputs(dev, 2, 32, 8, 8)
        errs["vae_resnet_block"] = _rel(blk16(h.to(bf)), blk(h))
        cb32 = _randomize(resnet.ConvBNLayer(
            16, 32, 3, stride=2, act="relu", device=dev,
            generator=ptt.make_generator(14, dev)), 15).eval()
        cb16 = resnet.ConvBNLayer(16, 32, 3, stride=2, act="relu",
                                  device=dev,
                                  generator=ptt.make_generator(14, dev))
        cb16.load_state_dict(cb32.state_dict())
        cb16 = cb16.to(bf).eval()
        h = _inputs(dev, 2, 16, 16, 16)
        errs["conv_bn"] = _rel(cb16(h.to(bf)), cb32(h))
    bad = {k: v for k, v in errs.items() if not v < TOL_BF16}
    assert not bad, (bad, errs)
