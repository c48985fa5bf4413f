"""The fine-tuning slice on the card: LoRA, packed SFT, DPO, merge, PTQ and
QAT through the port's kernels. Every test here is marked ``gpu`` and
skips, from its fixture, on a machine without a CUDA card. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_finetune_gpu.py -m gpu --noconftest

A small Llama (hidden 512, 8 / 2 heads of 64: the flash kernels' wgmma
route in bf16) is held against its twin on the CPU (the plain versions)
or against the plain versions on the card: the packed SFT loss and the
adapter gradients through the flash forward, dq and dk/dv with segments;
the fused AdamW over the adapters alone; a merge after a captured
``generate()`` (the program is rebuilt, so the merged weights serve, not
the adapter's captured delta); ``W8A8Linear`` on the quantized-matmul
kernel against the plain version of that kernel; QAT steps."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops.kernels import quant_matmul as qm
from paddle_tpu_torch.ops.kernels.decode_attention import decode_attention_fwd
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.fused_adam import fused_adam
from paddle_tpu_torch.peft import (LoRAConfig, apply_lora, lora_state_dict,
                                   merge_lora, unmerge_lora)
from paddle_tpu_torch.quant import PTQ, FakeQuantLinear, W8A8Linear
from paddle_tpu_torch.trl import (DataCollatorForSFT, SFTTrainer,
                                  compute_sequence_logps)

SMALL = dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=2, max_position_embeddings=1024,
             rope_theta=10000.0)
ALL7 = [".*q_proj", ".*k_proj", ".*v_proj", ".*o_proj", ".*gate_proj",
        ".*up_proj", ".*down_proj"]
# fp32 on the card (flash simt kernels, fp32 matmuls without TF32) against
# the CPU: the same sums in another order
TOL_FP32_LOSS = 1e-5
TOL_FP32_GRAD = 1e-4
# bf16 kernels against the plain versions on the card: relative l2 of a
# gradient (p and ds rounded to bf16 at other points, sums in another
# order), as chip_smoke.py's TOL_GRAD_REL
TOL_BF16_GRAD = 2e-2
# W8A8 on the kernel against the plain quant matmul: one bf16 step of an
# output, amplified by 2 layers (relative to max |logit|)
TOL_W8A8 = 2.0 ** -5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, dtype, seed=0, **kw):
    cfg = ptt.LlamaConfig(**dict(SMALL, dtype=dtype, **kw))
    return ptt.LlamaForCausalLM(cfg, device=dev,
                                generator=ptt.make_generator(seed, "cpu")
                                if dev.type == "cpu" else
                                ptt.make_generator(seed, dev))


def _twins(dev, dtype=torch.float32):
    """The same weights on the card and on the CPU, LoRA on every
    projection with B drawn nonzero (A trains from the first step)."""
    cpu = _model(torch.device("cpu"), dtype)
    apply_lora(cpu, LoRAConfig(r=8, lora_alpha=16, target_modules=ALL7),
               ptt.make_generator(1, "cpu"))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for k, v in lora_state_dict(cpu).items():
            if k.endswith("lora_B"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.02)
    card = _model(dev, dtype)
    apply_lora(card, LoRAConfig(r=8, lora_alpha=16, target_modules=ALL7),
               ptt.make_generator(1, dev))
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    return cpu, card


def _packed_batch(rows=2, length=512, seed=3):
    rs = np.random.RandomState(seed)
    ex = []
    coll = DataCollatorForSFT(max_length=length, packing=True,
                              pack_rows=rows)
    while True:
        n = int(rs.randint(16, 160))
        cand = ex + [{"prompt_ids": rs.randint(1, 1024, n // 3).tolist(),
                      "response_ids": rs.randint(1, 1024,
                                                 n - n // 3).tolist()}]
        try:
            coll(cand)
        except ValueError:
            return coll(ex)
        ex = cand


def _reset(*fns):
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _sft_grads(model, batch):
    from paddle_tpu_torch.trl import _make_sft_loss
    loss = _make_sft_loss(True)(model, batch)
    params = [p for _, p in lora_state_dict(model).items()]
    return loss, torch.autograd.grad(loss, params)


@pytest.mark.gpu
def test_packed_sft_grads_card_vs_cpu_fp32(cuda_card):
    """fp32 (the flash simt kernels with segments): the packed SFT loss and
    every adapter gradient on the card against the CPU twin's."""
    cpu, card = _twins(cuda_card)
    batch = _packed_batch()
    assert int(batch["segment_ids"].max()) > 2
    l_cpu, g_cpu = _sft_grads(cpu, batch)
    _reset(flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
    l_card, g_card = _sft_grads(card, {k: v.to(cuda_card)
                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    L = SMALL["num_hidden_layers"]
    assert flash_attention_fwd.launches == L
    assert flash_attention_bwd_dq.launches == L
    assert flash_attention_bwd_dkv.launches == L
    assert float(l_card) == pytest.approx(float(l_cpu), rel=TOL_FP32_LOSS)
    for a, b in zip(g_card, g_cpu):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) <= TOL_FP32_GRAD * scale


@pytest.mark.gpu
def test_packed_sft_grads_bf16_wgmma_vs_plain(cuda_card):
    """bf16 at head_dim 64: the forward, dq and dk/dv launch on the wgmma
    route with segments, and the adapter gradients are within
    TOL_BF16_GRAD (relative l2) of the same step on the kernels' plain
    versions on the card."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    _, card = _twins(cuda_card, torch.bfloat16)
    batch = {k: v.to(cuda_card) for k, v in _packed_batch().items()}
    _reset(flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv)
    _, g_kernel = _sft_grads(card, batch)
    torch.cuda.synchronize()
    for fn in (flash_attention_fwd, flash_attention_bwd_dq,
               flash_attention_bwd_dkv):
        assert fn.launches_by_route == {"wgmma": 2, "simt": 0}

    # the plain versions, at the kernels' rounding points
    real = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_fwd_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        _, g_plain = _sft_grads(card, batch)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = real
    for a, b in zip(g_kernel, g_plain):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= TOL_BF16_GRAD, rel


@pytest.mark.gpu
def test_sft_trainer_updates_adapters_with_one_fused_launch(cuda_card,
                                                            tmp_path):
    """bf16 model, AdamW with fp32 masters over the adapters alone: one
    fused update a step, the base weights bit for bit as they were, every
    B moved, the loss falling."""
    card = _model(cuda_card, torch.bfloat16)
    apply_lora(card, LoRAConfig(r=8, lora_alpha=16, target_modules=ALL7),
               ptt.make_generator(1, cuda_card))
    base = {k: v.detach().clone() for k, v in card.named_parameters()
            if "lora" not in k}
    batch = _packed_batch()
    opt = ptt.optimizer.AdamW(learning_rate=1e-3, multi_precision=True)
    tr = SFTTrainer(card, opt, ptt.TrainingArguments(
        output_dir=str(tmp_path), max_steps=3, logging_steps=1,
        graceful_shutdown=False), train_dataloader=[batch])
    _reset(fused_adam)
    tr.train()
    assert fused_adam.launches == 3
    assert len(tr._opt_state["slots"]) == len(lora_state_dict(card))
    for k, v in card.named_parameters():
        if "lora" in k:
            if k.endswith("lora_B"):
                assert v.abs().sum() > 0, k
        else:
            assert torch.equal(v, base[k]), k
    losses = [v for _, v in tr.logger.history["loss"]]
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_merge_after_capture_rebuilds_the_program(cuda_card):
    """``generate()`` captures its decode step with the adapters' hooks in
    it; after ``merge_lora`` the next call recaptures (the hooks changed),
    so each greedy token is the argmax of a fresh forward over the merged
    weights; the decode kernel runs each step; ``unmerge_lora`` brings
    the adapted model's tokens back."""
    _, card = _twins(cuda_card, torch.bfloat16)
    card.eval()
    ids = torch.randint(0, 1024, (2, 64), device=cuda_card,
                        generator=ptt.make_generator(4, cuda_card))
    cfg = ptt.GenerationConfig(max_new_tokens=8)
    outs = []
    for step in ("adapted", "merged", "unmerged"):
        if step == "merged":
            merge_lora(card)
        elif step == "unmerged":
            unmerge_lora(card)
        _reset(decode_attention_fwd)
        with torch.inference_mode():
            out = ptt.generate(card, ids, cfg)
            logits = card(out[:, :-1])
        torch.cuda.synchronize()
        assert decode_attention_fwd.launches == 2 * 7
        # greedy: each new token is the argmax of a teacher-forced forward
        # (within bf16 rounding of the top two logits)
        top2 = logits[:, 63:].float().topk(2, dim=-1).values
        pick = logits[:, 63:].float().gather(-1, out[:, 64:, None])[..., 0]
        assert bool(((top2[..., 0] - pick) <= 0.125).all()), step
        outs.append(out)
    assert torch.equal(outs[0], outs[2]) or \
        int((outs[0] != outs[2]).sum()) <= 2


@pytest.mark.gpu
def test_w8a8_on_the_quant_kernel_vs_plain(cuda_card):
    """A bf16 Llama of hidden 512 calibrated (``lm_head`` skipped) and
    converted: a 32-token forward runs every W8A8Linear on the quant
    kernel (mma route, 7 a layer) and its logits are within TOL_W8A8 of
    the same forward on the kernel's plain version."""
    model = _model(cuda_card, torch.bfloat16).eval()
    ptq = PTQ(model, skip=["lm_head"])
    g = ptt.make_generator(5, cuda_card)
    with torch.no_grad():
        for _ in range(2):
            model(torch.randint(0, 1024, (1, 128), device=cuda_card,
                                generator=g))
    ptq.convert()
    assert sum(isinstance(m, W8A8Linear) for m in model.modules()) == 14
    ids = torch.randint(0, 1024, (1, 32), device=cuda_card, generator=g)
    _reset(qm.quant_matmul)
    with torch.no_grad():
        got = model(ids).float()
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches_by_route == {"mma": 14, "simt": 0}
    import paddle_tpu_torch.quant.weight_only as wo

    def plain(x, qweight, scales, bits, block_offset=0):
        return qm.quant_matmul_plain(x, qweight, scales, bits)
    real = wo.quant_matmul
    wo.quant_matmul = plain
    try:
        with torch.no_grad():
            ref = model(ids).float()
    finally:
        wo.quant_matmul = real
    assert float((got - ref).abs().max()) <= \
        TOL_W8A8 * float(ref.abs().max())


@pytest.mark.gpu
def test_qat_steps_and_reference_logps(cuda_card, tmp_path):
    """FakeQuantLinear on every projection of a bf16 model: two Trainer
    steps with finite, falling losses; ``compute_sequence_logps`` leaves
    the training mode as it was."""
    model = _model(cuda_card, torch.bfloat16)
    for layer in model.model.layers:
        for mod in (layer.self_attn, layer.mlp):
            for name, sub in list(mod.named_children()):
                if hasattr(sub, "in_features"):
                    setattr(mod, name, FakeQuantLinear(sub))
    ids = torch.randint(0, 1024, (2, 256), device=cuda_card,
                        generator=ptt.make_generator(6, cuda_card))
    mask = torch.ones_like(ids)
    model.train()
    ref = compute_sequence_logps(model, ids, mask)
    assert model.training and bool(torch.isfinite(ref).all())
    tr = ptt.Trainer(model, ptt.optimizer.AdamW(learning_rate=1e-3,
                                                multi_precision=True),
                     ptt.TrainingArguments(output_dir=str(tmp_path),
                                           max_steps=3, logging_steps=1,
                                           graceful_shutdown=False),
                     train_dataloader=[ids])
    tr.train()
    losses = [v for _, v in tr.logger.history["loss"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
