"""The port's HF and diffusers interop for the vision and diffusion
families against the JAX package's: checkpoints in the HF layout (ViT,
CLIP, ResNet: their keys written from seeded numpy) and the diffusers
layout (AutoencoderKL, DiTTransformer2DModel, SD3Transformer2DModel: a
JAX model's seeded, perturbed weights written out by the JAX package's
own ``_revert_*``) load through both ``from_pretrained`` into the same
configs (``config_from_hf``, field by field), the same parameters (bit
for bit, fp32, through the port's ``jax_state_dict``) and the same
outputs (within ``TOL_OUT``). ``to_hf_state_dict`` writes the diffusers
layouts back bit for bit. The JAX refusals keep their messages. Where
``transformers`` imports, the HF ViT, CLIP and ResNet models on the same
files give the same outputs."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import dit as jdit
from paddle_tpu.models import hf_interop as jax_hf
from paddle_tpu.models import vae as jvae
from paddle_tpu_torch.convert import jax_state_dict
from paddle_tpu_torch.models import hf_interop

safetensors_numpy = pytest.importorskip("safetensors.numpy")

TOL_OUT = 1e-4      # absolute: one fp32 forward, as the zoo tests hold it

H, FFN, LAYERS, HEADS = 32, 64, 2, 2


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _write(d, config, weights, name="model.safetensors"):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    safetensors_numpy.save_file(
        {k: np.ascontiguousarray(
            v, v.dtype if np.issubdtype(v.dtype, np.integer) else np.float32)
         for k, v in weights.items()}, os.path.join(d, name))
    return str(d)


class _Draw:
    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)

    def w(self, *shape, scale=0.1):
        return (self.rs.randn(*shape) * scale).astype(np.float32)

    def ln(self, out, prefix, n=H):
        out[prefix + ".weight"] = 1 + self.w(n)
        out[prefix + ".bias"] = self.w(n)

    def lin(self, out, prefix, din, dout, bias=True):
        out[prefix + ".weight"] = self.w(dout, din)
        if bias:
            out[prefix + ".bias"] = self.w(dout)


def _hf_vit(seed):
    cfg = dict(model_type="vit", hidden_size=H, intermediate_size=FFN,
               num_hidden_layers=LAYERS, num_attention_heads=HEADS,
               image_size=16, patch_size=8, num_channels=3,
               layer_norm_eps=1e-12, hidden_act="gelu", qkv_bias=True,
               id2label={"0": "a", "1": "b", "2": "c"},
               torch_dtype="float32")
    r, w = _Draw(seed), {}
    w["vit.embeddings.cls_token"] = r.w(1, 1, H)
    w["vit.embeddings.position_embeddings"] = r.w(1, 5, H)
    w["vit.embeddings.patch_embeddings.projection.weight"] = r.w(H, 3, 8, 8)
    w["vit.embeddings.patch_embeddings.projection.bias"] = r.w(H)
    for i in range(LAYERS):
        p = f"vit.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            r.lin(w, p + "attention.attention." + n, H, H)
        r.lin(w, p + "attention.output.dense", H, H)
        r.lin(w, p + "intermediate.dense", H, FFN)
        r.lin(w, p + "output.dense", FFN, H)
        r.ln(w, p + "layernorm_before")
        r.ln(w, p + "layernorm_after")
    r.ln(w, "vit.layernorm")
    r.lin(w, "classifier", H, 3)
    return cfg, w


def _clip_tower(r, w, prefix, layers):
    for i in range(layers):
        p = f"{prefix}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r.lin(w, p + "self_attn." + n, H, H)
        r.lin(w, p + "mlp.fc1", H, FFN)
        r.lin(w, p + "mlp.fc2", FFN, H)
        r.ln(w, p + "layer_norm1")
        r.ln(w, p + "layer_norm2")


def _hf_clip(seed, eos):
    text = dict(vocab_size=64, hidden_size=H, intermediate_size=FFN,
                num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                max_position_embeddings=16, hidden_act="quick_gelu",
                layer_norm_eps=1e-5, eos_token_id=eos)
    vision = dict(hidden_size=H, intermediate_size=FFN,
                  num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                  image_size=16, patch_size=8, num_channels=3,
                  hidden_act="quick_gelu", layer_norm_eps=1e-5)
    cfg = dict(model_type="clip", text_config=text, vision_config=vision,
               projection_dim=24, torch_dtype="float32")
    r, w = _Draw(seed), {}
    w["logit_scale"] = np.array(2.0, np.float32)
    w["text_projection.weight"] = r.w(24, H)
    w["visual_projection.weight"] = r.w(24, H)
    w["text_model.embeddings.token_embedding.weight"] = r.w(64, H)
    w["text_model.embeddings.position_embedding.weight"] = r.w(16, H)
    _clip_tower(r, w, "text_model.", LAYERS)
    r.ln(w, "text_model.final_layer_norm")
    w["vision_model.embeddings.class_embedding"] = r.w(H)
    w["vision_model.embeddings.patch_embedding.weight"] = r.w(H, 3, 8, 8)
    w["vision_model.embeddings.position_embedding.weight"] = r.w(5, H)
    r.ln(w, "vision_model.pre_layrnorm")
    _clip_tower(r, w, "vision_model.", LAYERS)
    r.ln(w, "vision_model.post_layernorm")
    return cfg, w


def _hf_resnet(seed):
    emb, depths = 8, [1, 2, 1, 1]
    sizes = [emb * 2 ** i * 4 for i in range(4)]
    cfg = dict(model_type="resnet", embedding_size=emb, hidden_sizes=sizes,
               depths=depths, layer_type="bottleneck", num_channels=3,
               id2label={"0": "a", "1": "b"}, torch_dtype="float32",
               downsample_in_first_stage=False)
    r, w = _Draw(seed), {}

    def convbn(prefix, cin, cout, k):
        w[prefix + ".convolution.weight"] = r.w(cout, cin, k, k, scale=0.3)
        n = prefix + ".normalization."
        w[n + "weight"], w[n + "bias"] = 1 + r.w(cout), r.w(cout)
        w[n + "running_mean"] = r.w(cout)
        w[n + "running_var"] = r.rs.uniform(0.5, 1.5, cout).astype(
            np.float32)
        w[n + "num_batches_tracked"] = np.array(0, np.int64)
    convbn("resnet.embedder.embedder", 3, emb, 7)
    cin = emb
    for s, (n, out) in enumerate(zip(depths, sizes)):
        mid = out // 4
        for i in range(n):
            p = f"resnet.encoder.stages.{s}.layers.{i}"
            convbn(p + ".layer.0", cin, mid, 1)
            convbn(p + ".layer.1", mid, mid, 3)
            convbn(p + ".layer.2", mid, out, 1)
            if cin != out or (s > 0 and i == 0):
                convbn(p + ".shortcut", cin, out, 1)
            cin = out
    r.lin(w, "classifier.1", sizes[-1], 2)
    return cfg, w


def _perturbed(jm, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    sd = {k: np.asarray(np.asarray(v) + scale * rs.randn(*np.shape(v)),
                        np.float32) for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    return sd


VAE_KW = dict(base_channels=16, channel_multipliers=[1, 2],
              layers_per_block=1, norm_groups=4, latent_channels=4)


def _diffusers(kind, seed):
    """(config.json, diffusers-layout weights) of a seeded JAX model."""
    pt.seed(seed)
    if kind == "autoencoder_kl":
        cfg = jvae.VAEConfig(**VAE_KW)
        sd = _perturbed(jvae.AutoencoderKL(cfg), seed + 1)
        hf = dict(_class_name="AutoencoderKL", in_channels=3,
                  latent_channels=4, block_out_channels=[16, 32],
                  layers_per_block=1, norm_num_groups=4,
                  scaling_factor=0.13025)
        return hf, jax_hf._revert_vae(sd, cfg)
    if kind == "dit":
        cfg = jdit.dit_tiny()
        sd = _perturbed(jdit.DiT(cfg), seed + 1)
        sd["pos_embed"] = np.asarray(jdit.sincos_pos_embed_2d(4, 64))
        hf = dict(_class_name="DiTTransformer2DModel", sample_size=8,
                  patch_size=2, in_channels=4, out_channels=8,
                  num_attention_heads=4, attention_head_dim=16,
                  num_layers=2, num_embeds_ada_norm=10,
                  norm_type="ada_norm_zero")
        return hf, jax_hf._revert_dit(sd, cfg)
    cfg = jdit.mmdit_tiny()
    sd = _perturbed(jdit.MMDiT(cfg), seed + 1)
    hf = dict(_class_name="SD3Transformer2DModel", sample_size=8,
              patch_size=2, in_channels=4, num_attention_heads=4,
              attention_head_dim=16, num_layers=2, joint_attention_dim=48,
              pooled_projection_dim=32, caption_projection_dim=64)
    return hf, jax_hf._revert_sd3(sd, cfg)


def _same_config(tcfg, jcfg):
    """Field by field, the dtypes by name."""
    def norm(v):
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        if k_is_dtype(v):
            return np.dtype(v).name
        return v

    def k_is_dtype(v):
        try:
            return isinstance(v, type) and np.dtype(v) is not None
        except TypeError:
            return False
    assert norm(dataclasses.asdict(tcfg)) == norm(dataclasses.asdict(jcfg))


# computed from the config in each package, not loaded: fp32 sin and cos
# differ by an ulp between XLA and torch
COMPUTED = {"pos_embed": 1e-6}


def _load_both(d, computed=()):
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    tm.eval()
    jm.eval()
    jcls, jcfg, jmt = jax_hf.config_from_hf(d)
    tcls, tcfg, tmt = hf_interop.config_from_hf(d)
    assert (tcls.__name__, tmt) == (jcls.__name__, jmt)
    _same_config(tcfg, jcfg)
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tsd = {k: v.float().numpy() for k, v in jax_state_dict(tm).items()}
    assert set(tsd) == set(jsd)
    for k in jsd:
        if k in computed:
            np.testing.assert_allclose(tsd[k], jsd[k], atol=COMPUTED[k],
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(tsd[k], jsd[k], err_msg=k)
    return jm, tm


def _close(got, ref):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref),
                               atol=TOL_OUT, rtol=TOL_OUT)


def _images(b, h, seed):
    return np.random.RandomState(seed).randn(b, 3, h, h).astype(np.float32)


def _clip_ids(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 63, (2, 16)).astype(np.int32)
    ids[:, 9] = 63
    ids[0, 5] = ids[1, 12] = 7
    return ids


HF_CASES = ("vit", "clip-eos2", "clip-eos7", "resnet")


def _hf_case(case, seed):
    if case == "vit":
        return _hf_vit(seed)
    if case == "resnet":
        return _hf_resnet(seed)
    return _hf_clip(seed, eos=int(case[-1]))


@pytest.mark.parametrize("case", HF_CASES)
def test_hf_checkpoints_load_as_in_jax(tmp_path, case):
    """ViT (a classifier), CLIP (end-of-text by the highest id, or by its
    first occurrence), ResNet-50's layout (v1.5, BatchNorm statistics
    carried): configs, parameters and outputs as the JAX package's."""
    cfg, w = _hf_case(case, seed=1)
    d = _write(tmp_path / case, cfg, w)
    jm, tm = _load_both(d)
    if case.startswith("clip"):
        ids, px = _clip_ids(2), _images(2, 16, 3)
        jlogits = jm(jnp.asarray(ids), jnp.asarray(px))[0]
        with torch.no_grad():
            logits = tm(torch.from_numpy(ids).long(),
                        torch.from_numpy(px))[0]
    else:
        px = _images(2, 16 if case == "vit" else 64, 3)
        jlogits = jm(jnp.asarray(px))
        with torch.no_grad():
            logits = tm(torch.from_numpy(px))
    _close(logits, jlogits)


@pytest.mark.parametrize("case", HF_CASES)
def test_hf_checkpoints_match_transformers(tmp_path, case):
    transformers = pytest.importorskip("transformers")
    cfg, w = _hf_case(case, seed=4)
    d = _write(tmp_path / case, cfg, w)
    tm = hf_interop.from_pretrained(d, device="cpu").eval()
    cls = {"vit": transformers.ViTForImageClassification,
           "resnet": transformers.ResNetForImageClassification}.get(
               case, transformers.CLIPModel)
    ref, info = cls.from_pretrained(d, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    ref.eval()
    with torch.no_grad():
        if case.startswith("clip"):
            ids, px = _clip_ids(5), _images(2, 16, 6)
            want = ref(input_ids=torch.from_numpy(ids).long(),
                       pixel_values=torch.from_numpy(px)).logits_per_image
            got = tm(torch.from_numpy(ids).long(), torch.from_numpy(px))[0]
        else:
            px = torch.from_numpy(_images(2, 16 if case == "vit" else 64, 6))
            want, got = ref(pixel_values=px).logits, tm(px)
    torch.testing.assert_close(got, want, atol=TOL_OUT, rtol=TOL_OUT)


def test_bare_vit_leaves_the_head_at_init(tmp_path):
    """A bare ViTModel checkpoint has no classifier: ``head.*`` is an
    optional head (random init, a warning), strict or not."""
    cfg, w = _hf_vit(seed=7)
    w = {k: v for k, v in w.items() if not k.startswith("classifier")}
    d = _write(tmp_path / "bare", cfg, w)
    with pytest.warns(UserWarning, match="random init"):
        hf_interop.from_pretrained(d, device="cpu")


DIFFUSERS = ("autoencoder_kl", "dit", "sd3_transformer")


@pytest.mark.parametrize("kind", DIFFUSERS)
def test_diffusers_checkpoints_load_and_round_trip(tmp_path, kind):
    """A diffusers checkpoint (``diffusion_pytorch_model.safetensors``)
    loads as in JAX (config, parameters, outputs), and
    ``to_hf_state_dict`` writes it back bit for bit."""
    hf_cfg, w = _diffusers(kind, seed=8)
    d = _write(tmp_path / kind, hf_cfg, w,
               name="diffusion_pytorch_model.safetensors")
    jm, tm = _load_both(d, computed=("pos_embed",) if kind == "dit" else ())
    back = hf_interop.to_hf_state_dict(tm)
    assert set(back) == set(w)
    for k in w:
        np.testing.assert_array_equal(back[k], w[k], err_msg=k)
    rs = np.random.RandomState(9)
    with torch.no_grad():
        if kind == "autoencoder_kl":
            x = _images(2, 16, 10)
            _close(tm(torch.from_numpy(x))[0], jm(jnp.asarray(x))[0])
        elif kind == "dit":
            x = rs.randn(2, 4, 8, 8).astype(np.float32)
            t, y = np.array([3, 900]), np.array([1, 9])
            _close(tm(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y)),
                   jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
        else:
            x = rs.randn(2, 4, 8, 8).astype(np.float32)
            t = np.array([3, 900])
            ctx = rs.randn(2, 5, 48).astype(np.float32)
            pooled = rs.randn(2, 32).astype(np.float32)
            _close(tm(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx), torch.from_numpy(pooled)),
                   jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                      jnp.asarray(pooled)))


REFUSALS = (
    ("autoencoder_kl", dict(use_quant_conv=False), "quant convs"),
    ("autoencoder_kl", dict(shift_factor=0.0609), "shift_factor"),
    ("sd3_transformer", dict(qk_norm="rms_norm"), "qk_norm"),
    ("sd3_transformer", dict(dual_attention_layers=[0]),
     "dual_attention_layers"),
    ("dit", dict(norm_type="ada_norm_single"), "adaLN-Zero"),
)


@pytest.mark.parametrize("kind,extra,match", REFUSALS)
def test_unsupported_variants_are_refused_as_in_jax(tmp_path, kind, extra,
                                                    match):
    """SD3's and FLUX's VAE (no quant convs, a shift factor), SD3.5's
    transformer (qk norm, dual attention), a DiT without adaLN-Zero: the
    same ``ValueError`` in both packages."""
    hf_cfg, _ = _diffusers(kind, seed=11)
    d = tmp_path / "cfg"
    os.makedirs(d)
    with open(d / "config.json", "w") as f:
        json.dump(dict(hf_cfg, **extra), f)
    with pytest.raises(ValueError, match=match) as jerr:
        jax_hf.config_from_hf(str(d))
    with pytest.raises(ValueError, match=match) as terr:
        hf_interop.config_from_hf(str(d))
    assert str(terr.value) == str(jerr.value)


TOL_BF16 = 0      # loaded tensors: both packages round fp32 to bf16 (RNE)


@pytest.mark.parametrize("case", ("vit", "clip-eos2"))
def test_bf16_checkpoints_load_with_the_jax_dtypes(tmp_path, case):
    """A checkpoint whose config says bfloat16 loads every tensor in the
    JAX loader's dtype, key by key: the JAX ``_place`` casts each
    floating tensor of the checkpoint to the config's dtype, so the heads
    the constructor keeps fp32 (ViT's classifier, CLIP's projections and
    logit scale) load bf16. Then the values, within ``TOL_BF16``."""
    cfg, w = _hf_case(case, seed=8)
    cfg = dict(cfg, torch_dtype="bfloat16")
    d = _write(tmp_path / case, cfg, w)
    jm = jax_hf.from_pretrained(d)
    tm = hf_interop.from_pretrained(d, device="cpu")
    jsd = dict(jm.state_dict())
    tsd = jax_state_dict(tm)
    assert set(tsd) == set(jsd)
    got = {k: str(v.dtype).replace("torch.", "") for k, v in tsd.items()}
    want = {k: str(jnp.asarray(v).dtype) for k, v in jsd.items()}
    assert got == want
    assert want[("head.weight" if case == "vit" else "text_projection")] \
        == "bfloat16"
    for k in jsd:
        ref = np.asarray(jnp.asarray(jsd[k], jnp.float32))
        tol = COMPUTED.get(k, TOL_BF16)
        np.testing.assert_allclose(tsd[k].float().numpy(), ref, atol=tol,
                                   rtol=0, err_msg=k)
