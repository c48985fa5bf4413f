"""HF and diffusers checkpoints of the vision and diffusion families
(counterpart of ``paddle_tpu/models/hf_interop.py``'s ``_convert_vit``,
``_convert_clip_tower``, ``_convert_clip``, ``_vae_name_map``,
``_vae_attn``, ``_convert_vae``, ``_revert_vae``, ``_fuse_qkv_named``,
``_split_qkv``, ``_lin``, ``_lin_rev``, ``_convert_dit``, ``_revert_dit``,
``_swap_halves``, ``_convert_sd3``, ``_revert_sd3``, ``_convert_resnet``,
and ``config_from_hf``'s ``vit``, ``resnet``, ``clip`` and diffusers
``_class_name`` branches).

The converters work on numpy arrays and give the JAX package's layout, as
``hf_interop``'s do: every linear weight [in, out] (HF's transposed
once), q, k and v fused into one [in, 3 out] ``qkv``, conv weights OIHW
as both packages keep them, BatchNorm's running statistics as
``_mean`` / ``_variance``. ``hf_interop.from_pretrained`` then copies
them into the port's modules as ``load_jax_state_dict`` does. The
reverts (``to_hf_state_dict``) write the diffusers layout back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .hf_interop import _fuse_qkv


# ----------------------------------------------------------------- ViT/CLIP
def _convert_vit(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """HF ViTModel / ViTForImageClassification -> the port's
    ``ViTForImageClassification``: the separate q/k/v fuse; the patch
    conv stays OIHW."""
    src = {k[4:] if k.startswith("vit.") else k: v for k, v in hf.items()}
    out = {"vit.cls_token": src["embeddings.cls_token"],
           "vit.pos_embed": src["embeddings.position_embeddings"],
           "vit.patch_embed.proj.weight":
               src["embeddings.patch_embeddings.projection.weight"],
           "vit.patch_embed.proj.bias":
               src["embeddings.patch_embeddings.projection.bias"]}
    for i in range(cfg.num_hidden_layers):
        p, o = f"encoder.layer.{i}.", f"vit.blocks.{i}."
        at = p + "attention.attention."
        out[o + "attn.qkv.weight"], out[o + "attn.qkv.bias"] = _fuse_qkv(
            src, at + "query", at + "key", at + "value")
        out[o + "attn.proj.weight"] = \
            src[p + "attention.output.dense.weight"].T
        out[o + "attn.proj.bias"] = src[p + "attention.output.dense.bias"]
        out[o + "fc1.weight"] = src[p + "intermediate.dense.weight"].T
        out[o + "fc1.bias"] = src[p + "intermediate.dense.bias"]
        out[o + "fc2.weight"] = src[p + "output.dense.weight"].T
        out[o + "fc2.bias"] = src[p + "output.dense.bias"]
        for hf_ln, ours in (("layernorm_before", "norm1"),
                            ("layernorm_after", "norm2")):
            out[o + ours + ".weight"] = src[p + hf_ln + ".weight"]
            out[o + ours + ".bias"] = src[p + hf_ln + ".bias"]
    out["vit.norm.weight"] = src["layernorm.weight"]
    out["vit.norm.bias"] = src["layernorm.bias"]
    if "classifier.weight" in src:
        out["head.weight"] = src["classifier.weight"].T
        out["head.bias"] = src["classifier.bias"]
    return out


def _convert_clip_tower(src, hp: str, op: str, n_layers: int, out) -> None:
    """One CLIP tower's blocks (the text and vision towers share HF's
    ``encoder.layers`` layout)."""
    for i in range(n_layers):
        p, o = f"{hp}encoder.layers.{i}.", f"{op}{i}."
        at = p + "self_attn."
        out[o + "qkv.weight"], out[o + "qkv.bias"] = _fuse_qkv(
            src, at + "q_proj", at + "k_proj", at + "v_proj")
        out[o + "proj.weight"] = src[at + "out_proj.weight"].T
        out[o + "proj.bias"] = src[at + "out_proj.bias"]
        out[o + "fc1.weight"] = src[p + "mlp.fc1.weight"].T
        out[o + "fc1.bias"] = src[p + "mlp.fc1.bias"]
        out[o + "fc2.weight"] = src[p + "mlp.fc2.weight"].T
        out[o + "fc2.bias"] = src[p + "mlp.fc2.bias"]
        for hf_ln, ours in (("layer_norm1", "norm1"),
                            ("layer_norm2", "norm2")):
            out[o + ours + ".weight"] = src[p + hf_ln + ".weight"]
            out[o + ours + ".bias"] = src[p + hf_ln + ".bias"]


def _convert_clip(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """HF CLIPModel -> ``CLIPModel``: both towers' q/k/v fuse; the class
    embedding becomes the [1, 1, h] ``cls_token``; HF's bias-free patch
    conv gets a zero bias; the vision blocks nest their attention under
    ``attn``."""
    src = dict(hf)
    out = {"logit_scale": np.asarray(src["logit_scale"]).reshape(()),
           "text_projection": src["text_projection.weight"].T,
           "visual_projection": src["visual_projection.weight"].T}
    tp = "text_model."
    out["text_model.token_embedding.weight"] = \
        src[tp + "embeddings.token_embedding.weight"]
    out["text_model.position_embedding"] = \
        src[tp + "embeddings.position_embedding.weight"]
    _convert_clip_tower(src, tp, "text_model.blocks.",
                        cfg.text.num_hidden_layers, out)
    out["text_model.final_norm.weight"] = src[tp + "final_layer_norm.weight"]
    out["text_model.final_norm.bias"] = src[tp + "final_layer_norm.bias"]
    vp = "vision_model."
    h = cfg.vision.hidden_size
    out["vision_model.cls_token"] = \
        np.asarray(src[vp + "embeddings.class_embedding"]).reshape(1, 1, h)
    out["vision_model.pos_embed"] = \
        np.asarray(src[vp + "embeddings.position_embedding.weight"])[None]
    out["vision_model.patch_embed.proj.weight"] = \
        src[vp + "embeddings.patch_embedding.weight"]
    out["vision_model.patch_embed.proj.bias"] = np.zeros((h,), np.float32)
    out["vision_model.pre_norm.weight"] = src[vp + "pre_layrnorm.weight"]
    out["vision_model.pre_norm.bias"] = src[vp + "pre_layrnorm.bias"]
    vtmp: Dict[str, Any] = {}
    _convert_clip_tower(src, vp, "vision_model.blocks.",
                        cfg.vision.num_hidden_layers, vtmp)
    for k, v in vtmp.items():
        out[k.replace(".qkv.", ".attn.qkv.").replace(".proj.",
                                                     ".attn.proj.")] = v
    out["vision_model.norm.weight"] = src[vp + "post_layernorm.weight"]
    out["vision_model.norm.bias"] = src[vp + "post_layernorm.bias"]
    return out


# ------------------------------------------------------ diffusers VAE
def _vae_name_map(cfg):
    """(diffusers prefix, port prefix) pairs, by replaying the Encoder's
    and Decoder's construction loops: diffusers nests resnets and
    samplers by block, the port indexes one flat ``Sequential``."""
    pairs = []
    n_blocks = len(cfg.channel_multipliers)

    def resnet(dst, src_p, in_ch, out_ch):
        for a in ("norm1", "conv1", "norm2", "conv2"):
            pairs.append((f"{src_p}.{a}", f"{dst}.{a}"))
        if in_ch != out_ch:
            pairs.append((f"{src_p}.conv_shortcut", f"{dst}.short"))

    ch = cfg.base_channels
    k, in_ch = 0, ch
    for b, mult in enumerate(cfg.channel_multipliers):
        out_ch = ch * mult
        for r in range(cfg.layers_per_block):
            resnet(f"encoder.down.{k}",
                   f"encoder.down_blocks.{b}.resnets.{r}", in_ch, out_ch)
            in_ch = out_ch
            k += 1
        if b != n_blocks - 1:
            pairs.append((f"encoder.down_blocks.{b}.downsamplers.0.conv",
                          f"encoder.down.{k}.conv"))
            k += 1
    resnet("encoder.mid.0", "encoder.mid_block.resnets.0", in_ch, in_ch)
    pairs.append(("encoder.mid_block.attentions.0", "encoder.mid.1"))
    resnet("encoder.mid.2", "encoder.mid_block.resnets.1", in_ch, in_ch)
    pairs.append(("encoder.conv_norm_out", "encoder.norm_out"))
    for n in ("encoder.conv_in", "encoder.conv_out", "quant_conv",
              "post_quant_conv", "decoder.conv_in", "decoder.conv_out"):
        pairs.append((n, n))
    in_ch = ch * cfg.channel_multipliers[-1]
    resnet("decoder.mid.0", "decoder.mid_block.resnets.0", in_ch, in_ch)
    pairs.append(("decoder.mid_block.attentions.0", "decoder.mid.1"))
    resnet("decoder.mid.2", "decoder.mid_block.resnets.1", in_ch, in_ch)
    k = 0
    for b, mult in enumerate(reversed(cfg.channel_multipliers)):
        out_ch = ch * mult
        for r in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up.{k}", f"decoder.up_blocks.{b}.resnets.{r}",
                   in_ch, out_ch)
            in_ch = out_ch
            k += 1
        if b != n_blocks - 1:
            pairs.append((f"decoder.up_blocks.{b}.upsamplers.0.conv",
                          f"decoder.up.{k}.conv"))
            k += 1
    pairs.append(("decoder.conv_norm_out", "decoder.norm_out"))
    return pairs


def _vae_attn(hf, src_p, dst_p, out) -> None:
    """Diffusers' spatial attention (a group norm, to_q/k/v, to_out.0; the
    old CompVis exports' 1x1-conv weights squeezed) -> ``AttnBlock``."""
    def lin(name):
        w = np.asarray(hf[f"{src_p}.{name}.weight"])
        if w.ndim == 4:
            w = w[..., 0, 0]
        return w.T, np.asarray(hf[f"{src_p}.{name}.bias"])
    gname = "group_norm" if f"{src_p}.group_norm.weight" in hf else "norm"
    out[f"{dst_p}.norm.weight"] = hf[f"{src_p}.{gname}.weight"]
    out[f"{dst_p}.norm.bias"] = hf[f"{src_p}.{gname}.bias"]
    ws, bs = zip(lin("to_q"), lin("to_k"), lin("to_v"))
    out[f"{dst_p}.qkv.weight"] = np.concatenate(ws, axis=1)
    out[f"{dst_p}.qkv.bias"] = np.concatenate(bs)
    out[f"{dst_p}.proj.weight"], out[f"{dst_p}.proj.bias"] = lin("to_out.0")


def _convert_vae(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """A diffusers AutoencoderKL -> ``AutoencoderKL``."""
    out: Dict[str, Any] = {}
    for src_p, dst_p in _vae_name_map(cfg):
        if src_p.endswith("attentions.0"):
            _vae_attn(hf, src_p, dst_p, out)
            continue
        for suf in ("weight", "bias"):
            out[f"{dst_p}.{suf}"] = hf[f"{src_p}.{suf}"]
    return out


def _revert_vae(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """The inverse of ``_convert_vae``."""
    out: Dict[str, Any] = {}
    for src_p, dst_p in _vae_name_map(cfg):
        if src_p.endswith("attentions.0"):
            qkv = np.asarray(sd[f"{dst_p}.qkv.weight"])
            qb = np.asarray(sd[f"{dst_p}.qkv.bias"])
            c = qkv.shape[0]
            for i, n in enumerate(("to_q", "to_k", "to_v")):
                out[f"{src_p}.{n}.weight"] = qkv[:, i * c:(i + 1) * c].T
                out[f"{src_p}.{n}.bias"] = qb[i * c:(i + 1) * c]
            out[f"{src_p}.group_norm.weight"] = sd[f"{dst_p}.norm.weight"]
            out[f"{src_p}.group_norm.bias"] = sd[f"{dst_p}.norm.bias"]
            out[f"{src_p}.to_out.0.weight"] = \
                np.asarray(sd[f"{dst_p}.proj.weight"]).T
            out[f"{src_p}.to_out.0.bias"] = sd[f"{dst_p}.proj.bias"]
            continue
        for suf in ("weight", "bias"):
            out[f"{src_p}.{suf}"] = np.asarray(sd[f"{dst_p}.{suf}"])
    return out


# --------------------------------------------- diffusers DiT / SD3 models
def _fuse_qkv_named(hf, src_p, names, dst_p, out) -> None:
    out[f"{dst_p}.weight"], out[f"{dst_p}.bias"] = _fuse_qkv(
        hf, *(f"{src_p}.{n}" for n in names))


def _split_qkv(sd, dst_p, src_p, names, out) -> None:
    w = np.asarray(sd[f"{dst_p}.weight"])
    b = np.asarray(sd[f"{dst_p}.bias"])
    h = w.shape[0]
    for i, n in enumerate(names):
        out[f"{src_p}.{n}.weight"] = w[:, i * h:(i + 1) * h].T
        out[f"{src_p}.{n}.bias"] = b[i * h:(i + 1) * h]


def _lin(hf, src, dst, out) -> None:
    out[f"{dst}.weight"] = np.asarray(hf[f"{src}.weight"]).T
    out[f"{dst}.bias"] = np.asarray(hf[f"{src}.bias"])


def _lin_rev(sd, dst, src, out) -> None:
    out[f"{src}.weight"] = np.asarray(sd[f"{dst}.weight"]).T
    out[f"{src}.bias"] = np.asarray(sd[f"{dst}.bias"])


def _convert_dit(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """A diffusers DiTTransformer2DModel -> ``DiT``. Diffusers repeats the
    timestep and class embedders in every block's AdaLayerNormZero (the
    same weights); block 0's copy fills the shared embedders. Its sin-cos
    table is a non-persistent buffer there: ``pos_embed`` is computed
    from the config."""
    from .dit import sincos_pos_embed_2d
    out: Dict[str, Any] = {"patch_embed.weight": hf["pos_embed.proj.weight"],
                           "patch_embed.bias": hf["pos_embed.proj.bias"]}
    emb = "transformer_blocks.0.norm1.emb"
    _lin(hf, f"{emb}.timestep_embedder.linear_1", "t_embedder.fc1", out)
    _lin(hf, f"{emb}.timestep_embedder.linear_2", "t_embedder.fc2", out)
    out["y_embedder.table.weight"] = \
        hf[f"{emb}.class_embedder.embedding_table.weight"]
    for i in range(cfg.num_hidden_layers):
        s, d = f"transformer_blocks.{i}", f"blocks.{i}"
        _lin(hf, f"{s}.norm1.linear", f"{d}.ada", out)
        _fuse_qkv_named(hf, f"{s}.attn1", ("to_q", "to_k", "to_v"),
                        f"{d}.qkv", out)
        _lin(hf, f"{s}.attn1.to_out.0", f"{d}.proj", out)
        _lin(hf, f"{s}.ff.net.0.proj", f"{d}.fc1", out)
        _lin(hf, f"{s}.ff.net.2", f"{d}.fc2", out)
    _lin(hf, "proj_out_1", "final_ada", out)
    _lin(hf, "proj_out_2", "final_proj", out)
    out["pos_embed"] = sincos_pos_embed_2d(
        cfg.input_size // cfg.patch_size, cfg.hidden_size).numpy()
    return out


def _revert_dit(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """The inverse of ``_convert_dit``: the shared embedders written into
    every block; ``pos_embed`` dropped (a buffer in diffusers)."""
    out: Dict[str, Any] = {
        "pos_embed.proj.weight": np.asarray(sd["patch_embed.weight"]),
        "pos_embed.proj.bias": np.asarray(sd["patch_embed.bias"])}
    for i in range(cfg.num_hidden_layers):
        s, d = f"transformer_blocks.{i}", f"blocks.{i}"
        emb = f"{s}.norm1.emb"
        _lin_rev(sd, "t_embedder.fc1", f"{emb}.timestep_embedder.linear_1",
                 out)
        _lin_rev(sd, "t_embedder.fc2", f"{emb}.timestep_embedder.linear_2",
                 out)
        out[f"{emb}.class_embedder.embedding_table.weight"] = \
            np.asarray(sd["y_embedder.table.weight"])
        _lin_rev(sd, f"{d}.ada", f"{s}.norm1.linear", out)
        _split_qkv(sd, f"{d}.qkv", f"{s}.attn1", ("to_q", "to_k", "to_v"),
                   out)
        _lin_rev(sd, f"{d}.proj", f"{s}.attn1.to_out.0", out)
        _lin_rev(sd, f"{d}.fc1", f"{s}.ff.net.0.proj", out)
        _lin_rev(sd, f"{d}.fc2", f"{s}.ff.net.2", out)
    _lin_rev(sd, "final_ada", "proj_out_1", out)
    _lin_rev(sd, "final_proj", "proj_out_2", out)
    return out


def _swap_halves(w_t: np.ndarray, b: np.ndarray):
    """AdaLayerNormContinuous emits (scale, shift), the port's modulation
    splits (shift, scale): swap the output halves of an [in, out] weight
    and its bias."""
    h = w_t.shape[1] // 2
    return (np.concatenate([w_t[:, h:], w_t[:, :h]], axis=1),
            np.concatenate([b[h:], b[:h]]))


def _convert_sd3(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """A diffusers SD3Transformer2DModel -> ``MMDiT``. ``attn.to_*`` and
    ``ff`` are the image stream, ``attn.add_*_proj``, ``to_add_out`` and
    ``ff_context`` the text stream (the joint attention's key order
    differs, which the attention does not see). The final norm and the
    last block's context norm are AdaLayerNormContinuous (scale first):
    their halves swap. The persistent max-size ``pos_embed`` table is
    center-cropped to the model's grid, as the diffusers forward crops it
    each call."""
    out: Dict[str, Any] = {"patch_embed.weight": hf["pos_embed.proj.weight"],
                           "patch_embed.bias": hf["pos_embed.proj.bias"]}
    table = np.asarray(hf["pos_embed.pos_embed"])
    max_g = int(round(table.shape[1] ** 0.5))
    grid = cfg.input_size // cfg.patch_size
    if max_g < grid:
        raise ValueError(f"checkpoint pos_embed grid {max_g} smaller "
                         f"than model grid {grid}")
    top = (max_g - grid) // 2
    out["pos_embed"] = table.reshape(1, max_g, max_g, -1)[
        :, top:top + grid, top:top + grid].reshape(1, grid * grid, -1)
    _lin(hf, "time_text_embed.timestep_embedder.linear_1", "t_embedder.fc1",
         out)
    _lin(hf, "time_text_embed.timestep_embedder.linear_2", "t_embedder.fc2",
         out)
    _lin(hf, "time_text_embed.text_embedder.linear_1", "pooled_proj.0", out)
    _lin(hf, "time_text_embed.text_embedder.linear_2", "pooled_proj.2", out)
    _lin(hf, "context_embedder", "context_proj", out)
    last = cfg.num_hidden_layers - 1
    for i in range(cfg.num_hidden_layers):
        s, d = f"transformer_blocks.{i}", f"blocks.{i}"
        _lin(hf, f"{s}.norm1.linear", f"{d}.img.ada", out)
        _fuse_qkv_named(hf, f"{s}.attn", ("to_q", "to_k", "to_v"),
                        f"{d}.img.qkv", out)
        _lin(hf, f"{s}.attn.to_out.0", f"{d}.img.proj", out)
        _lin(hf, f"{s}.ff.net.0.proj", f"{d}.img.fc1", out)
        _lin(hf, f"{s}.ff.net.2", f"{d}.img.fc2", out)
        _lin(hf, f"{s}.norm1_context.linear", f"{d}.txt.ada", out)
        if i == last:
            out[f"{d}.txt.ada.weight"], out[f"{d}.txt.ada.bias"] = \
                _swap_halves(out[f"{d}.txt.ada.weight"],
                             out[f"{d}.txt.ada.bias"])
        _fuse_qkv_named(hf, f"{s}.attn",
                        ("add_q_proj", "add_k_proj", "add_v_proj"),
                        f"{d}.txt.qkv", out)
        if i != last:
            _lin(hf, f"{s}.attn.to_add_out", f"{d}.txt.proj", out)
            _lin(hf, f"{s}.ff_context.net.0.proj", f"{d}.txt.fc1", out)
            _lin(hf, f"{s}.ff_context.net.2", f"{d}.txt.fc2", out)
    _lin(hf, "norm_out.linear", "final_ada", out)
    out["final_ada.weight"], out["final_ada.bias"] = \
        _swap_halves(out["final_ada.weight"], out["final_ada.bias"])
    _lin(hf, "proj_out", "final_proj", out)
    return out


def _revert_sd3(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """The inverse of ``_convert_sd3``; the exported ``pos_embed`` table's
    size is the model's grid."""
    out: Dict[str, Any] = {
        "pos_embed.proj.weight": np.asarray(sd["patch_embed.weight"]),
        "pos_embed.proj.bias": np.asarray(sd["patch_embed.bias"]),
        "pos_embed.pos_embed": np.asarray(sd["pos_embed"])}
    _lin_rev(sd, "t_embedder.fc1",
             "time_text_embed.timestep_embedder.linear_1", out)
    _lin_rev(sd, "t_embedder.fc2",
             "time_text_embed.timestep_embedder.linear_2", out)
    _lin_rev(sd, "pooled_proj.0", "time_text_embed.text_embedder.linear_1",
             out)
    _lin_rev(sd, "pooled_proj.2", "time_text_embed.text_embedder.linear_2",
             out)
    _lin_rev(sd, "context_proj", "context_embedder", out)
    last = cfg.num_hidden_layers - 1
    for i in range(cfg.num_hidden_layers):
        s, d = f"transformer_blocks.{i}", f"blocks.{i}"
        _lin_rev(sd, f"{d}.img.ada", f"{s}.norm1.linear", out)
        _split_qkv(sd, f"{d}.img.qkv", f"{s}.attn", ("to_q", "to_k", "to_v"),
                   out)
        _lin_rev(sd, f"{d}.img.proj", f"{s}.attn.to_out.0", out)
        _lin_rev(sd, f"{d}.img.fc1", f"{s}.ff.net.0.proj", out)
        _lin_rev(sd, f"{d}.img.fc2", f"{s}.ff.net.2", out)
        tw = np.asarray(sd[f"{d}.txt.ada.weight"])
        tb = np.asarray(sd[f"{d}.txt.ada.bias"])
        if i == last:
            tw, tb = _swap_halves(tw, tb)
        out[f"{s}.norm1_context.linear.weight"] = tw.T
        out[f"{s}.norm1_context.linear.bias"] = tb
        _split_qkv(sd, f"{d}.txt.qkv", f"{s}.attn",
                   ("add_q_proj", "add_k_proj", "add_v_proj"), out)
        if i != last:
            _lin_rev(sd, f"{d}.txt.proj", f"{s}.attn.to_add_out", out)
            _lin_rev(sd, f"{d}.txt.fc1", f"{s}.ff_context.net.0.proj", out)
            _lin_rev(sd, f"{d}.txt.fc2", f"{s}.ff_context.net.2", out)
    w, b = _swap_halves(np.asarray(sd["final_ada.weight"]),
                        np.asarray(sd["final_ada.bias"]))
    out["norm_out.linear.weight"] = w.T
    out["norm_out.linear.bias"] = b
    _lin_rev(sd, "final_proj", "proj_out", out)
    return out


# ------------------------------------------------------------------ ResNet
def _convert_resnet(hf: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """HF ResNetForImageClassification / ResNetModel (v1.5: the stride on
    the middle 3x3, the first stage unstrided: the port's "b" variant)
    -> ``ResNet``."""
    p = "resnet." if any(k.startswith("resnet.") for k in hf) else ""
    out: Dict[str, Any] = {}

    def convbn(src, dst):
        out[dst + ".conv.weight"] = hf[src + ".convolution.weight"]
        for a, b in (("weight", "weight"), ("bias", "bias"),
                     ("running_mean", "_mean"),
                     ("running_var", "_variance")):
            out[f"{dst}.bn.{b}"] = hf[f"{src}.normalization.{a}"]

    convbn(p + "embedder.embedder", "stem")
    blocks, block_cls = cfg.block_plan()
    names = ("conv0", "conv1", "conv2")[:3 if block_cls.expansion == 4
                                        else 2]
    for s, nb in enumerate(blocks):
        for i in range(nb):
            base = f"{p}encoder.stages.{s}.layers.{i}"
            for j, nm in enumerate(names):
                convbn(f"{base}.layer.{j}", f"stages.{s}.{i}.{nm}")
            if f"{base}.shortcut.convolution.weight" in hf:
                convbn(f"{base}.shortcut", f"stages.{s}.{i}.short")
    if "classifier.1.weight" in hf:
        out["head.weight"] = hf["classifier.1.weight"].T
        out["head.bias"] = hf["classifier.1.bias"]
    return out


CONVERTERS = {"vit": _convert_vit, "clip": _convert_clip,
              "autoencoder_kl": _convert_vae, "dit": _convert_dit,
              "sd3_transformer": _convert_sd3, "resnet": _convert_resnet}


def revert(model, sd: Dict[str, np.ndarray]):
    """The diffusers state dict of an ``AutoencoderKL``, ``DiT`` or
    ``MMDiT`` (``to_hf_state_dict``), or None for another model."""
    from .dit import DiT, MMDiT
    from .vae import AutoencoderKL
    for cls, fn in ((AutoencoderKL, _revert_vae), (DiT, _revert_dit),
                    (MMDiT, _revert_sd3)):
        if isinstance(model, cls):
            return fn(sd, model.config)
    return None


# ------------------------------------------------------------ config.json
def diffusers_config(hf: Dict[str, Any]):
    """``config_from_hf`` for a diffusers ``config.json`` (no
    ``model_type``; ``_class_name`` names the model), with the JAX
    package's refusals; None when it names none of these models."""
    name = hf.get("_class_name")
    if name == "AutoencoderKL":
        from .vae import AutoencoderKL, VAEConfig
        if hf.get("use_quant_conv") is False or \
                hf.get("use_post_quant_conv") is False or \
                hf.get("shift_factor"):
            raise ValueError(
                "AutoencoderKL variant without quant convs / with "
                "shift_factor (SD3/FLUX VAE) is not supported yet; "
                "the SD1/2-family layout is")
        bout = hf.get("block_out_channels", [128, 256, 512, 512])
        cfg = VAEConfig(
            in_channels=hf.get("in_channels", 3),
            latent_channels=hf.get("latent_channels", 4),
            base_channels=bout[0],
            channel_multipliers=[c // bout[0] for c in bout],
            layers_per_block=hf.get("layers_per_block", 2),
            norm_groups=hf.get("norm_num_groups", 32),
            scaling_factor=hf.get("scaling_factor", 0.18215))
        return AutoencoderKL, cfg, "autoencoder_kl"
    if name in ("DiTTransformer2DModel", "Transformer2DModel"):
        from .dit import DiT, DiTConfig
        if hf.get("norm_type", "ada_norm_zero") != "ada_norm_zero":
            raise ValueError("only adaLN-Zero DiT transformers are "
                             "supported")
        nheads = hf.get("num_attention_heads", 16)
        in_c = hf.get("in_channels", 4)
        # diffusers writes out_channels null for "= in_channels"
        out_c = hf.get("out_channels")
        if out_c is None:
            out_c = in_c
        cfg = DiTConfig(
            input_size=hf.get("sample_size", 32),
            patch_size=hf.get("patch_size", 2),
            in_channels=in_c,
            hidden_size=nheads * hf.get("attention_head_dim", 72),
            num_hidden_layers=hf.get("num_layers", 28),
            num_attention_heads=nheads,
            num_classes=hf.get("num_embeds_ada_norm", 1000),
            learn_sigma=out_c == 2 * in_c)
        return DiT, cfg, "dit"
    if name == "SD3Transformer2DModel":
        from .dit import MMDiT, MMDiTConfig
        if hf.get("qk_norm"):
            raise ValueError("SD3.5-style qk_norm is not supported "
                             "(our MMDiT matches the SD3-medium layout)")
        if hf.get("dual_attention_layers"):
            raise ValueError("dual_attention_layers (SD3.5-medium) not "
                             "supported")
        nheads = hf["num_attention_heads"]
        h = nheads * hf.get("attention_head_dim", 64)
        if hf.get("caption_projection_dim", h) != h:
            raise ValueError("caption_projection_dim != hidden size")
        cfg = MMDiTConfig(
            input_size=hf.get("sample_size", 128),
            patch_size=hf.get("patch_size", 2),
            in_channels=hf.get("in_channels", 16),
            hidden_size=h,
            num_hidden_layers=hf["num_layers"],
            num_attention_heads=nheads,
            context_dim=hf.get("joint_attention_dim", 4096),
            pooled_dim=hf.get("pooled_projection_dim", 2048))
        return MMDiT, cfg, "sd3_transformer"
    return None


def vision_config(hf: Dict[str, Any], mt: str, dtype):
    """``config_from_hf``'s ``vit``, ``resnet`` and ``clip`` branches, the
    model in ``dtype``."""
    if mt == "vit":
        from .vit import ViTConfig, ViTForImageClassification
        cfg = ViTConfig(
            image_size=hf.get("image_size", 224),
            patch_size=hf.get("patch_size", 16),
            in_channels=hf.get("num_channels", 3),
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_classes=len(hf.get("id2label") or {}) or 2,
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            dtype=dtype)
        return ViTForImageClassification, cfg, mt
    if mt == "resnet":
        from .resnet import ResNet, ResNetConfig
        depths = hf.get("depths", [3, 4, 6, 3])
        bottleneck = hf.get("layer_type", "bottleneck") == "bottleneck"
        exp = 4 if bottleneck else 1
        w = hf.get("embedding_size", 64)
        want = [w * (2 ** i) * exp for i in range(len(depths))]
        if hf.get("hidden_sizes", want) != want:
            raise ValueError(
                f"non-standard ResNet hidden_sizes {hf.get('hidden_sizes')}"
                f" (expected {want}); custom widths are not supported")
        if hf.get("downsample_in_first_stage") or \
                hf.get("downsample_in_bottleneck"):
            raise ValueError("ResNet v1 downsample placement differs from "
                             "our v1.5 ('b') layout")
        cfg = ResNetConfig(
            depth=50 if bottleneck else 18,   # selects the block class
            layers=list(depths),
            num_classes=len(hf.get("id2label") or {}) or 2,
            in_channels=hf.get("num_channels", 3),
            stem_width=w,
            dtype=dtype)
        return ResNet, cfg, mt
    from .clip import CLIPConfig, CLIPModel, CLIPTextConfig
    from .vit import ViTConfig
    t, v = hf["text_config"], hf["vision_config"]
    cfg = CLIPConfig(
        text=CLIPTextConfig(
            vocab_size=t["vocab_size"],
            max_position_embeddings=t.get("max_position_embeddings", 77),
            hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_hidden_layers=t["num_hidden_layers"],
            num_attention_heads=t["num_attention_heads"],
            layer_norm_eps=t.get("layer_norm_eps", 1e-5),
            eos_token_id=t.get("eos_token_id"),
            hidden_act=t.get("hidden_act", "quick_gelu"),
            dtype=dtype),
        vision=ViTConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 32),
            in_channels=v.get("num_channels", 3),
            hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"],
            num_hidden_layers=v["num_hidden_layers"],
            num_attention_heads=v["num_attention_heads"],
            num_classes=0,
            layer_norm_eps=v.get("layer_norm_eps", 1e-5),
            pre_norm=True,             # HF CLIP's pre_layrnorm
            hidden_act=v.get("hidden_act", "quick_gelu"),
            dtype=dtype),
        projection_dim=hf.get("projection_dim", 512),
        dtype=dtype)
    return CLIPModel, cfg, mt
