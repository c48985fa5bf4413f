"""The fused-qkv families on a tp mesh, against the JAX package on a CPU
mesh of the same shape.

GPT, BERT, ERNIE, ViT, CLIP and DiT shard one fused, biased qkv
projection whose output the JAX package reshapes to [.., 3, heads, d]
under GSPMD. A port rank holds its own heads' q, k and v columns with
their biases (``ColumnParallelLinear(fused_parts=3)``: a strided shard of
the JAX layout), its projection and MLP are the Megatron pair, GPT's and
BERT's word tables are vocab-split and their tied heads go through
``parallel_matmul``. MMDiT's stream projections stay replicated, as in
the JAX package.

In one gloo world of 2 ranks ({"tp": 2}) and one of 4 ({"dp": 2, "tp":
2}), started while the JAX references run on ``jax.devices()[:n]``, on the
same seeded, perturbed weights, fp32:

- GPT built in ``sharded_build`` and loaded a rank's slices at a time: its
  local qkv rows are [q_r; k_r; v_r], its ``state_dict`` is the JAX
  layout; logits (both meshes), greedy and beam ``generate()``, the
  weight-only ``Predictor`` at int8 and int4 (tokens and logits);
- ``Trainer`` 3 SGD steps, the losses and every parameter: GPT (default
  loss) and BERT's classifier on both meshes; BERT's pretraining heads,
  ERNIE's MLM and classifier, ViT and CLIP (contrastive loss) at tp 2;
- ViT's and CLIP's eval outputs, a DiT and an MMDiT denoising step, a
  4-step ``DiTPipeline`` sample from the same seeded latents;
- dropout at tp 2: after a train-mode BERT forward the hidden states are
  equal on both ranks, while a dropout over each rank's attention
  probabilities draws its own mask, each keep rate within 3 sigma of
  1 - p.

Every parity case runs with dropout at 0: threefry's and torch's streams
cannot match. Tolerances: ``ATOL`` for outputs, ``RTOL_LOSS`` /
``ATOL_PARAMS`` for the Trainer (the zoo tests'), ``ATOL_LOOP`` for the
pipeline's latents after 4 steps (the diffusion tests')."""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import models as JM
from paddle_tpu.diffusion import pipelines as jpipes
from paddle_tpu.diffusion import schedulers as jsched
from paddle_tpu.distributed import env as jenv
from paddle_tpu.models.bert import pretraining_loss as jax_pretraining_loss
from paddle_tpu.models.clip import clip_contrastive_loss as jax_clip_loss
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.sharding import shard_layer as jax_shard_layer
from paddle_tpu.quant import quantize_model as jax_quantize_model
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.trainer import TrainingArguments as JaxArgs
from torch_dist_workers import _zoo_model, start_world

ATOL = 1e-4
ATOL_LOOP = 2e-4
RTOL_LOSS = 1e-4
ATOL_PARAMS = 1e-5
# dropout's keep rate over this many draws, within 3 sigma of 1 - p
DROP_P = 0.1

GPT = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
           vocab_size=512, max_position_embeddings=256)
ENC = dict(hidden_dropout_prob=0.0)
FAMILIES = {
    # name: (JAX class, JAX config, overrides, SGD rate)
    "gpt": (JM.GPTForCausalLM, JM.gpt_tiny, GPT, 0.5),
    "bert-pt": (JM.BertForPretraining, JM.bert_tiny, ENC, 1e-3),
    "bert-cls": (JM.BertForSequenceClassification, JM.bert_tiny, ENC, 1e-3),
    "ernie-mlm": (JM.ErnieForMaskedLM, JM.ernie_tiny, ENC, 1e-3),
    "ernie-cls": (JM.ErnieForSequenceClassification, JM.ernie_tiny, ENC,
                  1e-3),
    "vit": (JM.ViTForImageClassification, JM.vit_tiny, {}, 0.01),
    "clip": (JM.CLIPModel, JM.clip_tiny, {}, 0.01),
    "dit": (JM.DiT, JM.dit_tiny, {}, None),
    "mmdit": (JM.MMDiT, JM.mmdit_tiny, {}, None),
}
TRAIN = {"tp2": ("gpt", "bert-pt", "bert-cls", "ernie-mlm", "ernie-cls",
                 "vit", "clip"),
         "dp2tp2": ("gpt", "bert-cls")}
MESHES = {"tp2": {"tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}}


@pytest.fixture(autouse=True)
def _cpu_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _mesh(shape):
    n = math.prod(shape.values())
    jenv.init_parallel_env(shape, devices=jax.devices()[:n])
    try:
        yield
    finally:
        jenv.init_parallel_env({})


@contextlib.contextmanager
def _no_cache_writes():
    """Compile the JAX references without writing the persistent cache
    (workers reading an entry another writes can get a torn one)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, prev)


def _jax_model(name, p):
    jcls, jcfg, over, _ = FAMILIES[name]
    pt.seed(0)
    jm = jcls(jcfg(**over))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in
                       p["families"][name]["params"].items()})
    return jm


def _payload(out):
    rs = np.random.RandomState(40)
    fams = {}
    for i, (name, (jcls, jcfg, over, lr)) in enumerate(FAMILIES.items()):
        pt.seed(41 + i)
        jm = jcls(jcfg(**over))
        params = {}
        for k, v in jm.state_dict().items():
            v = np.asarray(v)
            params[k] = (np.asarray(v + 0.05 * rs.randn(*v.shape),
                                    np.float32)
                         if np.issubdtype(v.dtype, np.floating) else v)
        fams[name] = dict(cfg=over, params=params, lr=lr)
    fams["gpt"]["batch"] = [rs.randint(0, 512, (4, 16)).astype(np.int64)
                            for _ in range(2)]
    for name in ("bert-pt", "bert-cls", "ernie-mlm", "ernie-cls"):
        ids = rs.randint(0, 256, (4, 16))
        types = np.zeros_like(ids)
        types[:, 8:] = 1
        mask = np.ones_like(ids)
        mask[1, 11:] = 0
        fams[name]["batch"] = dict(
            ids=ids, types=types, mask=mask,
            mlm_labels=np.where(rs.rand(4, 16) < 0.3, ids, -100),
            labels=rs.randint(0, 2, 4))
    fams["vit"]["batch"] = dict(
        px=rs.randn(4, 3, 32, 32).astype(np.float32),
        labels=rs.randint(0, 10, 4))
    fams["clip"]["batch"] = dict(
        ids=rs.randint(3, 127, (4, 16)),
        px=rs.randn(4, 3, 16, 16).astype(np.float32))
    return dict(
        out=out, families=fams,
        gpt_ids=rs.randint(1, 512, (2, 9)),
        vit_in=[rs.randn(2, 3, 32, 32).astype(np.float32)],
        clip_in=[rs.randint(3, 127, (2, 16)),
                 rs.randn(2, 3, 16, 16).astype(np.float32)],
        dit_in=[rs.randn(2, 4, 8, 8).astype(np.float32),
                np.array([10, 700]), np.array([3, 7])],
        mmdit_in=[rs.randn(2, 4, 8, 8).astype(np.float32),
                  np.array([10, 700]),
                  rs.randn(2, 5, 48).astype(np.float32),
                  rs.randn(2, 32).astype(np.float32)],
        pipe_labels=[1, 7], pipe_seed=42,
        drop_ids=rs.randint(0, 256, (2, 16)))


def _jax_loss(name):
    def enc(fn, q, b):
        return fn(q, b["ids"], b["types"], b["mask"])
    if name == "bert-pt":
        def loss(fn, q, b):
            mlm, nsp = enc(fn, q, b)
            return jax_pretraining_loss(mlm, b["mlm_labels"], nsp,
                                        b["labels"])
        return loss
    if name == "ernie-mlm":
        return lambda fn, q, b: JF.cross_entropy(enc(fn, q, b),
                                                 b["mlm_labels"],
                                                 ignore_index=-100)
    if name in ("bert-cls", "ernie-cls"):
        return lambda fn, q, b: JF.cross_entropy(enc(fn, q, b), b["labels"])
    if name == "vit":
        return lambda fn, q, b: JF.cross_entropy(fn(q, b["px"]), b["labels"])
    if name == "clip":
        return lambda fn, q, b: jax_clip_loss(*fn(q, b["ids"], b["px"]))
    return None


def _jax_train(name, p, out_dir):
    fam = p["families"][name]
    jm = _jax_model(name, p)
    jax_shard_layer(jm)
    batch = fam["batch"]
    data = ([jnp.asarray(b, jnp.int32) for b in batch] if name == "gpt"
            else [{k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                                  else jnp.float32)
                   for k, v in batch.items()}])
    kw = dict(loss_fn=_jax_loss(name)) if name != "gpt" else {}
    tr = JaxTrainer(jm, pt.optimizer.SGD(learning_rate=fam["lr"]),
                    JaxArgs(output_dir=out_dir, max_steps=3, logging_steps=1,
                            resume_from_checkpoint=False),
                    train_dataloader=data, **kw)
    tr.train()
    return ([v for _, v in tr.logger.history["loss"]],
            {k: np.asarray(v) for k, v in tr._params.items()})


def _jax_forward(m, *args):
    fn, params = m.functional()
    return jax.jit(fn)(params, *[jnp.asarray(a) for a in args])


class _FixedDraw:
    """Stands in for ``jax`` inside the JAX schedulers: ``random.normal``
    returns ``x_t`` (the pipeline's first draw)."""

    def __init__(self, x_t):
        outer = self

        class _Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def normal(self, key, shape, dtype=jnp.float32):
                return jnp.asarray(outer.x_t, dtype)
        self.x_t = x_t
        self.random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_tp2(p, tmp):
    ref = {}
    with _mesh(MESHES["tp2"]):
        for name in TRAIN["tp2"]:
            ref[f"train_{name}"] = _jax_train(name, p, str(tmp / name))
        m = _jax_model("gpt", p)
        jax_shard_layer(m, fsdp_min_size=1 << 30)
        ids = jnp.asarray(p["gpt_ids"], jnp.int32)
        ref["gpt_logits"] = np.asarray(_jax_forward(m, ids))
        ref["gpt_greedy"] = np.asarray(m.generate(ids, max_new_tokens=8,
                                                  temperature=0.0))
        ref["gpt_beam"] = np.asarray(m.generate(ids, max_new_tokens=6,
                                                num_beams=3))
        for bits in (8, 4):
            qm = _jax_model("gpt", p)
            jax_quantize_model(qm, bits=bits, skip=["lm_head", "embed"])
            jax_shard_layer(qm, fsdp_min_size=1 << 30)
            ref[f"gpt_q{bits}_logits"] = np.asarray(_jax_forward(qm, ids))
            ref[f"gpt_q{bits}_greedy"] = np.asarray(qm.generate(
                ids, max_new_tokens=6, temperature=0.0))
        for name in ("vit", "clip", "dit", "mmdit"):
            m = _jax_model(name, p)
            m.eval()
            jax_shard_layer(m, fsdp_min_size=1 << 30)
            args = [np.asarray(a, np.int32) if a.dtype.kind == "i" else a
                    for a in p[f"{name}_in"]]
            y = _jax_forward(m, *args)
            ref[f"{name}_out"] = ([np.asarray(a) for a in y]
                                  if isinstance(y, tuple) else np.asarray(y))
            if name == "dit":
                cfg = m.config
                shape = (len(p["pipe_labels"]), cfg.in_channels,
                         cfg.input_size, cfg.input_size)
                x_t = torch.randn(shape, generator=torch.Generator()
                                  .manual_seed(p["pipe_seed"])).numpy()
                real = jsched.jax
                jsched.jax = _FixedDraw(x_t)
                try:
                    ref["dit_pipe"] = np.asarray(jpipes.DiTPipeline(m)(
                        jnp.asarray(p["pipe_labels"]),
                        num_inference_steps=4))
                finally:
                    jsched.jax = real
    return ref


def _jax_dp2tp2(p, tmp):
    ref = {}
    with _mesh(MESHES["dp2tp2"]):
        for name in TRAIN["dp2tp2"]:
            ref[f"train_{name}"] = _jax_train(name, p, str(tmp / name))
        m = _jax_model("gpt", p)
        jax_shard_layer(m, fsdp_min_size=1 << 30)
        ref["gpt_logits"] = np.asarray(_jax_forward(
            m, np.asarray(p["gpt_ids"], np.int32)))
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_zoo")
    started = {}
    for key, shape in MESHES.items():
        p = _payload(str(tmp / f"port_{key}"))
        p.update(mesh=shape, train=TRAIN[key], serve=key == "tp2")
        started[key] = (start_world("tp_zoo", math.prod(shape.values()),
                                    tmp / key, p, timeout_s=400), p)
    with _no_cache_writes():
        refs = {"tp2": _jax_tp2(started["tp2"][1], tmp / "jax_tp2"),
                "dp2tp2": _jax_dp2tp2(started["dp2tp2"][1],
                                      tmp / "jax_dp2tp2")}
    return {k: (h.result(), refs[k], p) for k, (h, p) in started.items()}


def _port_layout(name, p, params):
    """JAX-layout parameters as the port's state dict holds them (Linear
    weights transposed), through a port model that loads them."""
    m = _zoo_model(name, p["families"][name]["cfg"])
    ptt.load_jax_state_dict(m, {**p["families"][name]["params"], **params})
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


def test_gpt_qkv_lands_as_each_ranks_heads(worlds):
    """Built in ``sharded_build`` and loaded from the JAX state dict a
    rank's slices at a time: rank r holds rows [q_r; k_r; v_r] of the
    fused weight and bias; the state dict gives the JAX layout back."""
    ranks, _, p = worlds["tp2"]
    want = _port_layout("gpt", p, {})
    w = want["model.layers.0.attn.qkv_proj.weight"]
    b = want["model.layers.0.attn.qkv_proj.bias"]
    h = w.shape[1]
    for r, out in enumerate(ranks):
        rows = np.concatenate([np.arange(j * h + r * h // 2,
                                         j * h + (r + 1) * h // 2)
                               for j in range(3)])
        np.testing.assert_array_equal(out["gpt_qkv_local"][0], w[rows])
        np.testing.assert_array_equal(out["gpt_qkv_local"][1], b[rows])
        assert out["gpt_state"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(out["gpt_state"][k], v, err_msg=k)


@pytest.mark.parametrize("key", tuple(MESHES))
def test_gpt_logits_match_jax(worlds, key):
    ranks, ref, _ = worlds[key]
    for out in ranks:
        np.testing.assert_allclose(out["gpt_logits"], ref["gpt_logits"],
                                   atol=ATOL, rtol=0)


def test_gpt_generate_and_predictor_match_jax(worlds):
    """Greedy and beam tokens equal; the weight-only ``Predictor`` at
    int8 and int4 (each rank quantizing its own columns): logits within
    ``ATOL`` and greedy tokens equal."""
    ranks, ref, _ = worlds["tp2"]
    for out in ranks:
        np.testing.assert_array_equal(out["gpt_greedy"], ref["gpt_greedy"])
        np.testing.assert_array_equal(out["gpt_beam"], ref["gpt_beam"])
        for bits in (8, 4):
            np.testing.assert_allclose(out[f"gpt_q{bits}_logits"],
                                       ref[f"gpt_q{bits}_logits"],
                                       atol=ATOL, rtol=0)
            np.testing.assert_array_equal(out[f"gpt_q{bits}_greedy"],
                                          ref[f"gpt_q{bits}_greedy"])


@pytest.mark.parametrize("key,name", tuple(
    (k, n) for k in MESHES for n in TRAIN[k]))
def test_trainer_steps_match_jax(worlds, key, name):
    """3 SGD steps: the loss histories and every parameter after them."""
    ranks, ref, p = worlds[key]
    want_losses, want_params = ref[f"train_{name}"]
    want = _port_layout(name, p, want_params)
    for out in ranks:
        got = out[f"train_{name}"]
        np.testing.assert_allclose(got["losses"], want_losses,
                                   rtol=RTOL_LOSS, atol=0)
        assert got["losses"][-1] < got["losses"][0]
        for k in want_params:
            np.testing.assert_allclose(got["state"][k], want[k],
                                       atol=ATOL_PARAMS, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ("vit", "clip", "dit", "mmdit"))
def test_eval_outputs_match_jax(worlds, name):
    """ViT's logits, CLIP's logits per image and per text, one DiT and
    one MMDiT denoising step (MMDiT's projections replicated)."""
    ranks, ref, _ = worlds["tp2"]
    want = ref[f"{name}_out"]
    for out in ranks:
        got = out[f"{name}_out"]
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_dit_pipeline_matches_jax(worlds):
    """``DiTPipeline`` (DDIM, guidance 4), 4 steps from the same x_T."""
    ranks, ref, _ = worlds["tp2"]
    for out in ranks:
        np.testing.assert_allclose(out["dit_pipe"], ref["dit_pipe"],
                                   atol=ATOL_LOOP, rtol=0)


def test_dropout_on_a_tp_mesh(worlds):
    """The residual stream's dropout (after a row-parallel reduce: the
    same mask on both ranks) keeps the ranks' hidden states equal; a
    dropout over each rank's own heads draws its own mask; each keep
    rate is within 3 sigma of 1 - p."""
    ranks, _, _ = worlds["tp2"]
    np.testing.assert_array_equal(ranks[0]["drop_hidden"],
                                  ranks[1]["drop_hidden"])
    a, b = ranks[0]["drop_mask"], ranks[1]["drop_mask"]
    assert a.shape == b.shape and (a != b).any()
    for m in (a, b):
        sigma = math.sqrt(DROP_P * (1 - DROP_P) / m.size)
        assert abs(m.mean() - (1 - DROP_P)) < 3 * sigma
