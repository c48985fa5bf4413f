"""The slice as a whole, on the CPU against the JAX package.

- The beginner path (``examples/mnist_model_api.py``): the port's ``Net``
  (an ``nn.Layer`` with ``nn.Flatten`` and two ``nn.Linear``) takes the
  JAX ``Net``'s weights through ``load_jax_state_dict``, and
  ``Model.fit`` with ``AdamW``, ``F.cross_entropy`` and
  ``metric.Accuracy`` runs 2 epochs over ``FakeData(256, (3, 16, 16))``
  in both packages (in order: the JAX sampler's shuffle draws from OS
  entropy): every step's loss within rtol 1e-5, ``evaluate`` within 1e-5
  and its accuracy equal; ``summary`` counts the same parameters.
- ``chip_smoke.py``'s ``[api] (a)`` decoder at 2 tiny layers (head_dim
  64, 128 positions: the flash route): an ``nn.Layer`` written against
  ``incubate.nn.functional`` only, its weights from the port's
  ``LlamaForCausalLM`` layers, which take the JAX model's; its outputs,
  input gradient and every weight's gradient against the JAX
  ``LlamaForCausalLM`` layers and ``jax.grad`` within 1e-4 (fp32), and
  its masked call (the dense route) within 1e-4 of the flash route.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.models import llama as jllama
from paddle_tpu.vision.datasets import FakeData as JFakeData
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.vision.datasets import FakeData as TFakeData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.flatten = jnn.Flatten()
        self.fc1 = jnn.Linear(3 * 16 * 16, 128)
        self.fc2 = jnn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(self.flatten(x))))


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.flatten = tnn.Flatten()
        self.fc1 = tnn.Linear(3 * 16 * 16, 128, device="cpu")
        self.fc2 = tnn.Linear(128, 10, device="cpu")

    def forward(self, x):
        return self.fc2(tnn.functional.relu(self.fc1(self.flatten(x))))


def test_beginner_model_fit_matches_jax():
    pt.seed(0)
    jnet = JNet()
    ptt.seed(0)
    tnet = TNet()
    ptt.load_jax_state_dict(tnet, {k: np.asarray(v) for k, v in
                                   jnet.state_dict().items()})
    assert pt.summary(jnet)["total_params"] == \
        ptt.summary(tnet)["total_params"] == 99722
    jm, tm = pt.Model(jnet), ptt.Model(tnet)
    jm.prepare(pt.optimizer.AdamW(learning_rate=1e-3),
               loss=jnn.functional.cross_entropy,
               metrics=pt.metric.Accuracy())
    tm.prepare(ptt.optimizer.AdamW(learning_rate=1e-3),
               loss=tnn.functional.cross_entropy,
               metrics=ptt.metric.Accuracy())
    kw = dict(batch_size=32, epochs=2, log_freq=1, verbose=0, shuffle=False)
    want = jm.fit(JFakeData(num_samples=256, image_shape=(3, 16, 16),
                            num_classes=10), **kw)
    got = tm.fit(TFakeData(num_samples=256, image_shape=(3, 16, 16),
                           num_classes=10), **kw)
    assert len(got["loss"]) == len(want["loss"]) == 16
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    jres = jm.evaluate(JFakeData(256, (3, 16, 16), 10), batch_size=32,
                       verbose=0)
    tres = tm.evaluate(TFakeData(256, (3, 16, 16), 10), batch_size=32,
                       verbose=0)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    assert tres["acc"] == jres["acc"]


def _tiny():
    kw = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256)
    return jllama.llama_tiny(**kw), ptt.llama_tiny(**kw)


def test_api_decoder_matches_the_jax_llama_layers():
    cs = _chip_smoke()
    jcfg, tcfg = _tiny()
    pt.seed(0)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    tmodel = ptt.LlamaForCausalLM(tcfg, device="cpu")
    ptt.load_jax_state_dict(tmodel, state)
    api = cs.api_decoder(tcfg, "cpu").load_from(tmodel)
    assert isinstance(api, tnn.Layer)
    b, s, h = 2, 128, tcfg.hidden_size
    rs = np.random.RandomState(0)
    x = rs.randn(b, s, h).astype(np.float32)
    w = rs.randn(b, s, h).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    layer_keys = [k for k in state if k.startswith("model.layers.")]

    def jloss(p, x):
        with jmodel.bound(p):
            y = x
            for layer in jmodel.model.layers:
                y = layer(y, jnp.asarray(pos))
        return jnp.sum(y * w), y
    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(state[k]) for k in layer_keys}, jnp.asarray(x))
    cos, sin = cs.api_rope_tables(tmodel, s)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = api(tx, cos, sin, torch.from_numpy(pos.copy()))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-4)
    grads = dict(api.named_parameters())
    for k in layer_keys:
        i, rest = k[len("model.layers."):].split(".", 1)
        g = grads[f"layers.{i}.{cs.API_RENAME[rest]}"].grad.numpy()
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(g.T if g.ndim == 2 else g, want,
                                   atol=1e-4, err_msg=k)
    mask = torch.ones(b, 1, 1, s, dtype=torch.bool)
    with torch.no_grad():
        masked = api(tx, cos, sin, torch.from_numpy(pos.copy()),
                     attn_mask=mask)
    np.testing.assert_allclose(masked.numpy(), out.detach().numpy(),
                               atol=1e-4)
