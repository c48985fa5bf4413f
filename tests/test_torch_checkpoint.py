"""``checkpoint.save`` / ``load`` of the port against the JAX package's:
one format (npz of arrays plus a JSON ``__manifest__``, the pickle
fallback), so a file written by either package loads in the other.
Arrays cross bit for bit; a model's weights (fp32, CPU) give the same
logits on both sides, within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.checkpoint import load as jax_load
from paddle_tpu.checkpoint import save as jax_save
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.checkpoint import load, save
from paddle_tpu_torch.convert import jax_state_dict

TOL_LOGITS = 1e-5


def _structure(rs):
    return {"w": rs.randn(3, 4).astype(np.float32),
            "ids": rs.randint(0, 9, (5,)).astype(np.int32),
            "nested": {"step": 7, "lr": 0.5, "name": "adamw",
                       "pair": (rs.randn(2).astype(np.float32), 3),
                       "list": [rs.randn(1, 2).astype(np.float32), None]}}


def _same(a, b):
    """Equal structures: arrays (numpy or tensors) bit for bit, tuples,
    lists and scalars as they are."""
    if isinstance(b, np.ndarray) or hasattr(b, "shape"):
        x = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(x, np.asarray(b))
        assert x.dtype == np.asarray(b).dtype
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_jax_file_loads_in_the_port(tmp_path):
    obj = _structure(np.random.RandomState(0))
    jax_save({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in obj.items()}, str(tmp_path / "j"))
    got = load(str(tmp_path / "j"))
    assert torch.is_tensor(got["w"]) and torch.is_tensor(
        got["nested"]["pair"][0])
    _same(got, obj)


def test_port_file_loads_in_jax(tmp_path):
    obj = _structure(np.random.RandomState(1))
    port_obj = dict(obj, w=torch.from_numpy(obj["w"]))
    save(port_obj, str(tmp_path / "t"))
    _same(jax_load(str(tmp_path / "t")), obj)
    _same(load(str(tmp_path / "t.npz")), obj)


def test_pickle_fallback_both_ways(tmp_path):
    """A structure JSON cannot hold (bytes) is pickled, tensors as numpy
    arrays, as the JAX package pickles its arrays."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    save({"w": torch.from_numpy(w), "tag": b"raw"}, str(tmp_path / "tp"))
    got = jax_load(str(tmp_path / "tp"))
    np.testing.assert_array_equal(got["w"], w)
    assert got["tag"] == b"raw"
    jax_save({"w": jnp.asarray(w), "tag": b"raw"}, str(tmp_path / "jp"))
    got = load(str(tmp_path / "jp"))
    np.testing.assert_array_equal(got["w"], w)
    assert bytes(got["tag"]) == b"raw"


def test_bf16_arrays_lose_their_dtype_in_both(tmp_path):
    """npz keeps a bf16 array's two bytes a value but not its dtype
    (``|V2``): the two packages write the same bytes, and both refuse to
    load them."""
    x = torch.tensor([[1.5, -2.25, 3.0]], dtype=torch.bfloat16)
    save({"x": x}, str(tmp_path / "tb"))
    jax_save({"x": jnp.asarray(x.float().numpy(), jnp.bfloat16)},
             str(tmp_path / "jb"))
    a = np.load(str(tmp_path / "tb.npz"))["a0"]
    b = np.load(str(tmp_path / "jb.npz"))["a0"]
    assert a.dtype == b.dtype == np.dtype("V2")
    assert a.tobytes() == b.tobytes()
    for path in ("tb", "jb"):
        with pytest.raises(TypeError):
            load(str(tmp_path / path))
        with pytest.raises(TypeError):
            jax_load(str(tmp_path / path))


@pytest.fixture(scope="module")
def jm():
    pt.seed(3)
    m = JaxLlama(jax_llama_tiny())
    m.eval()
    return m


def test_model_weights_cross_both_ways(jm, tmp_path):
    """JAX ``save(model.state_dict())`` -> ``Predictor.from_checkpoint``
    in the port, and the port's ``save(jax_state_dict(model))`` -> JAX
    ``set_state_dict(load(...))``: the same logits."""
    ids = np.random.RandomState(4).randint(0, 256, (2, 9))
    ref = np.asarray(jm(jnp.asarray(ids)))
    jax_save(jm.state_dict(), str(tmp_path / "jm"))
    pred = ptt.Predictor.from_checkpoint(
        lambda: ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu"),
        str(tmp_path / "jm"), device="cpu")
    np.testing.assert_allclose(pred.run(ids).numpy(), ref, atol=TOL_LOGITS,
                               rtol=0)
    save(jax_state_dict(pred.model), str(tmp_path / "tm"))
    pt.seed(5)
    back = JaxLlama(jax_llama_tiny())
    back.eval()
    back.set_state_dict(jax_load(str(tmp_path / "tm")))
    np.testing.assert_array_equal(np.asarray(back(jnp.asarray(ids))), ref)


def test_config_model_path_and_create_predictor(jm):
    cfg = ptt.Config("ckpt/model")
    assert cfg.model_path == "ckpt/model"
    assert ptt.Config().model_path is None
    with pytest.raises(ValueError, match="model"):
        ptt.create_predictor(cfg)
    tm = ptt.LlamaForCausalLM(ptt.llama_tiny(), device="cpu")
    pred = ptt.create_predictor(cfg, tm, device="cpu")
    assert isinstance(pred, ptt.Predictor) and pred.model is tm
