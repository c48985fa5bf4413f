"""Checkpointing (counterpart of ``paddle_tpu/checkpoint/__init__.py``:
``paddle.save`` / ``paddle.load``), in the JAX package's format, so a
file written by either package loads in the other.

Format: an ``.npz`` of arrays named ``a0``, ``a1``, ... plus a JSON
``__manifest__`` (as uint8 bytes) that holds the nested structure, each
array replaced by ``{"__paddle_tpu_arrays__": name}`` and each tuple by
``{"__tuple__": [...]}``; a structure JSON cannot hold is pickled
instead (paddle does the same). Tensors are written as numpy arrays and
read back as CPU tensors.

bf16: numpy has no bf16 type, so a bf16 tensor is written as its raw
2-byte values, which is what ``np.savez`` writes for the JAX package's
bf16 arrays (dtype ``|V2``); the dtype does not survive the file, and
both packages refuse to load such an array (``TypeError``).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save", "load"]

_ARRAY_KEY = "__paddle_tpu_arrays__"


def _to_numpy(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(t)


def _split_state(obj, arrays):
    """Replace tensors and arrays in a nested structure with
    placeholders, collecting them into ``arrays``."""
    if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = _to_numpy(obj)
        return {_ARRAY_KEY: key}
    if isinstance(obj, dict):
        return {k: _split_state(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_split_state(v, arrays) for v in obj]
        return out if isinstance(obj, list) else {"__tuple__": out}
    return obj


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V":
        raise TypeError(
            f"Dtype {a.dtype.str} is not a valid tensor type: a bf16 array "
            f"written to npz keeps its bytes but not its dtype")
    return torch.from_numpy(np.array(a))


def _join_state(obj, arrays):
    if isinstance(obj, dict):
        if _ARRAY_KEY in obj:
            return _to_tensor(arrays[obj[_ARRAY_KEY]])
        if "__tuple__" in obj:
            return tuple(_join_state(v, arrays) for v in obj["__tuple__"])
        return {k: _join_state(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_join_state(v, arrays) for v in obj]
    return obj


def _pickled(obj):
    """The pickle fallback's payload: tensors as numpy arrays."""
    if torch.is_tensor(obj):
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _pickled(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pickled(v) for v in obj)
    return obj


def save(obj: Any, path: str):
    """``paddle.save``: a state_dict, or any nested structure of tensors,
    arrays and JSON-able scalars, to ``path`` + ``.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    try:
        structure = _split_state(obj, arrays)
        manifest = json.dumps(structure)
    except TypeError:
        # not JSON-able: the pickle fallback
        with open(path, "wb") as f:
            pickle.dump(_pickled(obj), f)
        return
    np.savez(path if path.endswith(".npz") else path + ".npz",
             __manifest__=np.frombuffer(manifest.encode(), dtype=np.uint8),
             **arrays)


def load(path: str):
    """``paddle.load``: arrays come back as CPU tensors. A pickled file
    is unpickled: load only files this program, or the JAX package,
    wrote."""
    npz_path = path + ".npz" if not path.endswith(".npz") \
        and os.path.exists(path + ".npz") else path
    if os.path.exists(npz_path) and npz_path.endswith(".npz"):
        with np.load(npz_path) as data:
            manifest = json.loads(bytes(data["__manifest__"]).decode())
            arrays = {k: data[k] for k in data.files if k != "__manifest__"}
        return _join_state(manifest, arrays)
    with open(path, "rb") as f:
        return pickle.load(f)
