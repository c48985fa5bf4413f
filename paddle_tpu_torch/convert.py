"""Weights from the JAX package into the port.

``params`` is ``{name: np.ndarray}`` as the JAX package's
``model.state_dict()`` gives it, under the same names
(``model.layers.0.self_attn.q_proj.weight``, ...). The port's modules
are built so that their parameter and buffer names are those names.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .nn.common import Linear


@torch.no_grad()
def load_jax_state_dict(model: nn.Module,
                        params: Mapping[str, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` in place: its parameters and its
    persistent buffers (a quantized model's ``qweight``, ``scales``,
    ``bias`` and ``awq_inv``).

    - Transposes: every ``Linear`` weight (the q/k/v/o, gate/up/down
      projections and ``lm_head``) is stored [in, out] by the JAX package
      and [out, in] here, so it is transposed. Everything else keeps its
      layout: embedding tables, norm weights, biases, and a
      ``QuantizedLinear``'s codes and scales, which are [din, dout] in
      both packages (it is not a ``Linear``).
    - Dtypes: each value is cast to the dtype of the tensor it fills and
      moved to its device. Floating values go through float32, so bf16
      scales cross bit for bit; integer codes are copied as integers.
    - Strict, as the JAX ``set_state_dict`` is: a missing or unexpected key
      raises ``KeyError``; a shape that does not fit raises ``ValueError``.
    """
    own = model.state_dict(keep_vars=True)
    missing = [k for k in own if k not in params]
    unexpected = [k for k in params if k not in own]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing[:5]} "
                       f"unexpected={unexpected[:5]}")
    transposed = {f"{name}.weight" if name else "weight"
                  for name, mod in model.named_modules()
                  if isinstance(mod, Linear)}
    for name, dst in own.items():
        src = np.asarray(params[name])
        value = torch.from_numpy(np.array(
            src, np.float32 if dst.is_floating_point() else src.dtype))
        if name in transposed:
            value = value.T
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} after "
                             f"conversion, model holds {tuple(dst.shape)}")
        dst.copy_(value.to(device=dst.device, dtype=dst.dtype))
