"""Weights from the JAX package into the port.

``params`` is ``{name: np.ndarray}`` as the JAX package's
``model.state_dict()`` gives it, under the same names
(``model.layers.0.self_attn.q_proj.weight``, ...). The port's modules
are built so that their parameter names are those names.
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
    """Copy ``params`` into ``model`` in place.

    - Transposes: every ``Linear`` weight (the q/k/v/o, gate/up/down
      projections and ``lm_head``) is stored [in, out] by the JAX package
      and [out, in] here, so it is transposed. Embedding tables, norm
      weights and biases keep their layout.
    - Dtypes: each value is cast to the dtype of the parameter it fills
      (the model's dtype), and moved to its device.
    - Strict, as the JAX ``set_state_dict`` is: a missing or unexpected key
      raises ``KeyError``; a shape that does not fit raises ``ValueError``.
    """
    own = dict(model.named_parameters())
    missing = [k for k in own if k not in params]
    unexpected = [k for k in params if k not in own]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing[:5]} "
                       f"unexpected={unexpected[:5]}")
    transposed = {f"{name}.weight" if name else "weight"
                  for name, mod in model.named_modules()
                  if isinstance(mod, Linear)}
    for name, param in own.items():
        value = torch.from_numpy(np.array(params[name], np.float32))
        if name in transposed:
            value = value.T
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} after "
                             f"conversion, parameter is "
                             f"{tuple(param.shape)}")
        param.copy_(value.to(device=param.device, dtype=param.dtype))
