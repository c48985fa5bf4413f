"""Fleet facade (counterpart of ``paddle_tpu/distributed/fleet.py``;
reference: python/paddle/distributed/fleet/__init__.py — fleet.init
(strategy), DistributedStrategy with hybrid_configs, and the
distributed_model/distributed_optimizer wrappers).

A ``DistributedStrategy`` is a mesh recipe: ``init`` initialises the
process group (from the launcher's environment, or a world of one) and
installs the global mesh from the hybrid degrees; ``distributed_model``
turns a module's parameters into ``DTensor``s on that mesh (ZeRO over
the fsdp axis by sharding stage; see ``parallel.sharding``);
``distributed_optimizer`` records the strategy (the optimizer's state
takes its parameters' placements, which is ZeRO stage 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from torch import nn

from . import env


@dataclass
class DistributedStrategy:
    """Reference: paddle.distributed.fleet.DistributedStrategy.
    hybrid_configs maps fleet's degree names onto mesh axes:
        dp_degree -> "dp", sharding_degree -> "fsdp", mp_degree -> "tp",
        pp_degree -> "pp", sep_degree -> "sp", ep_degree -> "ep".
    sharding_stage: 1 = opt-state sharded, 2 = +grads, 3 = +params
    (all expressed as fsdp-axis shardings; see parallel.sharding).
    """
    hybrid_configs: Dict[str, int] = field(default_factory=dict)
    sharding_stage: int = 1
    amp: bool = False
    amp_level: str = "O1"
    recompute: bool = False
    gradient_merge_steps: int = 1
    find_unused_parameters: bool = False  # accepted for parity

    _DEGREE_TO_AXIS = {
        "dp_degree": "dp", "sharding_degree": "fsdp", "mp_degree": "tp",
        "pp_degree": "pp", "sep_degree": "sp", "ep_degree": "ep",
    }

    def mesh_shape(self) -> Dict[str, int]:
        out = {}
        for k, v in self.hybrid_configs.items():
            axis = self._DEGREE_TO_AXIS.get(k, k)
            if axis not in env.HYBRID_AXES:
                raise ValueError(f"unknown hybrid axis {k!r}")
            if v and v > 1:
                out[axis] = int(v)
        return out


_strategy: Optional[DistributedStrategy] = None


def init(is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, device=None):
    """fleet.init: install the global mesh from the strategy (``device``
    None is the card, "cpu" asks for the CPU)."""
    global _strategy
    _strategy = strategy or DistributedStrategy()
    env.init_parallel_env(_strategy.mesh_shape(), device=device)
    return _strategy


def get_strategy() -> DistributedStrategy:
    return _strategy or DistributedStrategy()


def distributed_model(model: nn.Module,
                      fsdp_min_size: Optional[int] = None) -> nn.Module:
    """Place the model's parameters on the installed mesh as DTensors.
    Stage 3 shards every eligible parameter over fsdp; stages 1/2 keep
    them replicated over fsdp."""
    from ..parallel.sharding import shard_layer
    st = get_strategy()
    if fsdp_min_size is None:
        fsdp_min_size = 2 ** 16 if st.sharding_stage >= 3 else (1 << 62)
    shard_layer(model, fsdp_min_size=fsdp_min_size)
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    if strategy is not None:
        global _strategy
        _strategy = strategy
    return optimizer


def worker_num() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def worker_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_first_worker() -> bool:
    return worker_index() == 0
