"""Distributed training (counterpart of ``paddle_tpu/distributed``;
reference: python/paddle/distributed/__init__.py): the mesh, the
collectives over its named axes, the fleet facade, the launcher, and the
elastic relaunch supervisor."""
from . import collective, env, fleet, launch
from .collective import (CollectiveError, ReduceOp, all_gather, all_reduce,
                         all_to_all, axis_index, axis_size, broadcast,
                         eager_all_gather, eager_all_reduce, eager_broadcast,
                         ppermute, reduce_scatter)
from .elastic import PREEMPTED_RC, supervise
from .env import (HYBRID_AXES, barrier, clear_mesh, get_mesh, get_rank,
                  get_world_size, has_mesh, init_parallel_env, replicated,
                  set_mesh, sharding)
from .launch import init_distributed

__all__ = ["collective", "env", "fleet", "launch", "CollectiveError",
           "ReduceOp", "all_gather", "all_reduce", "all_to_all",
           "axis_index", "axis_size", "broadcast", "eager_all_gather",
           "eager_all_reduce", "eager_broadcast", "ppermute",
           "reduce_scatter", "PREEMPTED_RC", "supervise", "HYBRID_AXES",
           "barrier", "clear_mesh", "get_mesh", "get_rank",
           "get_world_size", "has_mesh", "init_parallel_env", "replicated",
           "set_mesh", "sharding", "init_distributed"]
