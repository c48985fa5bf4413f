"""Serving gateway subsystem: the async HTTP/SSE front door
over :class:`~paddle_tpu_torch.generation.paged.PagedEngine` — SLO-aware
continuous-batching admission (:mod:`.scheduler`), prefix-cache-aware
multi-replica routing (:mod:`.router`), and the stdlib-only gateway
server with graceful SIGTERM drain (:mod:`.gateway`).

The multi-host fleet layer lives in :mod:`.fleet`: remote
replica adapters over peer-gateway HTTP probes, the byte-for-byte
proxying frontend with cross-process failover, prefix-digest gossip
and the closed-loop autoscaler. Import it explicitly
(``from paddle_tpu_torch.serving.fleet import FleetFrontend, ...``) — the
gateway itself stays importable without the fleet machinery.

See ``docs/SERVING.md`` for the API schema, SLO classes, drain
semantics and the load-generator reading guide.
"""
from .gateway import Gateway
from .kvspill import KVSpillArena
from .reqtrace import RequestTrace, RequestTraceRing
from .router import EngineReplica, NoReplicaError, PrefixAffinityRouter
from .scheduler import (SLO_BATCH, SLO_INTERACTIVE, ServeRequest,
                        ShedError, SLOScheduler)
from .slo import BurnRateEngine, BurnRule
from .supervisor import CircuitBreaker, ReplicaSupervisor

__all__ = [
    "Gateway", "KVSpillArena",
    "BurnRateEngine", "BurnRule",
    "CircuitBreaker", "ReplicaSupervisor",
    "EngineReplica", "NoReplicaError", "PrefixAffinityRouter",
    "RequestTrace", "RequestTraceRing",
    "SLO_BATCH", "SLO_INTERACTIVE", "ServeRequest", "ShedError",
    "SLOScheduler",
]
