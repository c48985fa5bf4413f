"""Multi-host serving fleet (counterpart of
``paddle_tpu/serving/fleet/``): the layer that turns N gateway
PROCESSES into one service — the "millions of users" tier the
single-process gateway cannot reach.

- :mod:`.remote` — :class:`RemoteReplica`: the router's duck-typed
  replica seam (``healthy``/``load``/``has_prefix``) implemented over
  cached HTTP probes of a peer gateway (``/healthz`` + the
  ``/debugz/prefix`` digest gossip), with staleness bounds.
- :mod:`.frontend` — :class:`FleetFrontend`: prefix-affinity routing
  over remote peers, byte-for-byte SSE proxying, and mid-stream peer
  failover through the HTTP face of the resume seam (greedy
  streams bitwise identical across a peer death).
- :mod:`.autoscaler` — :class:`FleetAutoscaler`: the closed loop over
  the gateway's gauges (queue depth, free slots, block pressure, goodput
  fraction) with hysteresis + cooldown, spawning/draining replica
  processes under SIGTERM-drain semantics.
- :mod:`.manager` — :class:`LocalProcessManager`: the process backend
  (spawn ``replica_main`` subprocesses, SIGTERM drains, SIGKILL
  chaos); accepts a LIST of frontends (HA) — every sibling
  gets its own adapter per spawned process.
- :mod:`.ha` — :class:`FrontendLink`/:func:`link_frontends`:
  leaderless frontend-to-frontend gossip (prefix digests, breaker
  states, sticky assignments) so a frontend death loses no routing
  state and a client retry against the survivor resumes mid-stream.
- :mod:`.sim` — :class:`FleetSim`: the trace-driven chaos simulator
  that runs THESE real objects (frontend, router, autoscaler, burn
  engine, breakers) against thousands of in-process replica stubs on
  a simulated clock (``python -m paddle_tpu_torch.serving.fleet.sim``).

See ``docs/SERVING.md`` ("Fleet serving") and
``docs/FAULT_TOLERANCE.md`` (remote + frontend failure models).
"""
from .autoscaler import FleetAutoscaler
from .frontend import FleetFrontend
from .ha import FrontendLink, link_frontends
from .manager import LocalProcessManager
from .remote import RemoteReplica, prefix_digest_chain

_SIM_NAMES = ("SCENARIOS", "FleetSim", "SimClock", "SimProcess",
              "SimReplica", "build_scenario")


def __getattr__(name):
    # the simulator loads on first use, so ``python -m
    # paddle_tpu_torch.serving.fleet.sim`` runs it as a script once
    if name in _SIM_NAMES:
        from . import sim
        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FleetAutoscaler", "FleetFrontend", "LocalProcessManager",
    "RemoteReplica", "prefix_digest_chain",
    "FrontendLink", "link_frontends",
    "FleetSim", "SimClock", "SimProcess", "SimReplica",
    "SCENARIOS", "build_scenario",
]
