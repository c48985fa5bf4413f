"""Distributed training helpers (counterpart of ``paddle_tpu/distributed``):
the elastic relaunch supervisor. Collectives, the fleet and the launcher
come with the multi-device slice."""
from .elastic import PREEMPTED_RC, supervise

__all__ = ["supervise", "PREEMPTED_RC"]
