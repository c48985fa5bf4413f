from . import functional, initializer
from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["functional", "initializer", "Embedding", "Linear", "RMSNorm"]
