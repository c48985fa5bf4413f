"""paddle.incubate (counterpart of ``paddle_tpu/incubate``): the
namespace PaddleNLP imports its fused ops from."""
from . import nn

__all__ = ["nn"]
