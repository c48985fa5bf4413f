from . import functional, initializer
from .activation import GELU, ReLU, SiLU, Tanh
from .common import Dropout, Embedding, Linear
from .container import LayerList
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Embedding", "Linear", "Dropout",
           "LayerList", "LayerNorm", "RMSNorm", "GELU", "ReLU", "SiLU",
           "Tanh", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
