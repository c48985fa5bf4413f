from . import functional, initializer
from .activation import GELU, ReLU, Sigmoid, SiLU, Tanh
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
                   PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
from .conv import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D, Conv1D,
                   Conv2D, Conv2DTranspose, Conv3D, MaxPool2D)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm2D, LayerNorm, RMSNorm,
                   SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Embedding", "Linear", "Dropout",
           "LayerList", "Sequential", "LayerNorm", "RMSNorm", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
           "GroupNorm", "InstanceNorm2D", "Conv1D", "Conv2D", "Conv3D",
           "Conv2DTranspose", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "GELU", "ReLU", "Sigmoid", "SiLU", "Tanh",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "SmoothL1Loss", "BCELoss", "BCEWithLogitsLoss",
           "NLLLoss", "KLDivLoss", "CTCLoss", "TripletMarginLoss",
           "MarginRankingLoss", "SoftMarginLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "PoissonNLLLoss",
           "MultiLabelSoftMarginLoss", "GaussianNLLLoss"]
