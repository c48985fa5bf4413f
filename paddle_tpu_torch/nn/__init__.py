"""paddle_tpu_torch.nn (counterpart of ``paddle_tpu/nn``): every name the
JAX package's ``nn`` exports, each layer a :class:`Layer` (a
``torch.nn.Module`` with Paddle's API), ``F`` the functional module."""
from . import functional, initializer
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Mish, PReLU, ReLU, ReLU6, Sigmoid, SiLU,
                         Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
                         Tanhshrink)
from .common import (AdaptiveAvgPool1D, AlphaDropout, AvgPool1D, AvgPool3D,
                     Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
                     Dropout2D, Dropout3D, Embedding, Flatten, Fold,
                     Identity, Linear, LocalResponseNorm, MaxPool1D,
                     MaxPool3D, MaxUnPool2D, Maxout, Pad1D, Pad2D,
                     PairwiseDistance, PixelShuffle, PixelUnshuffle, RReLU,
                     ThresholdedReLU, Unfold, Upsample, UpsamplingBilinear2D,
                     ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D, Conv1D,
                   Conv2D, Conv2DTranspose, Conv3D, MaxPool2D)
from .layer import Buffer, Layer, Parameter, ParamMeta
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
                   PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm2D, LayerNorm, RMSNorm,
                   SyncBatchNorm)
from .recompute import checkpoint_wrapper, recompute
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

F = functional
