"""Tensor-parallel layers on one device (counterpart of
``paddle_tpu/parallel/layers.py``).

In the JAX package these are full-size layers with sharding hints that
GSPMD turns into collectives; on one device they are the dense layers.
They keep their names so that a model's parameter names match the JAX
package's, and their default initializers. Sharding across cards comes
with the multi-device slice.
"""
from __future__ import annotations

from ..nn import initializer as I
from ..nn.common import Embedding, Linear


class ColumnParallelLinear(Linear):
    """Output dim split over ``tp`` in the JAX package; dense here."""


class RowParallelLinear(Linear):
    """Input dim split over ``tp`` in the JAX package; dense here."""


class VocabParallelEmbedding(Embedding):
    """Vocab dim split over ``tp`` in the JAX package; dense here.
    Initialised N(0, 0.02), as there."""

    def __init__(self, num_embeddings, embedding_dim, **kw):
        kw.setdefault("weight_init", I.Normal(0.0, 0.02))
        super().__init__(num_embeddings, embedding_dim, **kw)


def parallel_matmul(x, weight, transpose_y: bool = False):
    """LM-head projection against an embedding table (``transpose_y`` for
    tied embeddings, whose weight is [vocab, hidden])."""
    return x @ (weight.T if transpose_y else weight)
