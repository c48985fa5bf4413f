from .layers import (ColumnParallelLinear, RowParallelLinear,
                     VocabParallelEmbedding, parallel_matmul)
from .sharding import constraint

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_matmul", "constraint"]
