"""Block-sparse attention and the standalone block-sparse ``MatMul``
(counterpart of deepspeed_tpu/ops/sparse_attention)."""

from .matmul import MatMul
from .sparse_attention_utils import SparseAttentionUtils
from .sparse_self_attention import sparse_attention
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["MatMul", "SparseAttentionUtils", "sparse_attention",
           "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig", "SparsityConfig",
           "VariableSparsityConfig"]
