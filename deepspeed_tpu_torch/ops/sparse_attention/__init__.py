"""Block-sparse attention (counterpart of deepspeed_tpu/ops/sparse_attention;
the standalone block-sparse ``MatMul`` is not ported yet, ROADMAP A4.5)."""

from .sparse_attention_utils import SparseAttentionUtils
from .sparse_self_attention import sparse_attention
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["SparseAttentionUtils", "sparse_attention",
           "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "DenseSparsityConfig", "FixedSparsityConfig", "SparsityConfig",
           "VariableSparsityConfig"]
