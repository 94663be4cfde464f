"""Namespace parity with the TPU package's ``deepspeed_tpu.ops.transformer``
(reference ``deepspeed/ops/transformer``): the fused ops, each a
hand-written CUDA kernel behind an autograd function, and the user-facing
layer API (``DeepSpeedTransformerLayer``/``Config``, reference
transformer.py:39,460).
"""

from ..cuda.decode_attention import decode_attention
from ..cuda.flash_attention import flash_attention
from ..cuda.gelu import bias_gelu, gelu
from ..cuda.layer_norm import layer_norm
from ..cuda.softmax import fused_softmax, masked_softmax
from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer)

__all__ = ["flash_attention", "decode_attention", "layer_norm",
           "fused_softmax", "masked_softmax", "bias_gelu", "gelu",
           "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"]
