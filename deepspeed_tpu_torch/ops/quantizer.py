"""int8 KV-cache quantization: the port's copy of ``quantize_kv`` and
``dequantize_kv`` from ``deepspeed_tpu/ops/quantizer.py``.

One symmetric scale group per token vector (the last axis: one position's
concatenated heads, the unit in which cache rows are written and read),
computed in f32: ``q_scale = 256 / (2 * absmax + 1e-5)``, rounded half to
even (``torch.round``, as ``jnp.round``), clamped to [-128, 127] so the
group's extreme does not wrap. The stored scale is the dequant multiplier
``1 / q_scale``, so a read is ``q * scale`` with no division.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 [..., D], f32 dequant multiplier [..., 1])."""
    flat = x.float()
    absmax = flat.abs().amax(dim=-1, keepdim=True)
    q_scale = 256.0 / (2.0 * absmax + 1e-5)
    q = torch.round(flat * q_scale).clamp(-128.0, 127.0).to(torch.int8)
    return q, 1.0 / q_scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``(q * scale)`` in f32, cast to
    ``dtype``; ``scale`` broadcasts against ``q``."""
    return (q.float() * scale).to(dtype)
