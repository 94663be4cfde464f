"""int8 KV-cache quantization and stochastic bf16 rounding: the port's copy
of ``quantize_kv``, ``dequantize_kv`` and ``stochastic_round_bf16`` from
``deepspeed_tpu/ops/quantizer.py``.

One symmetric scale group per token vector (the last axis: one position's
concatenated heads, the unit in which cache rows are written and read),
computed in f32: ``q_scale = 256 / (2 * absmax + 1e-5)``, rounded half to
even (``torch.round``, as ``jnp.round``), clamped to [-128, 127] so the
group's extreme does not wrap. The stored scale is the dequant multiplier
``1 / q_scale``, so a read is ``q * scale`` with no division.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding: add 16 uniform random bits
    below the bf16 truncation point, then truncate the mantissa. Unbiased
    in expectation (the training-mode rounding of the reference's
    StochasticTransformerBuilder kernels, ds_transformer_cuda.cpp:
    1031-1046). Non-finite values take the deterministic cast. The bits come
    from ``generator`` (the default generator when None), so they are not
    the TPU package's bits from the same seed. The uint32 arithmetic runs on
    int64 (torch has few uint32 ops); like the TPU package's bitcast, the
    result carries no gradient."""
    x32 = x.detach().float()
    bits = x32.view(torch.int32).long() & 0xFFFFFFFF
    noise = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                          device=x32.device, dtype=torch.int64)
    kept = (bits + noise) & 0xFFFF0000
    kept = torch.where(kept >= 1 << 31, kept - (1 << 32), kept)
    sr = kept.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x32), sr, x32).to(torch.bfloat16)
