"""The sampling policy for serving: filter + draw.

Counterpart of ``deepspeed_tpu/serving/sampling.py``. ``filter_logits`` /
``sample_tokens`` are the sort-based reference; ``fused_filter_logits`` /
``fused_sample_tokens`` route to the sort-free epilogue
(``ops/cuda/sampling.py``) when ``sampling_supported`` says the vocab shape
fits it, and to the reference otherwise -- the TPU router's rule. Greedy
draws are bit-identical either way; temperature > 0 draws take Gumbel noise
from the caller's ``torch.Generator`` instead of a categorical draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cuda.sampling import (fused_sample, sampling_supported,
                                 threshold_filter_logits)


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int],
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature / top-k / nucleus filtering over [..., V] logits in f32;
    masked entries become -1e10. top-p keeps the smallest set of tokens whose
    cumulative probability reaches ``top_p`` (the argmax always survives),
    applied after top-k."""
    logits = logits.float()
    if temperature != 0.0:
        logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e10, logits)
    if top_p is not None:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep token i while the mass BEFORE it is < top_p
        keep = (cum - probs) < top_p
        kth = torch.where(keep, srt, torch.inf).min(dim=-1,
                                                    keepdim=True).values
        logits = torch.where(logits < kth, -1e10, logits)
    return logits


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator], temperature: float,
                  top_k: Optional[int],
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy (first-index argmax) or a categorical draw from the filtered
    [b, V] logits -> int32 [b]."""
    logits = filter_logits(logits, temperature, top_k, top_p)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U ~ uniform(tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def fused_filter_logits(logits: torch.Tensor, temperature: float,
                        top_k: Optional[int],
                        top_p: Optional[float] = None) -> torch.Tensor:
    """``filter_logits`` through the sort-free kernel when the vocab shape
    supports it, the reference otherwise. Accepts [..., V]."""
    shape = logits.shape
    rows = logits.numel() // shape[-1]
    if not sampling_supported(rows, shape[-1]):
        return filter_logits(logits, temperature, top_k, top_p)
    out = threshold_filter_logits(logits.reshape(rows, shape[-1]),
                                  temperature, top_k, top_p)
    return out.reshape(shape)


def fused_sample_tokens(logits: torch.Tensor,
                        generator: Optional[torch.Generator],
                        temperature: float, top_k: Optional[int],
                        top_p: Optional[float] = None) -> torch.Tensor:
    """``sample_tokens`` through the fused epilogue when supported (greedy
    stays bit-identical; temperature > 0 becomes Gumbel-max), the reference
    otherwise."""
    b, v = logits.shape
    if not sampling_supported(b, v):
        return sample_tokens(logits, generator, temperature, top_k, top_p)
    gumbel = None
    if temperature != 0.0:
        gumbel = gumbel_noise((b, v), generator, logits.device)
    return fused_sample(logits, gumbel, temperature, top_k, top_p)
