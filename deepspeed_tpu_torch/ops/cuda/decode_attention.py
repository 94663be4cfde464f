"""Dense KV-cache decode attention: read only each row's live prefix.

Counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``. The Pallas
kernel ``_decode_kernel`` becomes the CUDA kernel in
``csrc/decode_attention.cu`` (one thread block per (row, head), online
softmax over the row's own live prefix; see the source for its design).

The cache is stored flat, ``[b, S, h*d]``, as the TPU path stores it.
``decode_attention`` launches the kernel for a CUDA tensor and runs the plain
PyTorch version (:func:`decode_attention_reference`) for a CPU tensor; it
never falls back from one to the other. ``masked_cache_attention`` is the
masked-einsum attention the model's prefill uses, the TPU package's XLA path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)

# Widest query width (speculative k+1 verify) the kernel takes.
MAX_SPEC_S = 8
_KERNEL_HEAD_DIMS = (32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_supported(s: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this query width, head dim and cache dtype.
    :func:`decode_attention` raises on a CUDA tensor of any other shape."""
    return 1 <= s <= MAX_SPEC_S and d in _KERNEL_HEAD_DIMS \
        and dtype in _KERNEL_DTYPES


def masked_cache_attention(q, ck, cv, first_q_pos, scale):
    """Masked-einsum cache attention: q [b, s, h, d] with query i at absolute
    position ``first_q_pos + i`` (a scalar or a [b] tensor), ck/cv
    [b, S, h, d]; each query sees keys at positions <= its own. Softmax in f32, probabilities cast back to
    q's dtype, as the TPU package computes it."""
    S = ck.shape[1]
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, ck).float() * scale
    key_pos = torch.arange(S, device=q.device)[None, None, None, :]
    fq = torch.as_tensor(first_q_pos, device=q.device)
    if fq.dim() == 1:                               # per-row: [b, 1, s, 1]
        q_pos = (fq[:, None] + torch.arange(s, device=q.device)
                 )[:, None, :, None]
    else:
        q_pos = (fq + torch.arange(s, device=q.device))[None, None, :, None]
    logits = logits.masked_fill(key_pos > q_pos, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, cv)


def _as_cache_len(cache_len, b: int, S: int, device) -> torch.Tensor:
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(clen, (b,)).clamp(0, S)


def decode_attention_reference(q, cached_key, cached_value, cache_len,
                               scale: float):
    """The plain version: the masked einsum over the whole cache, with a
    query that sees no key returning zeros, as the kernel does. Caches are
    flat [b, S, h*d] (or [b, S, h, d])."""
    b, s_q, h, d = q.shape
    S = cached_key.shape[1]
    clen = _as_cache_len(cache_len, b, S, q.device)
    ck = cached_key.reshape(b, S, h, d)
    cv = cached_value.reshape(b, S, h, d)
    first_q = clen - s_q
    out = masked_cache_attention(q, ck, cv, first_q, scale)
    # query i sees p < first_q + i + 1: none when that bound is <= 0
    sees = (first_q[:, None] + torch.arange(1, s_q + 1, device=q.device)) > 0
    return torch.where(sees[:, :, None, None], out, torch.zeros_like(out))


def decode_attention(q: torch.Tensor, cached_key: torch.Tensor,
                     cached_value: torch.Tensor, cache_len,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [b, s_q, h, d], 1 <= s_q <= 8. cached_key/value: the flat
    [b, S, h*d] cache (a rank-4 [b, S, h, d] cache is viewed flat).
    cache_len: valid positions per row including this call's s_q tokens, a
    scalar or [b]; entries past S (the serving engine's retired-lane
    sentinel) are clamped to S. Query i of a row with fill f attends to
    positions < f - (s_q - 1) + i. Returns [b, s_q, h, d] in q's dtype.

    A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`decode_attention_reference`. ``k_scale``/``v_scale`` (the int8
    cache's per-position scales) are not ported yet and raise."""
    b, s_q, h, d = q.shape
    S = cached_key.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    if q.device.type == "cpu":
        return decode_attention_reference(q, cached_key, cached_value,
                                          cache_len, scale)
    if not decode_supported(s_q, d, cached_key.dtype):
        raise ValueError(
            f"decode kernel takes s_q in 1..{MAX_SPEC_S}, d in "
            f"{_KERNEL_HEAD_DIMS}, f32/bf16; got s_q={s_q} d={d} "
            f"{cached_key.dtype}")
    if q.dtype != cached_key.dtype or cached_value.dtype != cached_key.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {cached_key.dtype} "
                         f"{cached_value.dtype}")
    kf = cached_key.reshape(b, S, h * d)
    vf = cached_value.reshape(b, S, h * d)
    for name, t in (("q", q), ("cached_key", kf), ("cached_value", vf)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    clen = _as_cache_len(cache_len, b, S, q.device).contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dstorch_decode_attention(
            q.data_ptr(), kf.data_ptr(), vf.data_ptr(), clen.data_ptr(),
            out.data_ptr(), b, s_q, h, d, S, float(scale),
            _KERNEL_DTYPES[q.dtype], _build.stream_of(q))
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
