"""Flash attention, forward and backward, for training.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The Pallas
kernels ``_fwd_kernel`` (B1), ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
(B1b) become the CUDA kernels in ``csrc/flash_attention.cu``, f32 online
softmax in each: bf16 and fp16 inputs take Hopper kernels (wgmma products
on tiles that a producer warp streams in with TMA through a shared-memory
ring; p and ds rounded to the input type in between), f32 inputs exact
CUDA-core FMAs (see the source for the design). Head dims 32, 64, 80, 96,
128 (the 16-bit kernels run 80 as 96 with zero-filled columns).

Layout is the TPU package's, ``[B, S, H, D]``; the kernels read q/k/v/dO
through their strides, so the views of a fused qkv projection need no copy.
The forward returns ``out`` in the input dtype and ``lse [B, H, S]`` in f32;
the backward recomputes each tile from ``lse`` and
``delta = rowsum(dO * out)``, which is a torch op here as it is an XLA op
outside Pallas in the TPU package.

:func:`flash_attention` is the entry (a :class:`FlashAttention`
``autograd.Function``). A CUDA tensor launches the kernels; a CPU tensor runs
the plain versions (:func:`flash_attention_forward_reference`,
:func:`flash_attention_backward_reference`), which compute the same
equations as the TPU kernels, ``l_safe`` included. On a CUDA tensor a head
dim or dtype the kernels lack raises; nothing gives way to an einsum. Unlike
the TPU ``flash_attention``, which falls back to the XLA einsum when no tile
>= 128 divides S > 1024 (``_pick_block``), the kernels take every S (tail
tiles are masked), so the port stays on the flash path there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30        # the TPU kernels' mask value

_KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_supported(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this head dim and dtype."""
    return d in _KERNEL_HEAD_DIMS and dtype in _KERNEL_DTYPES


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """f32 ``q k^T * scale`` [B, H, Sq, Sk], -1e30 above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * out)`` in f32, [B, H, S]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_forward_reference(q, k, v, causal: bool, scale: float
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``_fwd_kernel``'s equations over one tile.
    Returns (out [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    s = _scores(q, k, causal, scale)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = acc / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal: bool,
                                       scale: float, delta=None):
    """The plain backward: the equations of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``. Returns (dq, dk, dv) in the inputs' dtype.
    ``delta`` defaults to :func:`attention_delta` of ``out`` and ``dout``."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    if delta is None:
        delta = attention_delta(out, dout)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _check(q, *others) -> None:
    b, s, h, d = q.shape
    if not flash_supported(d, q.dtype):
        raise ValueError(
            f"flash kernels take d in {_KERNEL_HEAD_DIMS} and f32/bf16/fp16; "
            f"got d={d} {q.dtype}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"q/k/v/dO must share shape, dtype and device: "
                f"{tuple(q.shape)} {q.dtype} {q.device} vs {tuple(t.shape)} "
                f"{t.dtype} {t.device}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides
    (channels contiguous, 16-byte aligned rows, no stride 0 across a
    dimension longer than 1, as the TMA tensor maps need), else a
    contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 and (st > 0 or n == 1)
                    for st, n in zip(t.stride()[:3], t.shape[:3]))):
        return t
    return t.contiguous()


def _stride_array(*ts) -> ctypes.Array:
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_forward(q, k, v, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, causal, scale)
    _check(q, k, v)
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dstorch_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _stride_array(q, k, v), b, s, h, d, int(causal),
            float(scale), _KERNEL_DTYPES[q.dtype], _build.stream_of(q))
    _build.check(err, "flash_fwd")
    _build.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool,
                             scale: float, delta=None):
    """(dq, dk, dv): the two kernels for a CUDA tensor, the plain version
    for a CPU tensor. ``delta`` [B, H, S] f32 defaults to
    :func:`attention_delta` of ``out`` and ``dout``; a caller that runs
    several blocks of one softmax row (ring attention) passes the row's
    own, with its ``lse``, and ``out`` is then not read."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  causal, scale, delta)
    _check(q, k, v, dout)
    q, k, v, dout = _strided(q), _strided(k), _strided(v), _strided(dout)
    b, s, h, d = q.shape
    if delta is None:
        delta = attention_delta(out, dout)
    delta, lse = delta.contiguous(), lse.contiguous()
    dq, dk, dv = (torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    strides = _stride_array(q, k, v, dout)
    args = (b, s, h, d, int(causal), float(scale), _KERNEL_DTYPES[q.dtype],
            _build.stream_of(q))
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dstorch_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), strides, *args)
        _build.check(err, "flash_bwd_dq")
        _build.LAUNCHES["flash_bwd_dq"] += 1
        err = lib.dstorch_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            strides, *args)
    _build.check(err, "flash_bwd_dkv")
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``out = softmax(q k^T * scale) v`` with the flash forward and
    backward. Saves q, k, v, out and lse; re-entrant under
    ``torch.utils.checkpoint`` (a recomputed block runs the forward
    again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention. q, k, v: [B, S, H, D] -> [B, S, H, D]."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, scale)
