"""Fused (masked) softmax, forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/softmax.py``. The Pallas kernels
``_fwd_kernel`` and ``_bwd_kernel`` (B8) become the CUDA kernels in
``csrc/softmax.cu``: one warp per row up to 1024 columns, one block per
wider row, max and sum in f32. The forward holds each row in registers (up
to 16384 columns) and reads and writes it in 16-byte packs when the width
and the pointers allow.

:func:`fused_softmax` is the entry (a :class:`FusedSoftmax`
``autograd.Function``): softmax over the last dim of ``x [..., Sq, S]``,
with an optional causal mask that sets ``x[.., i, j]`` to -1e30 where
``j > i`` (row index taken modulo ``x.shape[-2]``, so a non-square score
matrix is aligned top-left, as the TPU kernel aligns it). The backward
reads the saved, rounded ``y``: ``dx = y (dy - sum(y dy))``.
:func:`masked_softmax` scales and adds an additive mask with torch ops
first, as the TPU package does.

A CUDA tensor launches the kernels; a CPU tensor runs the plain versions
(:func:`softmax_forward_reference`, :func:`softmax_backward_reference`),
which hold the kernels' equations. On a CUDA tensor a dtype the kernels lack
raises. Unlike the TPU ``fused_softmax``, which leaves Pallas for
``jax.nn.softmax`` (with a ``-inf`` square causal mask) when no row block
>= 8 divides the row count, the kernels take every row count and every
``Sq``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30        # the TPU kernel's mask value
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rows_per_matrix(shape) -> int:
    return shape[-2] if len(shape) >= 2 else 1


def softmax_forward_reference(x2: torch.Tensor, sq: int,
                              causal: bool) -> torch.Tensor:
    """The plain forward: ``_fwd_kernel``'s equations over rows of
    ``x2 [n, s]`` (row r of score matrix row ``r mod sq``). Returns y in
    x's dtype."""
    x = x2.float()
    if causal:
        n, s = x.shape
        rows = torch.arange(n, device=x.device)[:, None] % sq
        cols = torch.arange(s, device=x.device)[None, :]
        x = torch.where(rows >= cols, x, NEG_INF)
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    return (p / p.sum(-1, keepdim=True)).to(x2.dtype)


def softmax_backward_reference(y2: torch.Tensor,
                               dy2: torch.Tensor) -> torch.Tensor:
    """The plain backward: ``_bwd_kernel``'s ``y (dy - sum(y dy))`` in f32,
    rounded to dy's dtype."""
    y, dy = y2.float(), dy2.float()
    dot = (y * dy).sum(-1, keepdim=True)
    return (y * (dy - dot)).to(dy2.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _check_dtype(t: torch.Tensor) -> None:
    if t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"softmax kernels take f32/bf16/fp16; got {t.dtype}")


def softmax_forward(x2: torch.Tensor, sq: int, causal: bool) -> torch.Tensor:
    """y over rows of ``x2 [n, s]``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x2.device.type == "cpu":
        return softmax_forward_reference(x2, sq, causal)
    _check_dtype(x2)
    x2 = x2.contiguous()
    n, s = x2.shape
    y = torch.empty_like(x2)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dstorch_softmax_fwd(x2.data_ptr(), y.data_ptr(), n, s, sq,
                                      int(causal), _KERNEL_DTYPES[x2.dtype],
                                      _build.stream_of(x2))
    _build.check(err, "softmax_fwd")
    _build.LAUNCHES["softmax_fwd"] += 1
    return y


def softmax_backward(y2: torch.Tensor, dy2: torch.Tensor) -> torch.Tensor:
    """dx over rows of ``y2 [n, s]``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if y2.device.type == "cpu":
        return softmax_backward_reference(y2, dy2)
    _check_dtype(y2)
    if dy2.shape != y2.shape or dy2.dtype != y2.dtype:
        raise ValueError(f"dy {tuple(dy2.shape)} {dy2.dtype} must match y "
                         f"{tuple(y2.shape)} {y2.dtype}")
    y2, dy2 = y2.contiguous(), dy2.contiguous()
    n, s = y2.shape
    dx = torch.empty_like(y2)
    lib = _build.library()
    with torch.cuda.device(y2.device):
        err = lib.dstorch_softmax_bwd(y2.data_ptr(), dy2.data_ptr(),
                                      dx.data_ptr(), n, s,
                                      _KERNEL_DTYPES[y2.dtype],
                                      _build.stream_of(y2))
    _build.check(err, "softmax_bwd")
    _build.LAUNCHES["softmax_bwd"] += 1
    return dx


class FusedSoftmax(torch.autograd.Function):
    """Softmax over the last dim, optionally causal, with the B8 kernels.
    Saves the output y."""

    @staticmethod
    def forward(ctx, x, causal: bool):
        x2 = x.reshape(-1, x.shape[-1])
        y2 = softmax_forward(x2, _rows_per_matrix(x.shape), causal)
        ctx.save_for_backward(y2)
        ctx.shape = x.shape
        return y2.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        (y2,) = ctx.saved_tensors
        dx = softmax_backward(y2, dy.reshape(y2.shape))
        return dx.view(ctx.shape), None


def fused_softmax(x: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Softmax over the last dim with optional causal (triangular) masking
    of ``[..., Sq, S]`` score matrices."""
    return FusedSoftmax.apply(x, causal)


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: float = 1.0) -> torch.Tensor:
    """Reference ``attn_softmax`` semantics: optional pre-scale and additive
    mask (torch ops), then :func:`fused_softmax`."""
    if scale != 1.0:
        x = x * scale
    if mask is not None:
        x = x + mask
    return fused_softmax(x, causal)
