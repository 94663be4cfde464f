"""Fused LayerNorm, forward and input gradient.

Counterpart of ``deepspeed_tpu/ops/pallas/layer_norm.py``. The Pallas
kernels ``_fwd_kernel`` and ``_dx_kernel`` (B6) become the CUDA kernels in
``csrc/layer_norm.cu``: f32 statistics, the variance in a second pass over
``x - mean`` as the TPU kernel takes it. Both kernels hold each row in
registers (one warp a row up to d = 1024, one block a row up to 16384, a
looping block beyond) and read and write it in 16-byte packs when d and the
pointers allow; dx reads x, dy and gamma once and takes its two sums in one
pass.

:func:`layer_norm` is the entry (a :class:`LayerNormFunction`
``autograd.Function``). The forward saves ``x`` and the f32 ``mean`` and
``rstd``, as ``_ln_fwd`` does; the backward's ``dx`` is the kernel, and
``dgamma``/``dbeta`` are torch reductions across rows (XLA reductions
outside Pallas in the TPU package), cast to gamma's dtype.

A CUDA tensor launches the kernels; a CPU tensor runs the plain versions
(:func:`layer_norm_forward_reference`, :func:`layer_norm_backward_reference`),
which hold the kernels' equations. On a CUDA tensor a dtype the kernels lack
raises. Unlike the TPU ``layer_norm``, which leaves Pallas for an XLA
expression when no row block >= 8 divides the row count, the kernels take
every row count.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_norm_forward_reference(x2: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor, eps: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The plain forward: ``_fwd_kernel``'s equations over rows of
    ``x2 [n, d]``. Returns (y in x's dtype, mean f32 [n], rstd f32 [n])."""
    x = x2.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean) * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_backward_reference(x2: torch.Tensor, gamma: torch.Tensor,
                                  mean: torch.Tensor, rstd: torch.Tensor,
                                  dy2: torch.Tensor) -> torch.Tensor:
    """The plain input gradient: ``_dx_kernel``'s equations. Returns dx in
    x's dtype."""
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    wdy = dy2.float() * gamma.float()
    c1 = wdy.mean(-1, keepdim=True)
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    return ((wdy - c1 - xhat * c2) * rstd[:, None]).to(x2.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _param_f32(x2: torch.Tensor, *params: torch.Tensor) -> int:
    """1 when gamma (and beta) are f32, 0 when they are x's dtype; raises on
    what the kernels lack."""
    if x2.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"layer_norm kernels take f32/bf16/fp16; got "
                         f"{x2.dtype}")
    d = x2.shape[-1]
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, x2.dtype} or any(
            p.shape != (d,) or p.device != x2.device for p in params):
        raise ValueError(
            f"layer_norm kernels take gamma and beta of shape ({d},) on "
            f"{x2.device}, both f32 or both {x2.dtype}; got "
            f"{[(tuple(p.shape), p.dtype, str(p.device)) for p in params]}")
    return int(params[0].dtype == torch.float32)


def layer_norm_forward(x2: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float):
    """(y, mean, rstd) over rows of ``x2 [n, d]``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x2.device.type == "cpu":
        return layer_norm_forward_reference(x2, gamma, beta, eps)
    param_f32 = _param_f32(x2, gamma, beta)
    x2, gamma, beta = x2.contiguous(), gamma.contiguous(), beta.contiguous()
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dstorch_layer_norm_fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, d, float(eps),
            _KERNEL_DTYPES[x2.dtype], param_f32, _build.stream_of(x2))
    _build.check(err, "layer_norm_fwd")
    _build.LAUNCHES["layer_norm_fwd"] += 1
    return y, mean, rstd


def layer_norm_dx(x2: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor, dy2: torch.Tensor) -> torch.Tensor:
    """dx over rows of ``x2 [n, d]``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x2.device.type == "cpu":
        return layer_norm_backward_reference(x2, gamma, mean, rstd, dy2)
    param_f32 = _param_f32(x2, gamma)
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"dy {tuple(dy2.shape)} {dy2.dtype} must match x "
                         f"{tuple(x2.shape)} {x2.dtype}")
    x2, gamma, dy2 = x2.contiguous(), gamma.contiguous(), dy2.contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    n, d = x2.shape
    dx = torch.empty_like(x2)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dstorch_layer_norm_dx(
            x2.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), n, d, _KERNEL_DTYPES[x2.dtype],
            param_f32, _build.stream_of(x2))
    _build.check(err, "layer_norm_dx")
    _build.LAUNCHES["layer_norm_dx"] += 1
    return dx


class LayerNormFunction(torch.autograd.Function):
    """``y = (x - mean) rstd gamma + beta`` over the last dim, with the B6
    forward and dx kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        x2 = x.reshape(-1, x.shape[-1])
        y, mean, rstd = layer_norm_forward(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape)
        dx = layer_norm_dx(x2, gamma, mean, rstd, dy2)
        # parameter grads: torch reductions across rows from f32 xhat and dy
        xhat = (x2.float() - mean[:, None]) * rstd[:, None]
        dyf = dy2.float()
        dgamma = (dyf * xhat).sum(0).to(gamma.dtype)
        dbeta = dyf.sum(0).to(gamma.dtype)
        return dx.view(ctx.shape), dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layer norm over the last dim. x: [..., D]; gamma/beta: [D]."""
    return LayerNormFunction.apply(x, gamma, beta, eps)
