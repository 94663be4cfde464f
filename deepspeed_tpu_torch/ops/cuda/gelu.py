"""Fused bias + GELU (tanh approximation), forward and backward.

Counterpart of ``deepspeed_tpu/ops/pallas/gelu.py``. The Pallas kernels
``_fwd_kernel`` and ``_bwd_kernel`` (B7) become the CUDA kernels in
``csrc/gelu.cu``: a grid-stride elementwise loop, ``x + bias`` and the tanh
in f32, 16-byte vectors where the row width allows.

:func:`bias_gelu` is the entry (a :class:`BiasGelu` ``autograd.Function``);
:func:`gelu` is ``bias_gelu`` with a zero bias. The backward's ``dx`` is the
kernel, in x's dtype; ``dbias`` is the f32 sum of that rounded ``dx`` across
rows, cast to the bias dtype, as in the TPU package (``gelu.py:76-84``).

A CUDA tensor launches the kernels; a CPU tensor runs the plain versions
(:func:`bias_gelu_forward_reference`, :func:`bias_gelu_backward_reference`),
which hold the kernels' equations. On a CUDA tensor a dtype the kernels lack
raises. Unlike the TPU ``bias_gelu``, which leaves Pallas for
``jax.nn.gelu(x + bias, approximate=True)`` in x's dtype when no row block
>= 8 divides the row count, the kernels take every row count.
"""

from __future__ import annotations

import torch

from . import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SQRT_2_OVER_PI = 0.7978845608028654


def _tanh_term(u: torch.Tensor) -> torch.Tensor:
    return torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * (u * u * u)))


def bias_gelu_forward_reference(x2: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """The plain forward: ``_fwd_kernel``'s ``gelu(x + bias)`` in f32,
    rounded to x's dtype."""
    u = x2.float() + bias.float()
    return (0.5 * u * (1.0 + _tanh_term(u))).to(x2.dtype)


def bias_gelu_backward_reference(x2: torch.Tensor, bias: torch.Tensor,
                                 dy2: torch.Tensor) -> torch.Tensor:
    """The plain backward: ``_bwd_kernel``'s ``gelu'(x + bias) dy`` in f32,
    rounded to x's dtype."""
    u = x2.float() + bias.float()
    t = _tanh_term(u)
    dt = (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * u * u)
    return ((0.5 * (1.0 + t) + 0.5 * u * dt) * dy2.float()).to(x2.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _bias_f32(x2: torch.Tensor, bias: torch.Tensor) -> int:
    if x2.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"bias_gelu kernels take f32/bf16/fp16; got "
                         f"{x2.dtype}")
    d = x2.shape[-1]
    if (bias.shape != (d,) or bias.device != x2.device
            or bias.dtype not in (torch.float32, x2.dtype)):
        raise ValueError(
            f"bias_gelu kernels take a bias of shape ({d},) on {x2.device} "
            f"in f32 or {x2.dtype}; got {tuple(bias.shape)} {bias.dtype} "
            f"{bias.device}")
    return int(bias.dtype == torch.float32)


def _launch(name: str, x2, bias, dy2=None) -> torch.Tensor:
    bias_f32 = _bias_f32(x2, bias)
    x2, bias = x2.contiguous(), bias.contiguous()
    out = torch.empty_like(x2)
    args = (x2.numel(), x2.shape[-1], _KERNEL_DTYPES[x2.dtype], bias_f32,
            _build.stream_of(x2))
    lib = _build.library()
    with torch.cuda.device(x2.device):
        if dy2 is None:
            err = lib.dstorch_bias_gelu_fwd(x2.data_ptr(), bias.data_ptr(),
                                            out.data_ptr(), *args)
        else:
            if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
                raise ValueError(f"dy {tuple(dy2.shape)} {dy2.dtype} must "
                                 f"match x {tuple(x2.shape)} {x2.dtype}")
            dy2 = dy2.contiguous()
            err = lib.dstorch_bias_gelu_bwd(x2.data_ptr(), bias.data_ptr(),
                                            dy2.data_ptr(), out.data_ptr(),
                                            *args)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def bias_gelu_forward(x2: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(x + bias)`` over ``x2 [n, d]``: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x2.device.type == "cpu":
        return bias_gelu_forward_reference(x2, bias)
    return _launch("bias_gelu_fwd", x2, bias)


def bias_gelu_backward(x2: torch.Tensor, bias: torch.Tensor,
                       dy2: torch.Tensor) -> torch.Tensor:
    """``gelu'(x + bias) dy``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x2.device.type == "cpu":
        return bias_gelu_backward_reference(x2, bias, dy2)
    return _launch("bias_gelu_bwd", x2, bias, dy2)


class BiasGelu(torch.autograd.Function):
    """``gelu(x + bias)`` (tanh approximation) with the B7 kernels."""

    @staticmethod
    def forward(ctx, x, bias):
        x2 = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(x2, bias)
        ctx.shape = x.shape
        return bias_gelu_forward(x2, bias).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, bias = ctx.saved_tensors
        dx = bias_gelu_backward(x2, bias, dy.reshape(x2.shape))
        dbias = dx.float().sum(0).to(bias.dtype)
        return dx.view(ctx.shape), dbias


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """gelu(x + bias) fused. x: [..., D]; bias: [D]."""
    return BiasGelu.apply(x, bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Unfused-bias variant (zero bias in x's dtype)."""
    return bias_gelu(x, torch.zeros(x.shape[-1], dtype=x.dtype,
                                    device=x.device))
