"""Host-side (CPU) Adam / Adagrad over flat fp32 tensors: the ZeRO-Offload
optimizer.

Counterpart of ``deepspeed_tpu/ops/cpu_adam.py`` (reference
``deepspeed/ops/adam/cpu_adam.py`` driving csrc/adam/cpu_adam.cpp, and
``ops/adagrad/cpu_adagrad.py``). The optimizer steps contiguous float32 CPU
tensors in place through the native SIMD library (``ops/cpu/csrc``, built
by ``ops/cpu/_build.py``); the Adam step can also write a bf16 mirror of
the updated params, the 16-bit copy the card reads back. The JAX package
falls back to numpy when its library is missing; here a failed build raises
(the plain torch Adam the tests compare against is not on this path).
"""

from __future__ import annotations

from typing import Optional

import torch

from .cpu import _build


def f32_to_bf16_bits(src: torch.Tensor, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Round-to-nearest-even fp32 -> bf16, bit for bit the conversion of
    ``ds_adam_step_bf16`` (and of the JAX package's ``f32_to_bf16_bits``),
    NaN payloads included: the native library's ``ds_f32_to_bf16``.
    Returns a bfloat16 CPU tensor (``out`` when given)."""
    src = src.detach().to("cpu", torch.float32).contiguous()
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16)
    _check("out", out, src.numel(), torch.bfloat16)
    _build.library().ds_f32_to_bf16(src.data_ptr(), out.data_ptr(),
                                     src.numel())
    return out


def _check(name: str, t: torch.Tensor, n: int, dtype=torch.float32) -> int:
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous() \
            or t.numel() != n:
        raise ValueError(
            f"{name}: need a contiguous {dtype} CPU tensor of {n} elements, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.data_ptr()


class DeepSpeedCPUAdam:
    """Fused Adam/AdamW over flat host fp32 tensors.

    ``step(params, grads, exp_avg, exp_avg_sq)`` updates params and both
    moments in place (grads are read only); with ``params_bf16`` it also
    writes the round-to-nearest-even bf16 mirror of the updated params.
    """

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self._lib = _build.library()

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
             params_bf16: Optional[torch.Tensor] = None,
             lr: Optional[float] = None, step: Optional[int] = None) -> None:
        if step is None:
            self.step_count += 1
            step = self.step_count
        lr = self.lr if lr is None else float(lr)
        b1, b2 = self.betas
        n = params.numel()
        ptrs = [_check("params", params, n), _check("grads", grads, n),
                _check("exp_avg", exp_avg, n),
                _check("exp_avg_sq", exp_avg_sq, n)]
        tail = (n, lr, b1, b2, self.eps, self.weight_decay,
                int(self.adamw_mode), step)
        if params_bf16 is not None:
            bf16 = _check("params_bf16", params_bf16, n, torch.bfloat16)
            self._lib.ds_adam_step_bf16(ptrs[0], bf16, *ptrs[1:], *tail)
        else:
            self._lib.ds_adam_step(*ptrs, *tail)


class DeepSpeedCPUAdagrad:
    """Fused Adagrad over flat host fp32 tensors (reference
    ops/adagrad/cpu_adagrad.py:141)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = _build.library()

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             exp_avg_sq: torch.Tensor, lr: Optional[float] = None) -> None:
        lr = self.lr if lr is None else float(lr)
        n = params.numel()
        self._lib.ds_adagrad_step(
            _check("params", params, n), _check("grads", grads, n),
            _check("exp_avg_sq", exp_avg_sq, n), n, lr, self.eps,
            self.weight_decay)


def omp_threads() -> int:
    """Threads the library's OpenMP regions run on."""
    return _build.library().ds_omp_max_threads()
