"""Fused LAMB over lists of fp32 tensors.

Counterpart of ``deepspeed_tpu/ops/lamb.py`` (reference:
``csrc/lamb/fused_lamb_cuda_kernel.cu`` via ``ops/lamb/fused_lamb.py``).
The Adam direction of :class:`~.adam.FusedAdam` scaled per tensor by the
trust ratio ``||w|| / ||u||`` (clipped to ``[min_coeff, max_coeff]``, 1
where either norm is 0), with ``torch._foreach_*`` ops and no host read.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .adam import FusedAdam


class FusedLamb(FusedAdam):
    """LAMB state (``count``, ``mu``, ``nu``) and update.

    Each tensor's norms come from sums of squares. When ``params`` are this
    rank's ZeRO slices, ``norm_reduce`` sums the ``[n_tensors, 2]`` tensor
    of partial sums (of w², of u²) over the ranks in one call, so every
    rank scales by the whole tensor's trust ratio."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate=1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0, max_coeff: float = 10.0,
                 min_coeff: float = 0.01, bias_correction: bool = True,
                 state_dtype: torch.dtype = torch.float32,
                 norm_reduce: Optional[Callable] = None):
        super().__init__(params, learning_rate, betas, eps, weight_decay,
                         True, bias_correction, state_dtype)
        self.max_coeff, self.min_coeff = max_coeff, min_coeff
        self.norm_reduce = norm_reduce

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        upd = self._moments(grads)
        lr = self.lr_at(self.count)
        w = [p.float() for p in self.params]
        sq = torch.stack([torch.stack(torch._foreach_norm(w)),
                          torch.stack(torch._foreach_norm(upd))], dim=1)
        sq = sq.square()
        if self.norm_reduce is not None:
            sq = self.norm_reduce(sq)
        w_norm, u_norm = sq.sqrt().unbind(1)
        trust = torch.where(
            (w_norm > 0) & (u_norm > 0),
            (w_norm / u_norm).clamp(self.min_coeff, self.max_coeff), 1.0)
        torch._foreach_mul_(upd, list(trust.unbind()))
        upd = [u.to(p.dtype) for u, p in zip(upd, self.params)]
        torch._foreach_add_(self.params, upd, alpha=-lr)


def fused_lamb(params: Sequence[torch.Tensor], learning_rate=1e-3,
               betas=(0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01, bias_correction: bool = True,
               state_dtype: torch.dtype = torch.float32,
               norm_reduce: Optional[Callable] = None) -> FusedLamb:
    """The TPU package's ``fused_lamb`` signature, over ``params``."""
    return FusedLamb(params, learning_rate, betas, eps, weight_decay,
                     max_coeff, min_coeff, bias_correction, state_dtype,
                     norm_reduce)
