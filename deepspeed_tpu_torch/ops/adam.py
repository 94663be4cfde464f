"""Fused Adam/AdamW and Adagrad over lists of fp32 tensors.

Counterpart of ``deepspeed_tpu/ops/adam.py`` (reference analogues:
``csrc/adam/multi_tensor_adam.cu`` + ``ops/adam/fused_adam.py``,
``ops/adagrad/cpu_adagrad.py``). The "fusion" is PyTorch's multi-tensor
``torch._foreach_*`` ops: one launch per op over every tensor of a dtype,
not one per parameter. The update is in place: the engine owns the fp32
master params (or, under ZeRO-1 over dp > 1, this rank's flat slices of
them) and hands the same list on every step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


class ForeachOptimizer:
    """Shared state handling: the step ``count``, one list of moment
    tensors per name in ``STATE`` (zeros like ``params``, in
    ``state_dtype``), ``state_dict()`` / ``load_state_dict()``.
    ``learning_rate`` is a float or a function of the step count."""

    STATE: tuple = ()

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: LearningRate,
                 state_dtype: torch.dtype = torch.float32):
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate = learning_rate
        self.count = 0
        for name in self.STATE:
            setattr(self, name, [torch.zeros_like(p, dtype=state_dtype)
                                 for p in self.params])

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def state_dict(self) -> Dict:
        return {"count": self.count,
                **{name: getattr(self, name) for name in self.STATE}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy ``state`` (as :meth:`state_dict` gives it) into this
        optimizer's tensors, in place."""
        self.count = int(state["count"])
        for name in self.STATE:
            mine = getattr(self, name)
            if len(state[name]) != len(mine):
                raise ValueError(f"{name}: {len(state[name])} tensors, the "
                                 f"optimizer has {len(mine)}")
            for dst, src in zip(mine, state[name]):
                dst.copy_(torch.as_tensor(src).view_as(dst))


class FusedAdam(ForeachOptimizer):
    """Adam state (``count``, ``mu``, ``nu``) over ``params`` and its update.

    ``step(grads)`` applies, per tensor, exactly the TPU package's math::

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
        step = (mu / c1) / (sqrt(nu / c2) + eps) + wd p
        p -= lr(count) step

    with ``c1 = 1 - b1^count``, ``c2 = 1 - b2^count`` (both 1 without bias
    correction) and ``eps`` outside the sqrt. ``adam_w_mode=False`` adds the
    same ``wd p`` to the step as AdamW does: the TPU package approximates
    classic L2 decay that way (its ``fused_adam``), and the port matches it
    rather than the reference's decay folded into the gradient.
    """

    STATE = ("mu", "nu")

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: LearningRate = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(params, learning_rate, state_dtype)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def _moments(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Advance the count and the moments; returns the Adam direction
        ``(mu / c1) / (sqrt(nu / c2) + eps) + wd p`` in the state dtype."""
        self.count += 1
        b1, b2 = self.b1, self.b2
        grads = [g.to(m.dtype) for g, m in zip(grads, self.mu)]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        if self.bias_correction:
            c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        else:
            c1 = c2 = 1.0
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            params = [p.to(u.dtype) for p, u in zip(self.params, upd)]
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        return upd

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        upd = self._moments(grads)
        lr = self.lr_at(self.count)
        upd = [u.to(p.dtype) for u, p in zip(upd, self.params)]
        torch._foreach_add_(self.params, upd, alpha=-lr)


def fused_adam(params: Sequence[torch.Tensor], learning_rate=1e-3,
               betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True,
               state_dtype: torch.dtype = torch.float32) -> FusedAdam:
    """The TPU package's ``fused_adam`` signature, over ``params``."""
    return FusedAdam(params, learning_rate, betas, eps, weight_decay,
                     adam_w_mode, bias_correction, state_dtype)


class FusedAdagrad(ForeachOptimizer):
    """Adagrad (``count``, ``accum``), the TPU package's math::

        accum += g^2;  p -= lr(count) (g / (sqrt(accum) + eps) + wd p)
    """

    STATE = ("accum",)

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: LearningRate = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(params, learning_rate, state_dtype)
        self.eps = eps
        self.weight_decay = weight_decay

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        lr = self.lr_at(self.count)
        grads = [g.to(a.dtype) for g, a in zip(grads, self.accum)]
        torch._foreach_addcmul_(self.accum, grads, grads)
        denom = torch._foreach_sqrt(self.accum)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(grads, denom)
        if self.weight_decay:
            params = [p.to(u.dtype) for p, u in zip(self.params, upd)]
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        upd = [u.to(p.dtype) for u, p in zip(upd, self.params)]
        torch._foreach_add_(self.params, upd, alpha=-lr)


def fused_adagrad(params: Sequence[torch.Tensor], learning_rate=1e-2,
                  eps: float = 1e-10, weight_decay: float = 0.0,
                  state_dtype: torch.dtype = torch.float32) -> FusedAdagrad:
    """The TPU package's ``fused_adagrad`` signature, over ``params``."""
    return FusedAdagrad(params, learning_rate, eps, weight_decay,
                        state_dtype)
