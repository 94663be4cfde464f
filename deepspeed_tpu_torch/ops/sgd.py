"""SGD with momentum over lists of fp32 tensors.

The TPU package's optimizer table builds ``optax.sgd(lr, momentum)``
(``deepspeed_tpu/runtime/engine.py:391-393``); this is its math with
``torch._foreach_*`` ops::

    trace = g + momentum trace;  p -= lr(count) trace

no dampening, no Nesterov, no weight decay. As in optax's
``scale_by_schedule``, a scheduled learning rate is read at the step count
*before* the step (0 for the first), where Adam, LAMB and Adagrad read it
after (1 for the first).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .adam import ForeachOptimizer, LearningRate


class SGD(ForeachOptimizer):
    """SGD state (``count``, ``trace``) and update; the trace is kept at
    momentum 0 too, as optax keeps it."""

    STATE = ("trace",)

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: LearningRate = 1e-3, momentum: float = 0.0,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(params, learning_rate, state_dtype)
        self.momentum = momentum

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.lr_at(self.count)
        self.count += 1
        grads = [g.to(t.dtype) for g, t in zip(grads, self.trace)]
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        upd = [t.to(p.dtype) for t, p in zip(self.trace, self.params)]
        torch._foreach_add_(self.params, upd, alpha=-lr)


def sgd(params: Sequence[torch.Tensor], learning_rate=1e-3,
        momentum: float = 0.0,
        state_dtype: torch.dtype = torch.float32) -> SGD:
    """``optax.sgd(learning_rate, momentum)``'s signature, over ``params``."""
    return SGD(params, learning_rate, momentum, state_dtype)
