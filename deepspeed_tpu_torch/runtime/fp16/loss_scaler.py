"""Loss scaling: the port's own copy of
``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (reference:
deepspeed/runtime/fp16/loss_scaler.py — ``LossScaler``:54 static,
``DynamicLossScaler``:77).

The state is a small tuple of Python numbers and ``update_scale`` a pure
function of it, as in the TPU package. The engine reads the overflow flag
(:func:`grads_finite`, one device-to-host read per fp16 step) to skip the
step, as the reference does.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: float
    cur_hysteresis: int
    last_overflow_step: int
    step: int
    overflows: int                # total skipped steps


def make_loss_scale_state(static_scale: float = 0.0,
                          initial_scale_power: int = 16,
                          hysteresis: int = 2) -> LossScaleState:
    init = static_scale if static_scale > 0 else 2.0 ** initial_scale_power
    # the full hysteresis budget: the first overflow only decrements it
    return LossScaleState(cur_scale=float(init), cur_hysteresis=hysteresis,
                          last_overflow_step=-1, step=0, overflows=0)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """A bool tensor: every element of every grad is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_scale(state: LossScaleState, finite: bool,
                 dynamic: bool = True,
                 scale_factor: float = 2.0,
                 scale_window: int = 1000,
                 min_scale: float = 1.0,
                 hysteresis: int = 2) -> LossScaleState:
    """Overflow => scale /= factor (with hysteresis); ``scale_window`` clean
    steps => scale *= factor, which also restores the hysteresis budget."""
    finite = bool(finite)
    step = state.step + 1
    overflows = state.overflows + (not finite)
    if not dynamic:
        return state._replace(step=step, overflows=overflows)
    hys = state.cur_hysteresis if finite else max(state.cur_hysteresis - 1, 0)
    scale = state.cur_scale
    if not finite and state.cur_hysteresis <= 1:
        scale = max(scale / scale_factor, min_scale)
    since = step - state.last_overflow_step
    if finite and since % scale_window == 0 and since >= scale_window:
        scale *= scale_factor
        hys = hysteresis
    return LossScaleState(
        cur_scale=scale, cur_hysteresis=hys,
        last_overflow_step=state.last_overflow_step if finite else step,
        step=step, overflows=overflows)
