"""LR schedules: the port's own copy of
``deepspeed_tpu/runtime/lr_schedules.py`` (reference:
deepspeed/runtime/lr_schedules.py — ``LRRangeTest``:310, ``OneCycle``:417,
``WarmupLR``:706, ``WarmupDecayLR``:802).

Each schedule is a stateful stepper (``.step()`` / ``.get_last_lr()``) and a
pure ``lr_at(step) -> float``. The engine reads ``lr_at`` at the optimizer's
step count, as the TPU engine folds it into its compiled step. Arithmetic is
in Python floats (the TPU package's is f32). The argparse helpers
(``add_tuning_arguments``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR"]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


class _Schedule:
    def __init__(self):
        self.last_step = 0

    def lr_at(self, step) -> float:
        raise NotImplementedError

    def __call__(self, step) -> float:
        return self.lr_at(step)

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_last_lr(self):
        return [self.lr_at(self.last_step)]

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]


class WarmupLR(_Schedule):
    """Linear (or log) warmup from min to max lr, then constant."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.last_step = max(0, last_batch_iteration)
        if warmup_type == "log":
            self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def lr_at(self, step) -> float:
        step = float(step)
        if self.warmup_type == "log":
            frac = self.inverse_log_warm_up * math.log(max(step, 1.0))
        else:
            frac = step / self.warmup_num_steps
        return self.min_lr + (self.max_lr - self.min_lr) * _clip(frac, 0., 1.)


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over total_num_steps."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000,
                 warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step) -> float:
        step = float(step)
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        decay = _clip((self.total_num_steps - step)
                      / max(1.0, self.total_num_steps - self.warmup_num_steps),
                      0.0, 1.0)
        return self.max_lr * decay


class LRRangeTest(_Schedule):
    """LR range test: staircase (or continuous) ramp by lr_range_test_step_rate
    every lr_range_test_step_size steps."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_step = max(0, last_batch_iteration)

    def lr_at(self, step) -> float:
        count = float(step) / self.step_size
        if self.staircase:
            count = math.floor(count)
        return self.min_lr * (1.0 + count * self.step_rate)


class OneCycle(_Schedule):
    """Cyclical lr (and momentum) in one cycle + decay phase. The stair
    counts quantize the up/down legs as the TPU package does (a deliberate
    divergence from the reference, noted in ADVICE.md)."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 1e-4,
                 cycle_max_lr: float = 1e-3, decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0,
                 cycle_momentum: bool = True, cycle_min_mom: float = 0.8,
                 cycle_max_mom: float = 0.9, decay_mom_rate: float = 0.0,
                 last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = cycle_min_lr
        self.max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = (cycle_second_step_size
                       if cycle_second_step_size is not None
                       else cycle_first_step_size)
        self.decay_step_size = max(1, decay_step_size)
        self.cycle_momentum = cycle_momentum
        self.min_mom = cycle_min_mom
        self.max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self.last_step = max(0, last_batch_iteration)
        self.total_size = self.first + self.second
        self.first_stairs = max(0, cycle_first_stair_count)
        self.second_stairs = (self.first_stairs
                              if cycle_second_stair_count is None
                              else max(0, cycle_second_stair_count))

    def _frac(self, step: float) -> float:
        up = _clip(step / self.first, 0.0, 1.0)
        down = _clip((step - self.first) / self.second, 0.0, 1.0)
        if self.first_stairs:
            up = math.floor(up * self.first_stairs) / self.first_stairs
        if self.second_stairs:
            down = math.floor(down * self.second_stairs) / self.second_stairs
        return up if step <= self.first else 1.0 - down

    def lr_at(self, step) -> float:
        step = float(step)
        if step <= self.total_size:
            return self.min_lr + (self.max_lr - self.min_lr) * self._frac(step)
        if self.decay_lr_rate <= 0:
            return self.min_lr
        decay_steps = (step - self.total_size) / self.decay_step_size
        return self.min_lr / (1.0 + decay_steps * self.decay_lr_rate)

    def mom_at(self, step) -> float:
        return self.max_mom - (self.max_mom - self.min_mom) \
            * self._frac(float(step))


SCHEDULE_REGISTRY = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
}


def build_lr_scheduler(sched_config, optimizer=None):
    if sched_config is None:
        return None
    cls = SCHEDULE_REGISTRY.get(sched_config.type)
    if cls is None:
        raise ValueError(f"unknown scheduler {sched_config.type!r}; "
                         f"valid: {sorted(SCHEDULE_REGISTRY)}")
    return cls(optimizer, **sched_config.params)
