"""Timers: the port's own copy of ``deepspeed_tpu/utils/timer.py``
(reference: deepspeed/utils/timer.py — SynchronizedWallClockTimer:35,
ThroughputTimer). A stop with ``sync`` waits for the card
(``torch.cuda.synchronize``) before reading the host clock, so the time
covers the device work and not only its launch."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from .logging import log_dist

#: A long run records one value per step forever; keep the rolling window
#: bounded (mean() becomes a moving average over the last N).
MAX_TIMER_RECORDS = 4096


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    def __init__(self, name: str, device=None,
                 max_records: int = MAX_TIMER_RECORDS):
        self.name = name
        self.device = device
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self._records: deque = deque(maxlen=max_records)

    def start(self, sync: bool = False):
        assert not self.started, f"timer {self.name} already started"
        if sync:
            synchronize(self.device)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, reset: bool = False, record: bool = False,
             sync: bool = False):
        assert self.started, f"timer {self.name} not started"
        if sync:
            synchronize(self.device)
        dt = time.perf_counter() - self._start
        self._elapsed = dt if reset else self._elapsed + dt
        if record:
            self._records.append(dt)
        self.started = False

    def reset(self):
        self.started = False
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        e = self._elapsed
        if reset:
            self.reset()
        return e

    def mean(self) -> float:
        return sum(self._records) / len(self._records) if self._records \
            else 0.0


class SynchronizedWallClockTimer:
    def __init__(self, device=None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}
        self._lock = threading.Lock()

    def __call__(self, name: str) -> _Timer:
        timer = self.timers.get(name)
        if timer is None:
            with self._lock:
                timer = self.timers.get(name)
                if timer is None:
                    timer = self.timers[name] = _Timer(name, self.device)
        return timer

    def has_timer(self, name) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, ranks=None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                parts.append(f"{name}: {ms:.2f}")
        log_dist("time (ms) | " + " | ".join(parts), ranks=ranks or [0])

    def memory_usage(self) -> str:
        if self.device is None or torch.device(self.device).type != "cuda":
            return "mem stats unavailable (not on a CUDA device)"
        used = torch.cuda.memory_allocated(self.device) / 2 ** 30
        peak = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        return f"mem used {used:.2f} GB, peak {peak:.2f} GB"


class ThroughputTimer:
    """Samples/sec across steps (skips warmup steps)."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, logging_fn=None, device=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda m: log_dist(m, ranks=[0]))
        self.device = device
        self.global_step_count = 0
        self.counted_steps = 0
        self.total_elapsed_time = 0.0
        self._pending_time = 0.0
        self._pending_steps = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync: bool = False, report_speed: bool = True):
        """Without ``sync`` the measured time is launch-only (the card may
        still be working); such steps are held pending and folded into the
        window that ends at the next synced stop, so
        ``avg_samples_per_sec`` never divides by an under-measured clock."""
        if self._t0 is None:
            return
        if sync:
            synchronize(self.device)
        self.global_step_count += 1
        if self.global_step_count > self.start_step:
            self._pending_time += time.perf_counter() - self._t0
            self._pending_steps += 1
            if sync:
                self.total_elapsed_time += self._pending_time
                self.counted_steps += self._pending_steps
                self._pending_time = 0.0
                self._pending_steps = 0
            if report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                self.logging(f"step={self.global_step_count}, "
                             f"samples/sec={self.avg_samples_per_sec():.2f}")
        self._t0 = None

    def avg_samples_per_sec(self) -> float:
        if self.counted_steps <= 0 or self.total_elapsed_time == 0:
            return 0.0
        return self.counted_steps * self.batch_size / self.total_elapsed_time
