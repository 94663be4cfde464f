"""Serving counters: the port's counterpart of ``deepspeed_tpu/serving/metrics.py``.

``Reservoir`` is a copy; ``ServingMetrics`` keeps the counters and the
snapshot. The monitor fan-out (CSV / TensorBoard writers) is not ported yet,
so nothing is emitted: callers read :meth:`ServingMetrics.snapshot`.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Sequence


class Reservoir:
    """Fixed-size uniform reservoir (Vitter's algorithm R) for streaming
    percentile estimates: exact under ``capacity`` observations, an unbiased
    sample past it. Host-side only; seeded so runs are reproducible."""

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self.values: List[float] = []
        self.n_seen = 0
        self.total = 0.0        # running sum over ALL seen (not the sample)

    def add(self, x: float) -> None:
        self.n_seen += 1
        self.total += float(x)
        if len(self.values) < self.capacity:
            self.values.append(float(x))
        else:
            j = self._rng.randrange(self.n_seen)
            if j < self.capacity:
                self.values[j] = float(x)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile over the sample, q in [0, 100]
        (clamped); 0.0 when empty."""
        if not self.values:
            return 0.0
        xs = sorted(self.values)
        if len(xs) == 1:
            return xs[0]
        q = min(100.0, max(0.0, float(q)))
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[float, float]:
        return {q: self.percentile(q) for q in qs}


class ServingMetrics:
    """Aggregates serving counters. ``clock`` is injectable for tests."""

    def __init__(self, *, clock=time.perf_counter):
        self.clock = clock
        self.t0: Optional[float] = None
        self.tokens_out = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.requests_done = 0
        self.rejected = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self.ttft_reservoir = Reservoir()
        self.prefill_prompt_tokens = 0
        self.prefill_padded_tokens = 0
        self.prefill_programs = 0

    # ----------------------------------------------------------- recording
    def start(self) -> None:
        if self.t0 is None:
            self.t0 = self.clock()

    def on_tokens(self, n: int) -> None:
        self.tokens_out += int(n)

    def on_decode_step(self, seconds: float = 0.0) -> None:
        """One decode chunk retired; ``seconds`` is its launch-to-sync wall
        time."""
        self.decode_steps += 1
        self.decode_seconds += float(seconds)

    def on_finished(self, requests) -> None:
        for req in requests:
            self.requests_done += 1
            if req.ttft_s is not None:
                self._ttft_sum += req.ttft_s
                self._ttft_n += 1
                self.ttft_reservoir.add(req.ttft_s)

    def on_rejected(self, n: int = 1) -> None:
        self.rejected += int(n)

    def on_prefill(self, n_prompts: int, bucket_len: int,
                   prompt_tokens: int, n_programs: int) -> None:
        """One batched bucketed prefill: ``n_prompts`` prompts padded to
        ``bucket_len``; ``n_programs`` counts the distinct (batch, bucket)
        shapes seen so far."""
        self.prefill_prompt_tokens += int(prompt_tokens)
        self.prefill_padded_tokens += int(n_prompts) * int(bucket_len)
        self.prefill_programs = int(n_programs)

    # ------------------------------------------------------------ reading
    @property
    def padding_waste(self) -> float:
        """Fraction of padded prefill positions that carried no prompt
        token (0.0 before the first prefill)."""
        if not self.prefill_padded_tokens:
            return 0.0
        return 1.0 - self.prefill_prompt_tokens / self.prefill_padded_tokens

    @property
    def mean_ttft_s(self) -> float:
        return self._ttft_sum / self._ttft_n if self._ttft_n else 0.0

    @property
    def mean_decode_chunk_s(self) -> float:
        return (self.decode_seconds / self.decode_steps
                if self.decode_steps else 0.0)

    def tokens_per_s(self) -> float:
        if self.t0 is None:
            return 0.0
        dt = self.clock() - self.t0
        return self.tokens_out / dt if dt > 0 else 0.0

    def snapshot(self, queue_depth: int, occupancy: float) -> Dict[str, float]:
        pct = self.ttft_reservoir.percentiles((50, 95, 99))
        return {
            "serving/tokens_per_s": self.tokens_per_s(),
            "serving/ttft_s": self.mean_ttft_s,
            "serving/ttft_p50_s": pct[50],
            "serving/ttft_p95_s": pct[95],
            "serving/ttft_p99_s": pct[99],
            "serving/decode_chunk_s": self.mean_decode_chunk_s,
            "serving/queue_depth": float(queue_depth),
            "serving/slot_occupancy": float(occupancy),
            "serving/requests_done": float(self.requests_done),
            "serving/rejected_total": float(self.rejected),
            "serving/prefill_padding_waste": float(self.padding_waste),
            "serving/prefill_programs": float(self.prefill_programs),
        }
