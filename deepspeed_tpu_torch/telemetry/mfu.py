"""Model-FLOPs utilization (MFU).

Counterpart of ``deepspeed_tpu/telemetry/mfu.py:49-121``: the device's
published peak and the report dict the benches embed. The TPU package asks
XLA for a compiled program's flops (``compiled_cost_analysis``); there is no
XLA here, so that waits for the flops profiler (ROADMAP A13) and callers pass
the flops of one call themselves (e.g. ``gpt_flops_per_token`` × tokens).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

#: Published dense bf16 peak FLOPs/s per GPU, keyed by a lowercase
#: substring of ``torch.cuda.get_device_name``; most specific first.
#: H100 SXM: 989.4 TFLOP/s bf16 dense (NVIDIA H100 Tensor Core GPU
#: datasheet); H100 PCIe: 756 TFLOP/s (same datasheet).
_GPU_PEAK_BF16 = (
    ("h100 pcie", 756e12),
    ("h100", 989.4e12),
)

PEAK_FLOPS_ENV = "DSTPU_PEAK_FLOPS"


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak bf16 FLOPs/s of one device, or ``None`` when unknown (the CPU,
    an unlisted card). ``DSTPU_PEAK_FLOPS`` (float, FLOPs/s) overrides the
    table."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev).lower()
    for sub, peak in _GPU_PEAK_BF16:
        if sub in name:
            return peak
    return None


def mfu_report(*, flops_per_call: Optional[float], calls: int,
               wall_s: float, n_devices: int = 1,
               peak_flops: Optional[float] = None,
               label: str = "") -> Dict[str, Any]:
    """The MFU block: ``flops_per_call`` is the flops of one call over all
    devices; ``mfu`` is achieved / (peak × n_devices), ``None`` when either
    side is unknown."""
    achieved = None
    if flops_per_call and wall_s > 0 and calls > 0:
        achieved = flops_per_call * calls / wall_s
    mfu = None
    if achieved is not None and peak_flops:
        mfu = achieved / (peak_flops * max(n_devices, 1))
    return {
        "label": label,
        "flops_per_call": flops_per_call,
        "calls": calls,
        "wall_s": wall_s,
        "achieved_flops_per_s": achieved,
        "achieved_tflops_per_s":
            achieved / 1e12 if achieved is not None else None,
        "n_devices": n_devices,
        "peak_flops_per_device": peak_flops,
        "mfu": mfu,
    }
