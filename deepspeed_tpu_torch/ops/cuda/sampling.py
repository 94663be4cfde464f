"""Sort-free sampling epilogue: top-k/top-p filter + draw, one kernel.

Counterpart of ``deepspeed_tpu/ops/pallas/sampling.py``. The Pallas kernel
``_sampling_kernel`` becomes the CUDA kernel in ``csrc/sampling.cu``: one
block per row, the row staged in shared memory, both sorts replaced by
33-step bisections over monotonic int32 order keys. Its plain PyTorch
version, :func:`filter_rows_reference` / :func:`fused_sample_reference`,
runs the same bisections with tensor ops, so greedy draws and top-k
filtered logits agree bit for bit; top-p kept sets agree up to f32
summation order of the probability mass.

The wrappers launch the kernel for a CUDA tensor and run the plain version
for a CPU tensor. Temperature is divided outside the kernel, as on the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_NEG_CAP = -1e10
_INT32_MAX = 2147483647
_MAX_VOCAB = 256 * 1024
_BISECT_ITERS = 33


def sampling_supported(b: int, v: int) -> bool:
    """The TPU kernel's feasibility test, kept so the router makes the same
    choice: lane-aligned vocab within the row budget. Callers use the
    sort-based ``serving.sampling.filter_logits`` otherwise."""
    return b >= 1 and v % 128 == 0 and v <= _MAX_VOCAB


def _check_args(top_k: Optional[int], top_p: Optional[float]) -> None:
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


# ------------------------------------------------------------- plain version
def order_key(x: torch.Tensor) -> torch.Tensor:
    """Strictly monotonic f32 -> int32 key: non-negative floats keep their
    bits; negative floats reflect (INT32_MAX - bits, wrapping for -0.0)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, _INT32_MAX - bits)
    return (key + 2 ** 31) % 2 ** 32 - 2 ** 31


def _mid(lo, hi):
    return (lo >> 1) + (hi >> 1) + (lo & hi & 1)


def _bisect_kth_key(key: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the largest t with count(key >= t) >= k."""
    lo = key.min(dim=-1).values
    hi = key.max(dim=-1).values + 1
    for _ in range(_BISECT_ITERS):
        mid = _mid(lo, hi)
        take = (key >= mid[:, None]).sum(dim=-1) >= k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return lo


def _bisect_top_p_key(key, e, pz):
    """Per row, the smallest present key above the largest T whose
    strictly-above mass still reaches pz."""
    lo = key.min(dim=-1).values - 1
    hi = key.max(dim=-1).values
    for _ in range(_BISECT_ITERS):
        mid = _mid(lo, hi)
        mass = torch.where(key > mid[:, None], e, 0.0).sum(dim=-1)
        take = mass >= pz
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return torch.where(key > lo[:, None], key,
                       torch.full_like(key, _INT32_MAX)).min(dim=-1).values


def filter_rows_reference(x: torch.Tensor, top_k: Optional[int],
                          top_p: Optional[float]) -> torch.Tensor:
    """The kernel's row transform on [b, V] f32 logits already divided by
    the temperature."""
    v = x.shape[-1]
    if top_k is not None and top_k < v:
        key = order_key(x)
        kth = _bisect_kth_key(key, top_k)
        x = torch.where(key >= kth[:, None], x, _NEG_CAP)
    if top_p is not None and top_p < 1.0:
        key = order_key(x)
        e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
        pz = torch.tensor(top_p, dtype=torch.float32) * e.sum(dim=-1)
        kth = _bisect_top_p_key(key, e, pz)
        x = torch.where(key >= kth[:, None], x, _NEG_CAP)
    return x


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    m = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(x == m, idx, x.shape[-1]).min(dim=-1).values


def fused_sample_reference(x: torch.Tensor, gumbel: Optional[torch.Tensor],
                           top_k: Optional[int],
                           top_p: Optional[float]) -> torch.Tensor:
    """Filter, then first-index argmax of the row (+ gumbel when given)."""
    y = filter_rows_reference(x, top_k, top_p)
    if gumbel is not None:
        y = y + gumbel
    return _first_argmax(y).to(torch.int32)


# -------------------------------------------------------------- the kernel
def _launch(x: torch.Tensor, gumbel: Optional[torch.Tensor],
            out_logits: Optional[torch.Tensor],
            out_tokens: Optional[torch.Tensor], top_k: Optional[int],
            top_p: Optional[float]) -> None:
    b, v = x.shape
    for name, t in (("logits", x), ("gumbel", gumbel),
                    ("out_logits", out_logits)):
        if t is not None and (t.device != x.device or not t.is_contiguous()
                              or t.dtype != torch.float32
                              or t.shape != (b, v)):
            raise ValueError(f"{name} must be a contiguous f32 [{b}, {v}] "
                             f"tensor on {x.device}")
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dstorch_sampling(
            x.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            None if out_logits is None else out_logits.data_ptr(),
            None if out_tokens is None else out_tokens.data_ptr(),
            b, v, 0 if top_k is None else int(top_k),
            1.0 if top_p is None else float(top_p), _build.stream_of(x))
    _build.check(err, "sampling")
    _build.LAUNCHES["sampling"] += 1


def threshold_filter_logits(logits: torch.Tensor, temperature: float,
                            top_k: Optional[int],
                            top_p: Optional[float] = None) -> torch.Tensor:
    """Sort-free filter over [b, V] logits -> filtered f32 [b, V], masked
    entries at -1e10 (the ``serving.sampling.filter_logits`` contract)."""
    _check_args(top_k, top_p)
    x = logits.float()
    if temperature != 0.0:
        x = x / temperature
    if x.device.type == "cpu":
        return filter_rows_reference(x, top_k, top_p)
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch(x, None, out, None, top_k, top_p)
    return out


def fused_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float] = None) -> torch.Tensor:
    """Fused filter + draw over [b, V] logits -> int32 tokens [b].
    temperature == 0: first-index argmax. temperature > 0: Gumbel-max with
    the caller's [b, V] gumbel noise."""
    _check_args(top_k, top_p)
    sample = temperature != 0.0
    if sample and gumbel is None:
        raise ValueError("temperature != 0 needs gumbel noise")
    x = logits.float()
    if sample:
        x = x / temperature
        gumbel = gumbel.float()
    else:
        gumbel = None
    if x.device.type == "cpu":
        return fused_sample_reference(x, gumbel, top_k, top_p)
    x = x.contiguous()
    if gumbel is not None:
        gumbel = gumbel.contiguous()
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    _launch(x, gumbel, None, out, top_k, top_p)
    return out
