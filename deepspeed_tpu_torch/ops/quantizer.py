"""int8 quantization: the port's copy of ``deepspeed_tpu/ops/quantizer.py``.

Weights (the inference engine's ``quantize_bits=8``):

  * :func:`quantize` / :func:`dequantize`: symmetric per-group int8, scale
    ``absmax / 127`` (1 for an all-zero group), codes in [-127, 127];
  * :func:`quantize_asym` / :func:`dequantize_asym`: the min/max range of
    :func:`_asym_range`, ``scale = (max - min + 1e-5) / 256``, codes rebased
    by -128 into int8 (dequant ``(q + 128) * scale + min``);
  * :func:`ds_quantize`: fake quantization with the reference kernel
    family's semantics and the TPU package's saturating clamps, the
    stochastic variants drawing from an explicit ``torch.Generator``;
  * :func:`quantize_module`: the counterpart of ``quantize_tree`` over a
    module. Every GEMM weight (an ``nn.Linear``; not an embedding, a bias
    or a norm; an untied ``lm_head`` is) becomes an :class:`Int8Linear`
    whose weight rests as int8 with one f32 scale (and, asymmetric, one f32
    ``zmin``) per output column, dequantized to the compute dtype just
    before its ``F.linear``. Under ``scan_layers`` a column's group spans
    that Linear in every layer, as in the TPU tree's stacked ``[L, in,
    out]`` kernels; otherwise each layer has its own groups.

Everything is computed in f32 with the TPU package's operation order, so
the int8 codes and the dequantized weights are bitwise the TPU package's.
No kernel: the TPU package dequantizes outside any Pallas kernel too.

The int8 KV cache (one symmetric scale group per token vector, the last
axis: one position's concatenated heads, the unit in which cache rows are
written and read), computed in f32: ``q_scale = 256 / (2 * absmax +
1e-5)``, rounded half to even (``torch.round``, as ``jnp.round``), clamped
to [-128, 127] so the group's extreme does not wrap. The stored scale is
the dequant multiplier ``1 / q_scale``, so a read is ``q * scale`` with no
division. And stochastic bf16 rounding.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# embedding tables stay unquantized (the TPU package's path predicate)
_EMBED_PAT = re.compile(r"\b(wte|wpe|wtt|embed|embedding)\b")
# a layer's index in a module name: blocks.<i>.attn.qkv
_LAYER_PAT = re.compile(r"\.(\d+)\.")


def quantize_kv(x: torch.Tensor, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 [..., D], f32 dequant multiplier [..., 1]).
    Under tp ``x`` is this rank's heads of each position and ``group`` the
    tp group: the absmax is the whole position's (max-reduced over the
    group), so the codes and scales are the unsplit cache's."""
    flat = x.float()
    absmax = flat.abs().amax(dim=-1, keepdim=True)
    if group is not None and group.size > 1:
        from ..comm import comm
        absmax = comm.all_reduce(absmax.contiguous(), "max", group=group)
    q_scale = 256.0 / (2.0 * absmax + 1e-5)
    q = torch.round(flat * q_scale).clamp(-128.0, 127.0).to(torch.int8)
    return q, 1.0 / q_scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``(q * scale)`` in f32, cast to
    ``dtype``; ``scale`` broadcasts against ``q``."""
    return (q.float() * scale).to(dtype)


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding: add 16 uniform random bits
    below the bf16 truncation point, then truncate the mantissa. Unbiased
    in expectation (the training-mode rounding of the reference's
    StochasticTransformerBuilder kernels, ds_transformer_cuda.cpp:
    1031-1046). Non-finite values take the deterministic cast. The bits come
    from ``generator`` (the default generator when None), so they are not
    the TPU package's bits from the same seed. The uint32 arithmetic runs on
    int64 (torch has few uint32 ops); like the TPU package's bitcast, the
    result carries no gradient."""
    x32 = x.detach().float()
    bits = x32.view(torch.int32).long() & 0xFFFFFFFF
    noise = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                          device=x32.device, dtype=torch.int64)
    kept = (bits + noise) & 0xFFFF0000
    kept = torch.where(kept >= 1 << 31, kept - (1 << 32), kept)
    sr = kept.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x32), sr, x32).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------

def _sym_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The symmetric scale of a group's absmax (1 for an all-zero group)."""
    return torch.where(absmax > 0, absmax / 127.0, 1.0)


def _asym_scale(mn: torch.Tensor, mx: torch.Tensor,
                bits: int) -> torch.Tensor:
    """The min/max-range scale, ``(max - min + 1e-5) / 2^bits``: the one
    home of that formula."""
    return ((mx - mn) + 1e-5) / float(1 << bits)


def _encode(flat: torch.Tensor, scale: torch.Tensor,
            mn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 rows and their [G, 1] scale (and min) -> int8 codes: symmetric
    in [-127, 127], asymmetric in [0, 255] rebased by -128."""
    if mn is None:
        return torch.round(flat / scale).clamp(-127, 127).to(torch.int8)
    q = torch.round((flat - mn) / scale).clamp(0, 255) - 128
    return q.to(torch.int8)


def quantize(x: torch.Tensor, num_groups: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group int8 over the flattened tensor. Returns (int8 of
    x's shape, f32 scales [num_groups])."""
    flat = x.reshape(num_groups, -1).float()
    scale = _sym_scale(flat.abs().amax(dim=1, keepdim=True))
    return _encode(flat, scale).reshape(x.shape), scale[:, 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    flat = q.reshape(scales.shape[0], -1) * scales[:, None]
    return flat.to(dtype).reshape(q.shape)


def _asym_range(flat: torch.Tensor, bits: int):
    """Per-group (min, scale) of the min/max-range scheme."""
    mn = flat.amin(dim=1, keepdim=True)
    return mn, _asym_scale(mn, flat.amax(dim=1, keepdim=True), bits)


def quantize_asym(x: torch.Tensor, num_groups: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-group int8: codes ``round((x - min) / scale)`` in
    [0, 255], stored rebased by -128. Returns (int8, f32 scales [G], f32
    mins [G])."""
    flat = x.reshape(num_groups, -1).float()
    mn, scale = _asym_range(flat, 8)
    return _encode(flat, scale, mn).reshape(x.shape), scale[:, 0], mn[:, 0]


def dequantize_asym(q: torch.Tensor, scales: torch.Tensor,
                    mins: torch.Tensor, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    flat = q.reshape(scales.shape[0], -1) + 128.0
    flat = flat * scales[:, None] + mins[:, None]
    return flat.to(dtype).reshape(q.shape)


def ds_quantize(vals: torch.Tensor, groups: int, bits: int = 8,
                asymmetric: bool = False, stochastic: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fake quantization (quantize, then dequantize, in vals' dtype and
    shape) with the reference kernel family's semantics:

      sym       : q_scale = 2^bits / (2 absmax + 1e-5); round(v q_scale),
                  clamped to [-2^(bits-1), 2^(bits-1) - 1]; / q_scale
      sym + sr  : truncate toward zero, bump by sign(v) with probability
                  |the fractional part|, only strictly inside the range
      asym      : q_scale = (max - min + 1e-5) / 2^bits; round((v - min) /
                  q_scale) clamped to [0, 2^bits - 1]; * q_scale + min
      asym + sr : floor, + 1 with probability the fractional part, clamped

    The clamps saturate the group's extreme instead of wrapping it.
    ``stochastic=True`` needs a ``generator``: the uniform draws come from
    it, so they are not the TPU package's draws from the same seed."""
    if stochastic and generator is None:
        raise ValueError("stochastic=True needs a torch.Generator")
    flat = vals.reshape(groups, -1).float()

    def uniform():
        return torch.rand(flat.shape, generator=generator,
                          device=flat.device)

    if asymmetric:
        mn, scale = _asym_range(flat, bits)
        t = (flat - mn) / scale
        if stochastic:
            low = torch.floor(t)
            q = low + (uniform() < (t - low)).float()
        else:
            q = torch.round(t)
        q = q.clamp(0.0, float((1 << bits) - 1))
        out = q * scale + mn
    else:
        absmax = flat.abs().amax(dim=1, keepdim=True)
        q_scale = float(1 << bits) / (2.0 * absmax + 1e-5)
        t = flat * q_scale
        high_q = float((1 << (bits - 1)) - 1)
        low_q = float(-(1 << (bits - 1)))
        if stochastic:
            ti = torch.trunc(t)
            err = (t - ti).abs()
            bump = ((uniform() < err) & (ti > low_q) & (ti < high_q)).float()
            q = ti + torch.sign(t) * bump
        else:
            q = torch.round(t).clamp(low_q, high_q)
        out = q / q_scale
    return out.reshape(vals.shape).to(vals.dtype)


def dequantize_weight(q8: torch.Tensor, scale: torch.Tensor,
                      zmin: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """One quantized Linear weight [out, in] back to ``dtype``: the TPU
    ``dequantize_tree`` of its kernel, elementwise, so bitwise equal."""
    if zmin is None:
        return dequantize(q8, scale, dtype)
    return dequantize_asym(q8, scale, zmin, dtype)


class Int8Linear(nn.Module):
    """An ``nn.Linear`` whose weight rests as int8: ``q8`` [out, in], f32
    ``scale`` [out] and, asymmetric, f32 ``zmin`` [out] (buffers); the bias
    stays a parameter in the compute dtype. :attr:`weight` dequantizes to
    ``dtype`` on every read, so the model's ``F.linear`` calls read it
    unchanged and only one Linear's weight is dequantized at a time. The
    scales stay f32 through ``module.to(dtype)``."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor,
                 zmin: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                 dtype):
        super().__init__()
        self.out_features, self.in_features = q8.shape
        self.dtype = dtype
        self.register_buffer("q8", q8)
        self.register_buffer("scale", scale)
        self.register_buffer("zmin", zmin)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))

    @property
    def weight(self) -> torch.Tensor:
        return dequantize_weight(self.q8, self.scale, self.zmin, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if getattr(self, "tp", None) is not None:    # split over tp
            from ..module_inject.layers import tp_linear
            return tp_linear(x, self, x.dtype)
        return F.linear(x, self.weight, self.bias)

    def _apply(self, fn, recurse=True):
        f32 = {n: t for n in ("scale", "zmin")
               if (t := self._buffers.get(n)) is not None}
        super()._apply(fn, recurse)
        for n, t in f32.items():         # follow the device, keep f32
            self._buffers[n] = t.to(self._buffers[n].device)
        return self

    def extra_repr(self) -> str:
        mode = "symmetric" if self.zmin is None else "asymmetric"
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, {mode}, "
                f"dtype={self.dtype}")


def _gemm_linears(module: nn.Module) -> Dict[str, nn.Linear]:
    """The Linears ``quantize_tree`` quantizes: every ``nn.Linear`` whose
    name names no embedding table."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, nn.Linear) and not _EMBED_PAT.search(name)}


def _set_submodule(root: nn.Module, name: str, child: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, child)


def quantize_module(module: nn.Module, mode: str = "symmetric",
                    dtype=torch.bfloat16, device=None,
                    scan_layers: bool = False) -> nn.Module:
    """Replace ``module``'s GEMM Linears by :class:`Int8Linear`, in place.
    Each weight is first cast to ``dtype`` (and moved to ``device``), then
    quantized, one Linear at a time: the TPU engine quantizes the cast tree.
    With ``scan_layers`` the Linears that differ only in their layer index
    (``blocks.<i>.…``) share one scale group a column, reduced over the
    layers, as ``quantize_tree`` groups a stacked kernel. Returns
    ``module``."""
    if mode not in ("symmetric", "asymmetric"):
        raise ValueError(f"quantize mode {mode!r}: use 'symmetric' or "
                         f"'asymmetric'")
    asym = mode == "asymmetric"
    linears = _gemm_linears(module)
    groups: Dict[str, List[str]] = {}
    for name in linears:
        key = _LAYER_PAT.sub(".*.", name) if scan_layers else name
        groups.setdefault(key, []).append(name)

    def cast(name):
        return linears[name].weight.detach().to(device=device, dtype=dtype)

    for names in groups.values():
        # per output column: absmax (asymmetric: min and max) over every
        # member, read one member at a time
        hi = lo = None
        for name in names:
            last = w = cast(name).float()    # the last one is kept
            top = w.amax(dim=1) if asym else w.abs().amax(dim=1)
            hi = top if hi is None else torch.maximum(hi, top)
            if asym:
                low = w.amin(dim=1)
                lo = low if lo is None else torch.minimum(lo, low)
        scale = _asym_scale(lo, hi, 8) if asym else _sym_scale(hi)
        for name in names:
            w = last if name == names[-1] else cast(name).float()
            q = _encode(w, scale[:, None], None if lo is None else lo[:, None])
            lin = linears[name]
            bias = None if lin.bias is None else lin.bias.detach().to(
                device=device, dtype=dtype)
            _set_submodule(module, name,
                           Int8Linear(q, scale, lo, bias, dtype))
    return module


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "q8" in x and "scale" in x


def quantize_shardings(qtree, fp_specs):
    """The TPU package's ``quantize_shardings`` over PartitionSpec tuples:
    for a quantized tree (``{"q8", "scale"[, "zmin"]}`` leaves, the codes
    ``moveaxis(-1, 0)`` of the kernel) and the fp tree's specs, each q8 leaf
    takes its kernel's spec moved the same way and its per-output-column
    scales (and zmin) that spec's output entry; other leaves keep theirs.
    So int8 weights rest tp-split as the fp ones would: on a module the
    split is ``module_inject.layers.shard_linear`` of an ``Int8Linear``,
    quantized whole first (a row shard's scales are its whole columns')."""
    if _is_qleaf(qtree):
        nd = qtree["q8"].ndim
        spec = list(fp_specs or ()) + [None] * (nd - len(fp_specs or ()))
        moved = tuple([spec[-1]] + spec[:-1])
        out = {"q8": moved, "scale": (moved[0],)}
        if "zmin" in qtree:
            out["zmin"] = (moved[0],)
        return out
    if isinstance(qtree, dict):
        return {k: quantize_shardings(v, fp_specs[k])
                for k, v in qtree.items()}
    return fp_specs


def weight_bytes(module: nn.Module) -> int:
    """Bytes of ``module``'s parameters and buffers, shared tensors once."""
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        seen[t.data_ptr() if t.device.type != "meta" else id(t)] = \
            t.numel() * t.element_size()
    return sum(seen.values())
