"""Tiled linear layers: a matmul too large to gather whole, split into
tiles used one at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (reference
``zero/tiling.py:27``, ``TiledLinear``). ``TiledLinear(in_features,
out_features, in_splits=p, out_splits=q)`` holds one parameter ``kernel``
[p·q, in/p, out/q] (the TPU ``TiledDense``'s leaf, in its layout, which
``convert.tiled_params_to_state_dict`` maps) and a ``bias`` [out]. The
forward walks the tiles in order: tile ``t`` multiplies input split
``t // q`` into output split ``t % q``, the sums run over input splits,
output splits are concatenated and the bias is added once, all in the
compute dtype, as the TPU layer's scan does; so it equals a Linear with
the assembled weight up to the order of the input-split sums.

Under ZeRO stage 3 the port's gather unit gathers the ``kernel`` leaf
whole; gathering it a tile at a time is not done yet (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class TiledLinear(nn.Module):
    """y = x @ W + b with W stored as [in_splits * out_splits, in/p,
    out/q] tiles, applied one at a time."""

    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1, bias: bool = True,
                 dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        p, q = in_splits, out_splits
        if in_features % p or out_features % q:
            raise ValueError(f"({in_features}, {out_features}) not divisible "
                             f"by splits ({p}, {q})")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = p, q
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            p * q, in_features // p, out_features // q, dtype=param_dtype,
            device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=param_dtype, device=device)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """The TPU ``TiledDense``'s init: flax's ``variance_scaling(1.0,
        "fan_in", "truncated_normal", in_axis=-2, out_axis=-1)`` over the
        [p·q, in/p, out/q] kernel, which counts the tile axis as receptive
        field: fan-in = in/p · p·q = in_features · out_splits, variance
        1 / fan-in, a normal cut at two standard deviations and widened by
        1 / 0.8796 (the cut normal's standard deviation) to keep that
        variance; zero bias."""
        if self.kernel.is_meta:
            return
        fan_in = self.in_features * self.out_splits
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, q = self.in_splits, self.out_splits
        if x.shape[-1] != self.in_features:
            raise ValueError(f"input has {x.shape[-1]} features, the layer "
                             f"takes {self.in_features}")
        dtype = self.dtype or x.dtype
        ti, to = self.in_features // p, self.out_features // q
        xs = x.to(dtype).reshape(x.shape[:-1] + (p, ti))
        outs = [None] * q
        for t in range(p * q):
            i, j = divmod(t, q)
            part = xs[..., i, :] @ self.kernel[t].to(dtype)
            outs[j] = part if outs[j] is None else outs[j] + part
        y = torch.cat(outs, dim=-1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


# the TPU package's name
TiledDense = TiledLinear
