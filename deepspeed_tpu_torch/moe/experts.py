"""Expert bank: one MLP's weights stacked over the experts.

Counterpart of ``deepspeed_tpu/moe/experts.py`` (reference
``deepspeed/moe/experts.py:9-34``, which deep-copies the expert module per
local expert). The TPU package lifts the GPT MLP with ``nn.vmap``, so its
params carry a leading expert dim ``[E, ...]`` under a path that contains
``experts``; here the bank is those stacked weights, ``up_proj`` and
``down_proj`` each a ``weight`` [E, out, in] (a Linear weight per expert)
and a ``bias`` [E, out], applied to the dispatched ``[E, C, M]`` slots as
batched matmuls (``torch.baddbmm``) with the MLP's tanh-GELU between, in
the compute dtype. The TPU package computes it outside any Pallas kernel.

Under expert parallelism a rank holds only its share: experts
``[first, first + num_local)`` of ``num_experts``
(:meth:`Experts.keep_local`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ExpertLinear(nn.Module):
    """One Linear per expert, stacked: ``weight`` [E, out, in] and ``bias``
    [E, out]."""

    def __init__(self, num_experts: int, n_in: int, n_out: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.weight = nn.Parameter(torch.empty(num_experts, n_out, n_in,
                                               **kw))
        self.bias = nn.Parameter(torch.empty(num_experts, n_out, **kw))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """x [E, C, in] -> [E, C, out], inputs and params in ``dtype``."""
        return torch.baddbmm(self.bias.to(dtype)[:, None, :], x.to(dtype),
                             self.weight.to(dtype).transpose(1, 2))


class Experts(nn.Module):
    """``num_experts`` GPT MLPs (up_proj -> tanh-GELU -> down_proj) applied
    to the leading expert dim of an ``[E_local, C, M]`` tensor."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        self.first = 0
        self.dtype = dtype
        self.up_proj = ExpertLinear(num_experts, d_model, d_ff, param_dtype,
                                    device)
        self.down_proj = ExpertLinear(num_experts, d_ff, d_model,
                                      param_dtype, device)

    @property
    def num_local(self) -> int:
        return self.up_proj.weight.shape[0]

    @torch.no_grad()
    def keep_local(self, rank: int, size: int) -> None:
        """Keep experts ``[rank * E / size, (rank + 1) * E / size)`` (the
        ep coordinate ``rank`` of ``size``); the Parameter objects stay."""
        if self.num_experts % size:
            raise ValueError(f"num_experts={self.num_experts} does not "
                             f"divide by ep={size}")
        if self.num_local != self.num_experts:
            raise ValueError("the expert bank is already sharded")
        n = self.num_experts // size
        self.first = rank * n
        for p in self.parameters():
            p.data = p.data[self.first:self.first + n].clone()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.num_local:
            raise ValueError(f"expected leading expert dim {self.num_local},"
                             f" got shape {tuple(x.shape)}")
        h = F.gelu(self.up_proj(x, self.dtype), approximate="tanh")
        return self.down_proj(h, self.dtype)


class ExpertMLP(nn.Module):
    """The dense MLP of a residual MoE (PR-MoE): the GPT MLP, unstacked
    (``up_proj`` / ``down_proj`` Linears, tanh-GELU, compute dtype)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.up_proj = nn.Linear(d_model, d_ff, **kw)
        self.down_proj = nn.Linear(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.gelu(F.linear(x.to(dt), self.up_proj.weight.to(dt),
                            self.up_proj.bias.to(dt)), approximate="tanh")
        return F.linear(h, self.down_proj.weight.to(dt),
                        self.down_proj.bias.to(dt))
