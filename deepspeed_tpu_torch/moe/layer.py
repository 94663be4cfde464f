"""User-facing MoE layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (reference
``deepspeed/moe/layer.py:18-131``): a TopKGate and an expert bank behind a
:class:`~.sharded_moe.MOELayer`, optionally a Residual MoE
(arXiv:2201.05596) that mixes the expert path with a dense MLP through a
softmaxed two-way ``coefficient``. ``forward`` returns ``(output, l_aux,
exp_counts)``.

Expert parallelism is the ``ep`` axis of the device mesh, as in the TPU
package; :func:`set_expert_parallel` is how an engine puts a model on it:
each MoE layer keeps its ep coordinate's experts and learns the groups its
call gathers over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .experts import ExpertMLP, Experts
from .sharded_moe import GateDraws, MOELayer, TopKGate


class MoE(nn.Module):
    """Mixture-of-Experts over GPT MLP experts of width ``d_ff``.
    ``dtype`` is the compute dtype of the experts and the residual path;
    ``param_dtype`` their parameters' (the gate is always f32).
    ``ep_size`` is kept for the TPU package's signature: the engines'
    mesh sets the degree."""

    def __init__(self, hidden_size: int, d_ff: int, num_experts: int = 1,
                 ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        if noisy_gate_policy not in (None, "None", "Jitter", "RSample"):
            raise ValueError(
                f"Unsupported noisy_gate_policy: {noisy_gate_policy}")
        self.ep_size = ep_size
        self.use_residual = use_residual
        gate = TopKGate(
            hidden_size, num_experts, k=k, capacity_factor=capacity_factor,
            eval_capacity_factor=eval_capacity_factor,
            min_capacity=min_capacity,
            noisy_gate_policy=(None if noisy_gate_policy == "None"
                               else noisy_gate_policy),
            drop_tokens=drop_tokens, use_rts=use_rts, device=device)
        self.deepspeed_moe = MOELayer(gate, Experts(
            num_experts, hidden_size, d_ff, dtype, param_dtype, device))
        if use_residual:
            self.mlp = ExpertMLP(hidden_size, d_ff, dtype, param_dtype,
                                 device)
            self.coefficient = nn.Linear(hidden_size, 2, dtype=param_dtype,
                                         device=device)

    def draws(self, generator: torch.Generator, num_tokens: int
              ) -> GateDraws:
        """The gate's training draws for a call that brings ``num_tokens``
        tokens on this rank (drawn over the tokens it routes)."""
        return self.deepspeed_moe.gate.draws(
            generator, self.deepspeed_moe.global_tokens(num_tokens))

    def forward(self, hidden_states: torch.Tensor,
                used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                draws: Optional[GateDraws] = None):
        output, l_aux, exp_counts = self.deepspeed_moe(
            hidden_states, used_token, deterministic, draws)
        if self.use_residual:
            mlp_out = self.mlp(hidden_states)
            dt = hidden_states.dtype
            coef = torch.softmax(torch.nn.functional.linear(
                hidden_states, self.coefficient.weight.to(dt),
                self.coefficient.bias.to(dt)), dim=-1)
            output = output * coef[..., 0:1] + mlp_out * coef[..., 1:]
        return output, l_aux, exp_counts


def moe_layers(module: nn.Module):
    """Every :class:`MOELayer` in ``module``, in module order."""
    return [m for m in module.modules() if isinstance(m, MOELayer)]


def set_expert_parallel(module: nn.Module, ep_group=None,
                        token_group=None) -> None:
    """Put ``module``'s MoE layers on the mesh: over an ``ep_group``
    (``comm.CommGroup``) of more than one rank each keeps the experts of
    this rank's place in the group; ``token_group`` (the dp group, when the
    batch is sharded over it) is the group whose tokens each call routes
    together."""
    for layer in moe_layers(module):
        if ep_group is not None and ep_group.size > 1:
            layer.experts.keep_local(ep_group.rank, ep_group.size)
            layer.ep_group = ep_group
        layer.token_group = token_group
