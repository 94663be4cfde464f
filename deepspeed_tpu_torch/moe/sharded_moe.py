"""Sharded Mixture-of-Experts: gating, dispatch, experts and combine.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (reference
``deepspeed/moe/sharded_moe.py``: ``top1gating``:178, ``top2gating``:279,
``TopKGate``:352, ``MOELayer``:440). The gating math is the TPU package's,
op for op, on [S, E] tensors: the capacity is a static int, the
load-balancing loss and the capacity positions are taken over every token
of the call, and the outputs are ``(l_aux, combine [S, E, C],
dispatch [S, E, C] bool, exp_counts [E])``.

Where the TPU package draws from a JAX PRNG key (Random Token Selection's
uniform priorities, the RSample and top-2 Gumbel noise, Jitter), the
functions here take the draws as tensors (:class:`GateDraws`, made by
:func:`draw_gate_noise` from a ``torch.Generator``), so one set of draws can
be replayed exactly (under remat) or injected (a test hands in JAX's own).
``_keep_top_capacity`` ranks tokens by (priority desc, index asc), the
order ``jax.lax.top_k`` keeps among ties: outside RTS the priority is the
0/1 mask itself, so the first ``capacity`` tokens of each expert stay.

:class:`MOELayer` routes the *global* token set of a call, as the TPU
program does under its mesh. Over a data-parallel ``token_group`` every
rank all-gathers the group's tokens (rank-major, which is the global
batch's row order), routes them all identically, and combines only its
own; over an ``ep_group`` each rank runs only its share of the experts on
their full ``[C, M]`` slots and the outputs are all-gathered over ep. The
backward mirrors it: the token gather reduce-scatters its grads over dp;
the expert scatter and gather treat their tensors as replicated over ep
(the ep partners of a dp shard compute the same loss on the same tokens),
so the gather's backward keeps this rank's slice and the scatter's
all-gathers the slices, and no gradient is summed over ep.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Static per-expert capacity (reference ``_capacity``,
    sharded_moe.py:158-166)."""
    cap = math.ceil(num_tokens / num_experts) * capacity_factor
    cap = int(math.ceil(cap))
    if cap < min_capacity:
        cap = int(min_capacity)
    return min(cap, num_tokens)


def _keep_top_capacity(mask: torch.Tensor, priority: torch.Tensor,
                       capacity: int) -> torch.Tensor:
    """Keep at most ``capacity`` tokens per expert: those of highest
    ``priority``, the lowest token index first among equals. mask and
    priority [S, E] -> pruned mask [S, E]."""
    s, e = mask.shape
    top = torch.sort(priority.t(), dim=1, descending=True,
                     stable=True).indices[:, :capacity]          # [E, C]
    keep = torch.zeros(e, s, dtype=mask.dtype, device=mask.device)
    keep.scatter_(1, top, 1)
    return mask * keep.t()


class GateDraws(NamedTuple):
    """One gate call's random draws (None: not drawn). ``jitter`` [S, M]
    in [0.99, 1.01) multiplies the gate input (noisy_gate_policy Jitter);
    ``gumbel`` [S, E] is the RSample noise of top-1 or the noise that picks
    top-2's second expert; ``rts`` [S, E] uniform [0, 1) the Random Token
    Selection priorities of top-1."""
    jitter: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    rts: Optional[torch.Tensor] = None


def draw_gate_noise(generator: torch.Generator, num_tokens: int,
                    model_dim: int, num_experts: int, k: int = 1,
                    noisy_gate_policy: Optional[str] = None,
                    use_rts: bool = True) -> GateDraws:
    """The draws a training-mode gate over ``num_tokens`` tokens takes, from
    ``generator``, on its device, in the TPU gate's order: Jitter, then the
    Gumbel noise (RSample top-1, or top-2), then the RTS uniforms (top-1).
    Gumbel noise is ``-log(-log(u))`` with u drawn in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    jitter = gumbel = rts = None
    if noisy_gate_policy == "Jitter":
        jitter = 0.99 + 0.02 * uniform(num_tokens, model_dim)
    if k == 2 or noisy_gate_policy == "RSample":
        u = uniform(num_tokens, num_experts).clamp_min(
            torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
    if k == 1 and use_rts:
        rts = uniform(num_tokens, num_experts)
    return GateDraws(jitter, gumbel, rts)


def top1gating(logits: torch.Tensor, capacity_factor: float,
               min_capacity: int,
               used_token: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, use_rts: bool = True,
               gumbel: Optional[torch.Tensor] = None,
               rts: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """Top-1 gating (Switch-style) over logits [S, E] fp32. ``gumbel``
    (RSample) and ``rts`` are the draws the TPU function takes from its
    key; without them the choice is the gate's argmax and the priority the
    mask (token order). Returns (l_aux, combine [S, E, C], dispatch
    [S, E, C] bool, exp_counts [E] pre-drop)."""
    s, e = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _capacity(s, e, capacity_factor, min_capacity)
    if not drop_tokens:
        capacity = s

    if noisy_gate_policy == "RSample" and gumbel is not None:
        indices1 = torch.argmax(logits + gumbel, dim=1)
    else:
        indices1 = torch.argmax(gates, dim=1)
    mask1 = F.one_hot(indices1, e).int()
    if used_token is not None:
        mask1 = mask1 * used_token.int()[:, None]
    exp_counts = mask1.sum(dim=0)

    # load-balancing loss (GShard eq.; reference :220-223)
    me = gates.mean(dim=0)
    ce = mask1.float().mean(dim=0)
    l_aux = (me * ce).sum() * e

    if use_rts and rts is not None:
        priority = mask1.float() * rts
    else:
        priority = mask1.float()
    mask1 = _keep_top_capacity(mask1, priority, capacity)

    locations1 = mask1.cumsum(dim=0) - 1                         # [S, E]
    locations1_s = (locations1 * mask1).sum(dim=1)               # [S]
    gates_masked = gates * mask1.to(gates.dtype)
    locations1_sc = F.one_hot(locations1_s.long(), capacity).to(gates.dtype)
    combine = torch.einsum("se,sc->sec", gates_masked, locations1_sc)
    return l_aux, combine, combine > 0, exp_counts


def top2gating(logits: torch.Tensor, capacity_factor: float,
               min_capacity: int, gumbel: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """Top-2 gating (GShard) over logits [S, E] fp32: the second expert is
    the argmax of ``logits + gumbel`` (plain logits without noise) over the
    experts the first did not take. Returns what :func:`top1gating`
    does."""
    s, e = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _capacity(s, e, capacity_factor * 2.0, min_capacity)

    indices1 = torch.argmax(gates, dim=1)
    mask1 = F.one_hot(indices1, e).int()
    noisy = logits if gumbel is None else logits + gumbel
    masked = torch.where(mask1 > 0, float("-inf"), noisy)
    mask2 = F.one_hot(torch.argmax(masked, dim=1), e).int()

    locations1 = mask1.cumsum(dim=0) - 1
    locations2 = mask2.cumsum(dim=0) - 1 + mask1.sum(dim=0, keepdim=True)
    exp_counts = mask1.sum(dim=0)

    me = gates.mean(dim=0)
    ce = mask1.float().mean(dim=0)
    l_aux = (me * ce).mean() * e * e

    mask1 = mask1 * (locations1 < capacity).int()
    mask2 = mask2 * (locations2 < capacity).int()
    locations1_s = (locations1 * mask1).sum(dim=1)
    locations2_s = (locations2 * mask2).sum(dim=1)

    mask1_f, mask2_f = mask1.to(gates.dtype), mask2.to(gates.dtype)
    gates1_s = (gates * mask1_f).sum(dim=1)
    gates2_s = (gates * mask2_f).sum(dim=1)
    denom = (gates1_s + gates2_s).clamp_min(torch.finfo(gates.dtype).eps)
    gates1 = (gates1_s / denom)[:, None] * mask1_f
    gates2 = (gates2_s / denom)[:, None] * mask2_f
    loc1_sc = F.one_hot(locations1_s.long(), capacity).to(gates.dtype)
    loc2_sc = F.one_hot(locations2_s.long(), capacity).to(gates.dtype)
    combine = (torch.einsum("se,sc->sec", gates1, loc1_sc)
               + torch.einsum("se,sc->sec", gates2, loc2_sc))
    return l_aux, combine, combine > 0, exp_counts


class TopKGate(nn.Module):
    """Gate network: an fp32 linear ``wg`` [E, M] without bias -> top-k
    gating (reference TopKGate, sharded_moe.py:352-437), k in {1, 2}. The
    gate computes in f32 whatever dtype ``wg`` was cast to."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 device=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gatings are supported.")
        self.model_dim, self.num_experts, self.k = model_dim, num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens, self.use_rts = drop_tokens, use_rts
        self.wg = nn.Linear(model_dim, num_experts, bias=False,
                            dtype=torch.float32, device=device)

    def draws(self, generator: torch.Generator, num_tokens: int
              ) -> GateDraws:
        """This gate's training draws for ``num_tokens`` tokens."""
        return draw_gate_noise(generator, num_tokens, self.model_dim,
                               self.num_experts, self.k,
                               self.noisy_gate_policy, self.use_rts)

    def forward(self, tokens: torch.Tensor,
                used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                draws: Optional[GateDraws] = None):
        """tokens [S, M]. Training (``deterministic=False``) gates at
        ``capacity_factor`` with ``draws`` (none: no noise, as the TPU gate
        without a ``gating`` key); eval at ``eval_capacity_factor``, with
        no noise."""
        x = tokens.float()
        if deterministic or draws is None:
            draws = GateDraws()
        if self.noisy_gate_policy == "Jitter" and draws.jitter is not None:
            x = x * draws.jitter
        logits = F.linear(x, self.wg.weight.float())
        cf = self.eval_capacity_factor if deterministic \
            else self.capacity_factor
        if self.k == 1:
            return top1gating(
                logits, cf, self.min_capacity, used_token=used_token,
                noisy_gate_policy=(None if deterministic
                                   else self.noisy_gate_policy),
                drop_tokens=self.drop_tokens, use_rts=self.use_rts,
                gumbel=draws.gumbel, rts=draws.rts)
        return top2gating(logits, cf, self.min_capacity,
                          gumbel=draws.gumbel)


# --------------------------------------------------------------------------
# The collectives of a distributed MoE call, as autograd functions
# --------------------------------------------------------------------------

class _GatherTokens(torch.autograd.Function):
    """Forward: this rank's tokens -> the group's, rank-major. Backward:
    the grads summed over the group, this rank's rows (a reduce-scatter):
    each rank's loss reaches every rank's tokens."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_gather_base(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter_base(grad.contiguous(),
                                        group=ctx.group), None


class _ScatterToExperts(torch.autograd.Function):
    """Forward: rows ``[lo, hi)`` of a tensor replicated over the ep group.
    Backward: the slices' grads all-gathered (each partner's slice of the
    one replicated gradient)."""

    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.group = group
        return x[lo:hi].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_gather_base(grad.contiguous(), group=ctx.group),
                None, None, None)


class _GatherFromExperts(torch.autograd.Function):
    """Forward: every ep partner's expert outputs all-gathered, in expert
    order. Backward: this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = x.shape[0]
        ctx.lo = group.rank * x.shape[0]
        return comm.all_gather_base(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.n].contiguous(), None


def _spans(group) -> bool:
    return group is not None and group.size > 1


class MOELayer(nn.Module):
    """Dispatch -> experts -> combine (reference MOELayer.forward,
    sharded_moe.py:488-561). ``experts`` maps this rank's ``[E_local, C,
    M]`` slots to outputs of the same shape and holds experts
    ``[experts.first, experts.first + E_local)`` of the gate's E.
    ``token_group`` (the data-parallel group, when the batch is sharded
    over it) and ``ep_group`` are set by the engines
    (:func:`~deepspeed_tpu_torch.moe.layer.set_expert_parallel`); None
    routes this rank's tokens over its own experts alone."""

    def __init__(self, gate: TopKGate, experts: nn.Module):
        super().__init__()
        self.gate = gate
        self.experts = experts
        self.token_group = None
        self.ep_group = None

    def global_tokens(self, num_tokens: int) -> int:
        """Tokens the gate routes when this rank brings ``num_tokens``."""
        return num_tokens * (self.token_group.size
                             if _spans(self.token_group) else 1)

    def forward(self, x: torch.Tensor,
                used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                draws: Optional[GateDraws] = None):
        d_model = x.shape[-1]
        tokens = x.reshape(-1, d_model)                          # [S, M]
        n_local = tokens.shape[0]
        lo = 0
        if _spans(self.token_group):
            lo = self.token_group.rank * n_local
            tokens = _GatherTokens.apply(tokens, self.token_group)
            if used_token is not None:
                used_token = comm.all_gather_base(used_token.reshape(-1),
                                                  group=self.token_group)
        l_aux, combine, dispatch, exp_counts = self.gate(
            tokens, used_token, deterministic, draws)
        dispatched = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype),
                                  tokens)                        # [E, C, M]
        first, n_exp = self.experts.first, self.experts.num_local
        if _spans(self.ep_group):
            dispatched = _ScatterToExperts.apply(dispatched, first,
                                                 first + n_exp, self.ep_group)
        expert_out = self.experts(dispatched)
        if _spans(self.ep_group):
            expert_out = _GatherFromExperts.apply(expert_out, self.ep_group)
        if _spans(self.token_group):
            combine = combine[lo:lo + n_local]
        out = torch.einsum("sec,ecm->sm", combine.to(x.dtype), expert_out)
        return out.reshape(x.shape), l_aux, exp_counts
