"""1-bit LAMB (reference: deepspeed/runtime/fp16/onebit/lamb.py:11).

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py``. Warmup:
baseline LAMB with per-tensor trust ratios, keeping an EMA of each
tensor's coefficient (``lamb_coeff_freeze``, coeff_beta; lamb.py:244). At
the freeze boundary the fresh-variance buffer snapshots the variance
(lamb.py:228), and on the first compressed step per-tensor
``scaling_coeff``s equalise the momentum magnitudes so that one flat 1-bit
compression serves every tensor (lamb.py:169-184). Compression phase: the
momentum is updated locally, scaled, 1-bit all-reduced, then each
tensor's frozen coefficient is modulated by the frozen-vs-fresh-variance
factor, with clamps (lamb.py:330-385).

Per-tensor reductions run over the leaves' contiguous slices of the flat
vector in one call each: the maxima are ``scatter_reduce(..., "amax")``
over the static leaf-id vector (as the TPU package's ``segment_max``);
the norms are ``torch._foreach_norm`` over the slices. A norm summed by
``index_add_`` would be summed in the order a CUDA launch's atomics land,
which differs from rank to rank; the trust ratios scale the update of a
master that must stay the same on every rank, so they are summed in a
fixed order.

The scaling coefficients come from the momentum of the last warmup step,
which is the same on every rank, as in the reference. The TPU package
takes them from each rank's momentum after its local gradient, so its
ranks' masters part after the first compressed step (ROADMAP §C).
"""

from __future__ import annotations

import torch

from ....comm import comm
from ....comm.compressed import compressed_allreduce, padded_size
from .adam import _zeros


class OnebitLamb:
    KEYS = ("lr", "betas", "eps", "weight_decay", "freeze_step", "max_coeff",
            "min_coeff", "coeff_beta", "factor_max", "factor_min",
            "factor_threshold")

    def __init__(self, n: int, world: int, leaf_slices=None, *,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100000,
                 max_coeff: float = 10.0, min_coeff: float = 0.01,
                 coeff_beta: float = 0.9, factor_max: float = 4.0,
                 factor_min: float = 0.5, factor_threshold: float = 0.1,
                 device="cpu"):
        if not leaf_slices:
            leaf_slices = [(0, n)]
        self.n = n
        self.world = world
        self.npad = padded_size(n, world)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.freeze_step = freeze_step
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.coeff_beta = coeff_beta
        self.factor_max = factor_max
        self.factor_min = factor_min
        self.factor_threshold = factor_threshold
        self.device = torch.device(device)
        self.L = len(leaf_slices)
        self.sizes = [e - s for s, e in leaf_slices]
        self.leaf_sizes = torch.tensor(self.sizes, dtype=torch.float32,
                                       device=self.device)
        self.leaf_ids = torch.repeat_interleave(
            torch.arange(self.L, device=self.device),
            torch.tensor(self.sizes, device=self.device))

    def mode_for(self, step: int) -> str:
        return "warmup" if step <= self.freeze_step else "comp"

    def transition_actions(self, step: int):
        return ()

    def comm_is_compressed(self, mode: str) -> bool:
        return mode == "comp"

    def init_state(self):
        per_leaf = lambda v: torch.full((self.L,), v, dtype=torch.float32,
                                        device=self.device)
        return {
            "mu": _zeros(self.npad, self.device),
            "nu": _zeros(self.npad, self.device),
            "nu_fresh": _zeros(self.npad, self.device),
            "worker_error": _zeros(self.npad, self.device),
            "server_error": _zeros(self.npad // self.world, self.device),
            "scaling": per_leaf(0.0),       # 0 = not yet set
            "coeff_freeze": per_leaf(1.0),
            "last_factor": per_leaf(1.0),
        }

    def effective_params(self, st, p_flat):
        return p_flat

    # ---- per-leaf helpers ----------------------------------------------------
    def _seg_max(self, x):
        out = torch.full((self.L,), float("-inf"), dtype=x.dtype,
                         device=x.device)
        return out.scatter_reduce(0, self.leaf_ids, x, "amax")

    def _leaf_norms(self, x):
        return torch.stack(torch._foreach_norm(list(x.split(self.sizes))))

    def _bcast(self, per_leaf):
        return per_leaf[self.leaf_ids]

    # ---- per-rank step --------------------------------------------------------
    @torch.no_grad()
    def step(self, mode: str, g: torch.Tensor, st, p: torch.Tensor,
             lr, count, group):
        st = dict(st)
        if mode == "warmup":
            return self._warmup(g, st, p, lr, count, group)
        return self._comp(g, st, p, lr, group)

    def _warmup(self, g, st, p, lr, count, group):
        b1, b2 = self.betas
        g = comm.all_reduce(g.clone(), "avg", group=group)
        mu = b1 * st["mu"] + (1 - b1) * g
        nu = b2 * st["nu"] + (1 - b2) * g * g
        # freeze-boundary snapshot of the variance (lamb.py:228)
        nu_fresh = nu.clone() if count == self.freeze_step \
            else st["nu_fresh"]

        update = mu[:self.n] / (torch.sqrt(nu[:self.n]) + self.eps)
        if self.weight_decay > 0.0:
            update = update + self.weight_decay * p
        w_norm = self._leaf_norms(p)
        u_norm = self._leaf_norms(update)
        raw = torch.where((w_norm > 0) & (u_norm > 0),
                          w_norm / u_norm.clamp_min(1e-30),
                          torch.ones_like(w_norm))
        coeff = raw.clamp(self.min_coeff, self.max_coeff)
        # EMA only where a real (non-unity) coefficient was computed
        # (lamb.py:244)
        cf = torch.where(coeff != 1.0,
                         self.coeff_beta * st["coeff_freeze"]
                         + (1 - self.coeff_beta) * coeff,
                         st["coeff_freeze"])
        new_p = p - lr * self._bcast(coeff) * update
        st.update(mu=mu, nu=nu, nu_fresh=nu_fresh, coeff_freeze=cf)
        return new_p, st

    def _comp(self, g, st, p, lr, group):
        b1, b2 = self.betas
        mu_prev = st["mu"]
        mu_local = b1 * mu_prev + (1 - b1) * g

        # one-time scaling coefficients on entry to the compression phase
        # (lamb.py:169-184): equalise each tensor's momentum scale around
        # the united mean so that one flat sign-compression fits them all
        m_scale = self._leaf_norms(mu_prev[:self.n]) \
            / torch.sqrt(self.leaf_sizes)
        m_scale = m_scale.clamp_min(1e-30)
        united = m_scale.mean()
        scaling = torch.where(st["scaling"][0] == 0, united / m_scale,
                              st["scaling"])
        scale_flat = torch.ones((self.npad,), dtype=torch.float32,
                                device=p.device)
        scale_flat[:self.n] = self._bcast(scaling)

        red, we, se = compressed_allreduce(
            mu_local * scale_flat, st["worker_error"], st["server_error"],
            group)
        mu = red / scale_flat

        # fresh-variance update from the reconstructed gradient
        # (lamb.py:352-356)
        grad_recon = (mu - b1 * mu_prev) / (1 - b1)
        nu_fresh = b2 * st["nu_fresh"] + (1 - b2) * grad_recon * grad_recon

        denom = torch.sqrt(st["nu"][:self.n]) + self.eps
        denom_real = torch.sqrt(nu_fresh[:self.n]) + self.eps
        update_prelim = mu[:self.n] / denom
        if self.weight_decay > 0.0:
            update = update_prelim + self.weight_decay * p
        else:
            update = update_prelim

        factor = self._seg_max(denom / denom_real)
        if self.weight_decay > 0.0:
            ratio = torch.clamp(
                self._leaf_norms(update_prelim)
                / self._leaf_norms(update).clamp_min(1e-30), max=1.0)
            factor = factor * ratio + (1.0 - ratio)
        factor = factor.clamp(self.factor_min, self.factor_max)
        factor = torch.minimum(torch.maximum(
            factor, st["last_factor"] * (1.0 - self.factor_threshold)),
            st["last_factor"] * (1.0 + self.factor_threshold))
        coeff = st["coeff_freeze"] * factor
        new_p = p - lr * self._bcast(coeff) * update
        st.update(mu=mu, nu_fresh=nu_fresh, worker_error=we, server_error=se,
                  scaling=scaling, last_factor=factor)
        return new_p, st
