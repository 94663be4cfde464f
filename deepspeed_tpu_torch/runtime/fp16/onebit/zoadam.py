"""0/1 Adam (reference: deepspeed/runtime/fp16/onebit/zoadam.py:14, paper
arxiv 2202.06009).

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/zoadam.py``. Three
regimes, all scheduled on the host (``ZeroOnePolicy`` mirrors the
reference's ``var_interval`` / ``local_step_interval`` counters):

  * variance steps (before the freeze, step % var_interval == 0): the
    dp-mean gradient updates BOTH moments; the interval doubles every
    ``var_update_scaler`` of them (zoadam.py:289-296);
  * compressed-gradient steps (before the freeze, otherwise): the gradient
    itself is 1-bit all-reduced and folded into the momentum only
    (zoadam.py:215-227);
  * after ``var_freeze_step``: local steps, in which each rank applies its
    own momentum update with no communication, accumulating the applied
    update; every ``local_step_interval`` steps the accumulated update is
    scaled back to momentum space, 1-bit all-reduced, and used to
    re-synchronise the params and rebuild the momentum
    (zoadam.py:252-273).

The master stays replicated: each rank keeps a ``delta`` (its divergence
during local steps) and the effective params are ``master + delta``. The
master only ever changes by amounts that are the same on every rank (the
dense mean, the compressed all-reduce's result), so it stays replicated
without a broadcast. ``eval_batch`` and a checkpoint's master read the
master, which trails the ranks' effective params by up to
``local_step_interval`` local updates, as in the TPU package.
"""

from __future__ import annotations

import torch

from ....comm import comm
from ....comm.compressed import compressed_allreduce, padded_size
from .adam import _zeros


class ZeroOnePolicy:
    """Host-side mirror of the reference's interval counters
    (zoadam.py:289-305, 172-186). Call ``next()`` once per applied step."""

    def __init__(self, var_freeze_step=100000, var_update_scaler=16,
                 local_step_scaler=32678, local_step_clipper=16):
        self.var_freeze_step = var_freeze_step
        self.var_update_scaler = var_update_scaler
        self.local_step_scaler = local_step_scaler
        self.local_step_clipper = local_step_clipper
        self.step = 0
        self.var_interval = 1
        self.var_counter = 0
        self.local_interval = 1
        self.local_counter = 0
        self.frozen = False
        self._errors_reinit = False

    def next(self):
        """Advance one step; returns (mode, actions) where mode is one of
        dense | grad_comp | local | sync and actions may hold
        'reinit_errors' (the reference zeroes the error buffers when it
        enters the local-step regime, since they switch metrics,
        zoadam.py:306-313)."""
        self.step += 1
        actions = ()
        if not self.frozen:
            mode = "dense" if self.step % self.var_interval == 0 else "grad_comp"
            if self.step % self.var_interval == 0:
                self.var_counter += 1
                if self.var_counter == self.var_update_scaler:
                    self.var_counter = 0
                    self.var_interval *= 2
            if self.step > self.var_freeze_step:
                self.frozen = True
        else:
            if not self._errors_reinit:
                actions = ("reinit_errors",)
                self._errors_reinit = True
            mode = "sync" if self.step % self.local_interval == 0 else "local"
            self.local_counter += 1
            if self.local_counter == self.local_step_scaler:
                self.local_counter = 0
                self.local_interval = min(self.local_step_clipper,
                                          self.local_interval * 2)
        return mode, actions


class ZeroOneAdam:
    KEYS = ("lr", "betas", "eps", "weight_decay", "var_freeze_step",
            "var_update_scaler", "local_step_scaler", "local_step_clipper")

    def __init__(self, n: int, world: int, leaf_slices=None, *,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, var_freeze_step: int = 100000,
                 var_update_scaler: int = 16, local_step_scaler: int = 32678,
                 local_step_clipper: int = 16, device="cpu"):
        self.n = n
        self.world = world
        self.npad = padded_size(n, world)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.device = torch.device(device)
        self.policy = ZeroOnePolicy(var_freeze_step, var_update_scaler,
                                    local_step_scaler, local_step_clipper)

    def mode_for(self, step: int) -> str:
        # the policy is stateful: the runner calls it once a step, in order
        self._mode, self._actions = self.policy.next()
        assert self.policy.step == step, (
            f"ZeroOneAdam policy out of sync: policy step {self.policy.step}, "
            f"engine step {step}")
        return self._mode

    def transition_actions(self, step: int):
        return self._actions

    def comm_is_compressed(self, mode: str) -> bool:
        return mode in ("grad_comp", "sync")

    def init_state(self):
        return {
            "mu": _zeros(self.npad, self.device),
            "nu": _zeros(self.npad, self.device),
            "delta": _zeros(self.n, self.device),    # this rank's divergence
            "lrs": torch.zeros((), dtype=torch.float32, device=self.device),
            "worker_error": _zeros(self.npad, self.device),
            "server_error": _zeros(self.npad // self.world, self.device),
        }

    def effective_params(self, st, p_flat):
        return p_flat + st["delta"]

    @torch.no_grad()
    def step(self, mode: str, g: torch.Tensor, st, p: torch.Tensor,
             lr, count, group):
        b1, b2 = self.betas
        st = dict(st)
        if mode == "dense":
            g = comm.all_reduce(g.clone(), "avg", group=group)
            st["nu"] = b2 * st["nu"] + (1 - b2) * g * g
            st["mu"] = b1 * st["mu"] + (1 - b1) * g
        elif mode == "grad_comp":
            g_red, we, se = compressed_allreduce(
                g, st["worker_error"], st["server_error"], group)
            st.update(mu=b1 * st["mu"] + (1 - b1) * g_red,
                      worker_error=we, server_error=se)
        else:  # local / sync: momentum from the LOCAL gradient, no comm yet
            st["mu"] = b1 * st["mu"] + (1 - b1) * g
            st["lrs"] = st["lrs"] + lr

        denom = torch.sqrt(st["nu"][:self.n]) + self.eps
        update = st["mu"][:self.n] / denom
        if self.weight_decay > 0.0:
            update = update + self.weight_decay * self.effective_params(st, p)

        if mode in ("dense", "grad_comp"):
            return p - lr * update, st

        # local regime: apply to this rank's delta, master untouched
        st["delta"] = st["delta"] - lr * update
        if mode == "local":
            return p, st

        # sync (zoadam.py:252-273): exchange the accumulated update in
        # momentum space, rebuild the momentum, fold the averaged update
        # into the replicated master, zero the divergence
        buf = _zeros(self.npad, p.device)
        buf[:self.n] = st["delta"] * denom
        red, we, se = compressed_allreduce(
            buf, st["worker_error"], st["server_error"], group)
        st.update(mu=-red / st["lrs"],
                  worker_error=we, server_error=se,
                  delta=torch.zeros_like(st["delta"]),
                  lrs=torch.zeros((), dtype=torch.float32, device=p.device))
        return p + red[:self.n] / denom, st
