"""1-bit Adam (reference: deepspeed/runtime/fp16/onebit/adam.py:14).

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/adam.py``. Warmup
(applied updates <= freeze_step): Adam without bias correction on the
dp-mean gradient, building up the variance. Compression phase: the
variance is frozen, each rank folds its LOCAL gradient into the momentum,
and the momentum itself crosses the wire in the error-feedback 1-bit
all-reduce (the reference's ``adam_freeze_key`` branch, adam.py:196-236).

Works on the flat padded f32 vector the ``OnebitRunner`` keeps; ``step``
runs on every rank with that rank's gradient and state.
"""

from __future__ import annotations

import torch

from ....comm import comm
from ....comm.compressed import compressed_allreduce, padded_size


def _zeros(m: int, device) -> torch.Tensor:
    return torch.zeros((m,), dtype=torch.float32, device=device)


class OnebitAdam:
    """Per-rank 1-bit Adam over a flat parameter vector."""

    KEYS = ("lr", "betas", "eps", "weight_decay", "freeze_step")

    def __init__(self, n: int, world: int, leaf_slices=None, *,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100000,
                 device="cpu"):
        self.n = n
        self.world = world
        self.npad = padded_size(n, world)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.freeze_step = freeze_step
        self.device = torch.device(device)

    # ---- host-side phase policy (reference adam_freeze_key, adam.py:256-262)
    def mode_for(self, step: int) -> str:
        return "warmup" if step <= self.freeze_step else "comp"

    def transition_actions(self, step: int):
        return ()

    def comm_is_compressed(self, mode: str) -> bool:
        return mode == "comp"

    # ---- state --------------------------------------------------------------
    def init_state(self):
        """This rank's state."""
        return {
            "mu": _zeros(self.npad, self.device),
            "nu": _zeros(self.npad, self.device),
            "worker_error": _zeros(self.npad, self.device),
            "server_error": _zeros(self.npad // self.world, self.device),
        }

    def effective_params(self, st, p_flat):
        return p_flat

    # ---- per-rank step ------------------------------------------------------
    @torch.no_grad()
    def step(self, mode: str, g: torch.Tensor, st, p: torch.Tensor,
             lr, count, group):
        """g: [npad] this rank's mean gradient (zero-padded); p: [n] f32
        params. Returns (new_p, new_state)."""
        b1, b2 = self.betas
        st = dict(st)
        if mode == "warmup":
            g = comm.all_reduce(g.clone(), "avg", group=group)
            st["mu"] = b1 * st["mu"] + (1 - b1) * g
            st["nu"] = b2 * st["nu"] + (1 - b2) * g * g
        else:
            # local momentum update, then 1-bit all-reduce of the momentum
            mu = b1 * st["mu"] + (1 - b1) * g
            mu, we, se = compressed_allreduce(
                mu, st["worker_error"], st["server_error"], group)
            st.update(mu=mu, worker_error=we, server_error=se)
        update = st["mu"][:self.n] / (torch.sqrt(st["nu"][:self.n])
                                      + self.eps)
        if self.weight_decay > 0.0:
            update = update + self.weight_decay * p
        return p - lr * update, st
