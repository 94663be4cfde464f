"""Engine integration for the 1-bit optimizers.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/integration.py``. The
dense engine all-reduces every micro-batch's gradients over dp; compressed
communication needs control of that reduction, so a 1-bit step goes
through this runner instead: each rank runs the gas micro-batches on its
rows and keeps its gradient LOCAL, and the optimizer's ``step(mode, ...)``
decides what crosses the wire: a dense mean in warmup, or the
error-feedback 1-bit exchange in the compression phase.

The phase is chosen on the host from the count of applied updates (the
reference's ``freeze_key`` control flow, fp16/onebit/adam.py:256). The
master is one flat f32 vector of every leaf in leaf order, the same on
every rank; each rank keeps its own optimizer state (momentum, error
buffers, 0/1 Adam's divergence ``delta``), as each TPU device holds its
row of the stacked state. The flat order is the TPU package's where the
module names the flax leaves its parameters come from (``flax_leaves``:
the GPT family): ``jax.tree.leaves`` order, the blocks stacked into one
leaf, a Dense kernel ``[in, out]`` (:func:`flat_layout`). The 1-bit
exchange's server chunks and scales, and OneBitLamb's per-leaf ratios,
are then over the same groups of elements as in the TPU package. The
module's f32 parameters are copied out of the master after each step.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Any, Dict, List

import numpy as np
import torch

from . import ONEBIT_OPTIMIZERS
from ....comm import comm
from ....comm.compressed import wire_bytes_compressed, wire_bytes_dense
from ....utils.logging import log_dist

# optimizer params the reference takes and the TPU runner drops
# (integration.py:76-78): neither applies them
_DROPPED = ("cuda_aware", "comm_backend_name", "bias_correction",
            "eps_inside_sqrt", "max_grad_norm", "amsgrad")


def _file(ckpt_dir: str, rank: int) -> str:
    return os.path.join(ckpt_dir, f"onebit_states_dp{rank}.npz")


def _jax_index(leaf, idx: torch.Tensor) -> torch.Tensor:
    """``convert.FlaxLeaf.jax_index`` on a tensor of flat indices into the
    port parameter: their flat indices into the flax leaf."""
    inner = leaf.shape[1:] if leaf.layer is not None else leaf.shape
    if leaf.transposed:                        # port [..., out, in]
        n_in, n_out = inner[-2:]
        lead, rest = idx // (n_in * n_out), idx % (n_in * n_out)
        idx = lead * (n_in * n_out) + (rest % n_in) * n_out + rest // n_in
    if leaf.layer is not None:
        idx = idx + leaf.layer * math.prod(inner)
    return idx


def flat_layout(module, device):
    """(leaf_slices, perm) of the module's parameters in one flat vector.
    Where the module names its parameters' flax leaves (``flax_leaves``)
    and they tile those leaves exactly: the TPU package's leaves in
    ``jax.tree.leaves`` order (sorted paths), and ``perm[i]`` the position
    of element i of the parameters (flattened in order) in that layout.
    Otherwise each parameter is a leaf, in order, and perm is None."""
    named = list(module.named_parameters())
    bounds = np.cumsum([0] + [p.numel() for _, p in named])
    plain = [(int(bounds[i]), int(bounds[i + 1])) for i in range(len(named))]
    own = getattr(module, "flax_leaves", None)
    leaves = own() if own is not None else {}
    if set(leaves) != {n for n, _ in named}:
        return plain, None
    shapes = {}
    for leaf in leaves.values():
        shapes.setdefault(leaf.path, leaf.shape)
    order = sorted(shapes, key=lambda path: tuple(path.split("/")))
    offsets, slices, off = {}, [], 0
    for path in order:
        offsets[path] = off
        slices.append((off, off + math.prod(shapes[path])))
        off += math.prod(shapes[path])
    n = int(bounds[-1])
    if off != n:
        return plain, None
    perm = torch.empty(n, dtype=torch.int64, device=device)
    for (name, p), (s, e) in zip(named, plain):
        leaf = leaves[name]
        perm[s:e] = offsets[leaf.path] + _jax_index(
            leaf, torch.arange(e - s, device=device))
    seen = torch.zeros(n, dtype=torch.bool, device=device)
    seen[perm] = True
    if not bool(seen.all()):
        return plain, None
    return slices, perm


class OnebitRunner:
    def __init__(self, engine, kind: str, opt_params: dict):
        self.engine = engine
        for axis, n in (("tp", engine.mp_world_size),
                        ("ep", engine.ep_world_size),
                        ("sp", engine.sp_world_size)):
            if n != 1:
                raise ValueError(
                    f"1-bit optimizers communicate over the dp axis only; "
                    f"mesh has {axis}={n} (reference parity: 1-bit "
                    f"Adam/LAMB are pure-DP optimizers)")
        if engine.fp16_enabled and engine.dynamic_loss_scale:
            raise ValueError(
                "1-bit optimizers need a deterministic phase schedule: "
                "DYNAMIC fp16 loss scaling skips steps data-dependently and "
                "re-scales mid-run, which desynchronizes the error-feedback "
                "buffers across ranks. Use a static loss_scale or bf16.")
        if engine.gradient_clipping():
            raise ValueError(
                "gradient_clipping is unsupported with 1-bit optimizers: in "
                "the compression phase gradients are never globally "
                "materialized (only compressed momentum crosses the wire), "
                "so a global-norm clip cannot be computed. Disable clipping "
                "or use a dense optimizer.")
        if engine.zero_stage > 1:
            raise ValueError(
                "1-bit optimizers are incompatible with ZeRO stage >= 2 "
                "(reference constraint): momentum is the communicated "
                "quantity and must stay whole per rank")
        # fp16 static scale: a rank-wide finite check skips the whole update
        # on overflow, so a stray inf never enters the error buffers
        self._finite_guard = engine.fp16_enabled
        self.group = engine._dp_group
        self.world = engine.dp_world_size
        self.kind = kind

        params = dict(opt_params)
        self.lr = params.pop("lr", 1e-3)
        for k in _DROPPED:
            params.pop(k, None)
        cls = ONEBIT_OPTIMIZERS[kind]
        unknown = sorted(set(params) - set(cls.KEYS))
        if unknown:
            raise ValueError(f"optimizer params {unknown} are not {kind} "
                             f"params (valid: {list(cls.KEYS)} and the "
                             f"reference's unused {list(_DROPPED)})")

        # the flat f32 master in the layout of flat_layout
        module = engine.module
        self.leaf_slices, self.perm = flat_layout(module, engine.device)
        self.n = sum(p.numel() for p in module.parameters())
        self.master = self._layout(torch.cat(
            [p.detach().reshape(-1).float() for p in module.parameters()]))
        self.opt = cls(self.n, self.world, self.leaf_slices,
                       device=engine.device, **params)
        self.state = self.opt.init_state()
        self.step = 0              # steps taken (applied or skipped)
        self.skipped = 0
        self.comm_bytes = {"dense": 0, "compressed": 0}
        self.last_mode = None          # the last step's mode
        log_dist(f"1-bit runner: {kind} n={self.n} world={self.world} "
                 f"npad={self.opt.npad}", ranks=[0])

    # ---- layouts -------------------------------------------------------------------
    def _layout(self, flat: torch.Tensor, npad: int = 0) -> torch.Tensor:
        """Parameter order -> the master's layout (zero-padded to npad)."""
        out = torch.zeros(max(npad, self.n), dtype=torch.float32,
                          device=flat.device)
        if self.perm is None:
            out[:self.n] = flat
        else:
            out.index_copy_(0, self.perm, flat)
        return out

    def _params_order(self, flat: torch.Tensor) -> torch.Tensor:
        """The master's layout -> parameter order."""
        return flat[:self.n] if self.perm is None else flat[self.perm]

    def _copy_to(self, params, flat: torch.Tensor) -> None:
        """``flat`` (the master's layout) into ``params`` (parameter
        order)."""
        flat = self._params_order(flat)
        with torch.no_grad():
            torch._foreach_copy_(params, [f.view_as(p) for f, p in zip(
                flat.split([p.numel() for p in params]), params)])

    # ---- the engine's compute copy --------------------------------------------
    def setup_compute(self) -> None:
        """The compute copy of the engine. At f32 compute it is the module
        itself, except under 0/1 Adam, whose ranks run master + delta while
        the module holds the master."""
        eng = self.engine
        eng.master = list(eng.module.parameters())
        eng._partitioned = False
        eng._opt_params = eng.master
        eng._module_stale = False
        if eng.compute_dtype == torch.float32 and self.kind != "zerooneadam":
            eng.compute_module = eng.module
        else:
            eng.compute_module = copy.deepcopy(eng.module).to(
                dtype=eng.compute_dtype)
        eng._compute_params = list(eng.compute_module.parameters())
        eng._dense_params = list(enumerate(eng._compute_params))
        eng._compute_stale = eng.compute_module is not eng.module
        eng.acc = []

    @property
    def count(self) -> int:
        """Applied updates so far."""
        return self.step - self.skipped

    def _lr(self, count: int):
        sched = self.engine.lr_scheduler
        return sched.lr_at(count) if sched is not None else self.lr

    # ---- one step ------------------------------------------------------------------
    def _local_grad(self, micros, p_eff):
        """The gas micro-batches at this rank on ``p_eff`` (cast to the
        compute copy): (sum of the scaled losses, this rank's mean grad
        zero-padded to npad)."""
        eng = self.engine
        scale = eng._scale.cur_scale
        if eng.compute_module is not eng.module:
            self._copy_to(eng._compute_params, p_eff)
        grad = torch.zeros(self.n, dtype=torch.float32, device=eng.device)
        acc = [a.view_as(q) for a, q in zip(
            grad.split([q.numel() for q in eng._compute_params]),
            eng._compute_params)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=eng.device)
        for batch in micros:
            loss = eng._loss_of(eng._to_device(batch)).float() * scale
            loss.backward()
            with torch.no_grad():
                held = [(a, q.grad.float()) for a, q in
                        zip(acc, eng._compute_params) if q.grad is not None]
                if held:
                    torch._foreach_add_([a for a, _ in held],
                                        [g for _, g in held])
                for q in eng._compute_params:
                    q.grad = None
            loss_sum += loss.detach()
        grad.div_(len(micros) * scale)
        return loss_sum, self._layout(grad, self.opt.npad)

    def train_batch(self, micros) -> Dict[str, Any]:
        """One optimizer step over this rank's gas micro-batches."""
        eng = self.engine
        count = self.count + 1
        mode = self.opt.mode_for(count)
        for action in self.opt.transition_actions(count):
            if action == "reinit_errors":
                for k in ("worker_error", "server_error"):
                    self.state[k] = torch.zeros_like(self.state[k])
                log_dist("0/1 Adam: error buffers reinitialized for the "
                         "local-step regime", ranks=[0])
        gas = len(micros)
        p_eff = self.opt.effective_params(self.state, self.master)
        loss_sum, g = self._local_grad(micros, p_eff)
        del p_eff
        finite = True
        if self._finite_guard:
            # overflow on ANY rank skips the whole update: the master,
            # moments and error buffers stay as they were
            flag = torch.isfinite(g).all().float()
            finite = bool(comm.all_reduce(flag, "min", group=self.group))
        if finite:
            self.master, self.state = self.opt.step(
                mode, g, self.state, self.master, self._lr(count), count,
                self.group)
            self._copy_to(eng.master, self.master)
            self._account_comm(mode)
        self.step += 1
        if not finite:
            self.skipped += 1
            eng.skipped_steps += 1
            # the policy advanced for a step that was not applied
            self.restore_step(self.count)
        eng._compute_stale = eng.compute_module is not eng.module
        gas_scale = gas * eng._scale.cur_scale
        loss = comm.all_reduce(loss_sum / gas_scale, "avg", group=self.group)
        sq = torch.sum(g * g)
        gnorm = comm.all_reduce(sq, "avg", group=self.group).sqrt()
        eng._last_grad_norm = gnorm
        self.last_mode = mode
        return {"loss": loss, "grad_norm": gnorm, "finite": finite}

    def restore_step(self, step: int) -> None:
        """Re-align the host-side phase state to ``step`` applied updates
        (after a checkpoint load, or a skipped step): stateful policies
        (0/1 Adam's interval counters) are replayed to the same step."""
        policy = getattr(self.opt, "policy", None)
        if policy is not None:
            fresh = type(policy)(policy.var_freeze_step,
                                 policy.var_update_scaler,
                                 policy.local_step_scaler,
                                 policy.local_step_clipper)
            for _ in range(step):
                fresh.next()
            # resuming inside the local-step regime: the checkpointed error
            # buffers already track the accumulated-momentum metric, so the
            # next step does not zero them again
            fresh._errors_reinit = fresh.frozen
            self.opt.policy = fresh

    def _account_comm(self, mode: str) -> None:
        """Wire bytes a rank (the volume the reference's 26x claim is
        published on)."""
        if self.opt.comm_is_compressed(mode):
            self.comm_bytes["compressed"] += wire_bytes_compressed(
                self.opt.npad, self.world)
        elif mode in ("warmup", "dense"):
            self.comm_bytes["dense"] += wire_bytes_dense(self.n, self.world)
        # "local" steps move zero bytes

    def compression_ratio(self) -> float:
        """Dense-equivalent bytes / actual bytes so far."""
        actual = self.comm_bytes["dense"] + self.comm_bytes["compressed"]
        if actual == 0:
            return float("inf")
        return self.step * wire_bytes_dense(self.n, self.world) / actual

    # ---- checkpoints ---------------------------------------------------------------
    def save(self, ckpt_dir: str) -> None:
        """This rank's state to its own file under ``ckpt_dir``."""
        os.makedirs(ckpt_dir, exist_ok=True)
        np.savez(_file(ckpt_dir, self.group.rank), kind=np.asarray(self.kind),
                 world=np.asarray(self.world),
                 **{k: v.cpu().numpy() for k, v in self.state.items()})

    def load(self, ckpt_dir: str) -> None:
        """This rank's state from its own file under ``ckpt_dir``."""
        path = _file(ckpt_dir, self.group.rank)
        if not os.path.exists(path):
            raise ValueError(f"{ckpt_dir} holds no 1-bit optimizer state for "
                             f"dp rank {self.group.rank} (saved by another "
                             f"optimizer?)")
        with np.load(path, allow_pickle=False) as f:
            kind, world = str(f["kind"]), int(f["world"])
            if (kind, world) != (self.kind, self.world):
                raise ValueError(
                    f"the checkpoint holds {kind} state of {world} dp ranks; "
                    f"this engine runs {self.kind} over {self.world} (each "
                    f"rank's error buffers and momentum are its own, so a "
                    f"1-bit checkpoint loads at its own dp only)")
            self.state = {k: torch.from_numpy(f[k].copy()).to(
                self.engine.device) for k in self.state}

    def realign(self, meta: Dict[str, Any]) -> None:
        """The step counters and the host-side policy of a loaded run: the
        phase is keyed on applied updates (step - skipped)."""
        self.step = int(meta["global_steps"])
        self.skipped = int(meta.get("skipped_steps", 0) or 0)
        self.restore_step(self.count)

    def load_master(self, names: List[str], master: Dict[str, np.ndarray]
                    ) -> None:
        """The module's f32 parameters and the flat master from a
        checkpoint's whole arrays (by parameter name)."""
        eng = self.engine
        with torch.no_grad():
            for name, p in zip(names, eng.master):
                p.copy_(torch.from_numpy(np.asarray(master[name])))
            self.master = self._layout(torch.cat(
                [p.reshape(-1) for p in eng.master]))
        eng._compute_stale = eng.compute_module is not eng.module
