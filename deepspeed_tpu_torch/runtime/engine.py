"""The training engine, dense path.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (reference
``DeepSpeedEngine``, deepspeed/runtime/engine.py:175). The TPU engine
compiles a whole step into one program; here the same step runs eagerly,
one process per rank of the device mesh (``torch.distributed``, through
``comm``):

  * fp32 master params (the module's own parameters) and an fp32 gradient
    accumulator. Once per step the master is cast to the compute dtype into
    a compute copy of the module (``_cast_params``, hoisted out of the micro
    loop as in the TPU engine); each micro-batch runs forward and backward
    on that copy (over dp ranks: on this rank's rows of the global
    micro-batch) and adds its grads into the accumulator, cast to
    ``communication_data_type``, all-reduced over dp in one flat buffer and
    widened back to f32, as the TPU engine's grads cross dp;
  * at the boundary (``_apply_update``): divide by ``scale * gas * dp``
    (and ``gradient_predivide_factor`` under ``prescale_gradients``), take
    the global norm, clip to ``gradient_clipping``, step the optimizer
    (Adam, LAMB, Adagrad or SGD), skip the step on non-finite grads (fp16
    only: the overflow flag is read on the host, as the reference does),
    update the loss scale and zero the accumulator;
  * ZeRO stage 0 keeps the optimizer state whole on every rank. Stage 1
    over dp > 1 gives each rank one contiguous slice of every flattened
    leaf's fp32 master and moments (``sharding.py``): the rank steps its
    slices and the updated slices are all-gathered into the compute copy in
    the compute dtype. The module's fp32 parameters then lag behind the
    slices until ``consolidated_fp32_state_dict`` or a checkpoint gathers
    them (at f32 compute the compute copy is the module and never lags);
  * stage 2 over dp > 1 reduce-scatters each micro-step's grads (one flat
    buffer, in ``communication_data_type``) into this rank's slice of the
    accumulator, which shrinks to 1/dp, and frees the module's fp32
    parameters (the slices are the master); stage 3 also partitions the
    compute parameters above ``param_persistence_threshold``: each block
    all-gathers its own before it runs and reduce-scatters their grads in
    its backward (``zero/stage3.py``);
  * ZeRO-Offload (``offload_optimizer`` cpu or nvme, ``_init_offload``):
    the card holds only the compute-dtype parameters and the fp32 grad
    accumulator. At the boundary the grads' global norm and finite flag
    are read on the host, each leaf's grad slice streams to page-locked
    host memory on a side stream, the native CPU Adam steps it as soon as
    it has arrived (``zero/offload.py``, master and moments in DRAM or on
    NVMe) and its 16-bit mirror streams back. With ``offload_param`` the
    parameters leave the card between steps and are rebuilt from the
    mirrors at the next step's start. A module built on the meta device
    (``zero.abstract_init``) is taken only here: each rank fills its own
    master slices from the counter-based init;
  * the layer-streamed tier (``offload_param.layer_streaming``, one rank):
    the card holds one block's parameters at a time, fetched from the
    mirrors by ``zero/layer_stream.py``, and nothing of the model between
    steps; the host steps every leaf;
  * ``activation_checkpointing.cpu_checkpointing`` flips the model's
    ``cpu_checkpointing`` (each remat block's input waits in host memory);
  * ``save_checkpoint`` / ``load_checkpoint`` in the TPU engine's npz and
    host-sharded layouts (``checkpoint/saving.py``);
  * the device mesh (``parallel/mesh.py``) from the config's ``mesh``:
    ``dp`` and ``ep``. dp is the mesh's dp axis (world / ep): the batch,
    the ZeRO partitions and every gradient reduction are over the dp group.
    Over ``ep > 1`` each rank holds its ep coordinate's share of every
    expert bank (``moe.set_expert_parallel``) and the ep partners of a dp
    shard see the same rows, so their loss is the same loss: grads reduce
    over dp only, expert and shared leaves alike. An MoE model's calls
    route the dp group's tokens together, as the TPU program routes the
    global batch; the training gate draws from one generator seeded
    alike on every rank (``seed``). The global grad norm and a checkpoint
    take the expert leaves whole, gathered over ep, so a checkpoint saved
    at one ep degree loads at another. Over ``sp > 1`` (a GPT with
    ``sequence_parallel``, ``models.gpt.set_sequence_parallel``) every
    rank holds the whole parameters and takes its dp rows and its sp
    columns of each global batch (the TPU ``_shard_batch``); the shifted
    labels come from the whole row before it is cut, the loss is the sp
    group's token mean, and the grads are summed over sp and averaged over
    dp (one all-reduce over the dp x sp group). ZeRO partitions over dp
    only, and a checkpoint, of whole leaves, loads at any sp degree;
  * the 1-bit optimizers (OneBitAdam, ZeroOneAdam, OneBitLamb) step
    through ``fp16/onebit/integration.OnebitRunner``: each rank keeps its
    gradient local (no dp all-reduce of grads) and the optimizer decides
    what crosses the wire, a dense mean in warmup or the 1-bit exchange of
    ``comm/compressed.py`` after it. The master stays whole and the same on
    every rank; each rank's optimizer state goes to its own checkpoint
    file beside the npz master.

What the TPU engine supports beyond that raises ``NotImplementedError``
naming its ROADMAP item; a parsed knob never silently does nothing.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..checkpoint import saving as ckpt_saving
from ..comm import comm
from ..comm.coalesced_collectives import all_gather_coalesced
from ..module_inject.layers import reduce_from_tp
from ..moe.layer import moe_layers, set_expert_parallel
from ..moe.utils import is_moe_param
from ..parallel import mesh as mesh_lib
from ..ops.adam import fused_adagrad, fused_adam
from ..ops.lamb import fused_lamb
from ..ops.sgd import sgd
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .config import DeepSpeedConfig
from .constants import OFFLOAD_CPU, OFFLOAD_NONE, OFFLOAD_NVME
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import grads_finite, make_loss_scale_state, \
    update_scale
from .lr_schedules import build_lr_scheduler
from .sharding import ShardingRules, TpSplit, tp_split
from .zero.partition_params import flax_leaves, is_abstract_tree
from .zero.stage3 import GatherUnit, partition_module, scatter_into

_ADAM_TYPES = ("adam", "adamw", "fusedadam")
_ADAM_KEYS = ("lr", "betas", "eps", "weight_decay", "bias_correction",
              "adam_w_mode", "torch_adam")
_OPTIMIZER_KEYS = {
    **{t: _ADAM_KEYS for t in _ADAM_TYPES},
    "lamb": ("lr", "betas", "eps", "weight_decay", "bias_correction",
             "max_coeff", "min_coeff"),
    "adagrad": ("lr", "eps", "weight_decay"),
    "sgd": ("lr", "momentum", "weight_decay"),
}
_ONEBIT_TYPES = ("onebitadam", "onebitlamb", "zerooneadam")
_COMM_DTYPES = {"fp16": torch.float16, "float16": torch.float16,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "fp32": None, "float32": None}


class _ArrivingGrads:
    """The offload step's grads: ``[i]`` waits for leaf i's copy to the
    host (its event) and returns its staging view; the time spent waiting
    is added to ``timing["d2h_wait_s"]`` when timed."""

    def __init__(self, staging, events, timing=None):
        self.staging, self.events, self.timing = staging, events, timing

    def __getitem__(self, i):
        t0 = time.perf_counter()
        self.events[i].synchronize()
        if self.timing is not None:
            self.timing["d2h_wait_s"] = (self.timing.get("d2h_wait_s", 0.0)
                                         + time.perf_counter() - t0)
        return self.staging[i]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what}: not ported to PyTorch yet (ROADMAP {item})")


def _build_mesh(raw) -> "mesh_lib.DeviceMesh":
    """The engine's device mesh from the config's ``mesh`` block (dp fills
    the world). A pp axis raises: the TPU dense engine has no stages, and a
    pipeline's come from ``PipelineModule(num_stages=)``."""
    if isinstance(raw, str):
        with open(raw) as fh:
            raw = json.load(fh)
    m = dict((raw or {}).get("mesh") or {})
    if m.get("pp", 1) != 1:
        raise ValueError(
            f"a pp mesh (pp={m['pp']}) given to the dense engine: pipelining "
            f"needs a runtime.pipe.PipelineModule, whose num_stages the "
            f"PipelineEngine lays over the mesh's pp axis")
    shape = mesh_lib.MeshShape.infer(comm.get_world_size(), tp=m.get("tp", 1),
                                     ep=m.get("ep", 1), sp=m.get("sp", 1),
                                     dp=m.get("dp"))
    return mesh_lib.ensure_global_mesh(shape)


class DeepSpeedEngine:
    def __init__(self, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 config=None, loss_fn=None, device="cuda"):
        self.device = resolve_device(device)
        raw = config._raw if isinstance(config, DeepSpeedConfig) else config
        self.mesh = _build_mesh(raw)
        self.dp_world_size = self.mesh.shape["dp"]
        self.dp_rank = self.mesh.coord("dp")
        self.ep_world_size = self.mesh.shape["ep"]
        self.mp_world_size = self.mesh.shape["tp"]
        self.sp_world_size = self.mesh.shape["sp"]
        self._dp_group = comm.new_group("dp", self.mesh)
        self._ep_group = comm.new_group("ep", self.mesh)
        self._tp_group = comm.new_group("tp", self.mesh)
        self._sp_group = comm.new_group("sp", self.mesh)
        # the grads' reduction: summed over sp (each sp rank's grads are
        # its columns' share) and over dp (divided by dp at the update)
        self._grad_group = comm.new_group(("dp", "sp"), self.mesh)
        # every leaf's whole shape, taken before the tp split (empty at tp
        # 1); at most one of ep, tp and sp is above 1
        self._tp_whole: Dict[str, Tuple[int, ...]] = {}
        self.config = DeepSpeedConfig(raw, dp_world_size=self.dp_world_size)
        self._config = self.config            # reference-name parity
        self._reject_unported()
        self.offload_device = self._offload_device()
        self.offload_enabled = self.offload_device != OFFLOAD_NONE

        self.module = self._apply_activation_checkpointing_config(
            self._prepare_module(model, model_parameters))
        self.loss_fn = loss_fn
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print(), device=self.device)

        # ---- precision -------------------------------------------------
        self.compute_dtype = self.config.compute_dtype
        self.fp16_enabled = self.config.fp16.enabled
        self.bfloat16_enabled = self.config.bf16.enabled
        self.dynamic_loss_scale = (self.config.fp16.dynamic_loss_scale
                                   if self.fp16_enabled else False)
        self.zero_stage = self.config.zero_optimization_stage
        self._comm_dtype = self._resolve_comm_dtype()
        if self.config.amp and self.config.amp.get("enabled"):
            raise ValueError(
                "amp is the reference's NVIDIA-Apex integration; use the "
                "fp16 or bf16 config blocks (same mixed-precision "
                "semantics)")
        if self.config.disable_allgather:
            log_dist("disable_allgather is inert: the ZeRO-1 slices are "
                     "all-gathered (per-rank broadcasts would give the same "
                     "weights)", ranks=[0])

        # ---- ZeRO layout -------------------------------------------------
        self._names = [n for n, _ in self.module.named_parameters()]
        self._shapes = [tuple(p.shape) for p in self.module.parameters()]
        # leaves split over a model-parallel group: an expert leaf holds
        # this rank's E / ep experts, a tp-split leaf its tp shard
        self._splits: Dict[int, TpSplit] = {}
        if self.ep_world_size > 1:
            self._split_group = self._ep_group
            self._splits = {i: TpSplit(0, self.ep_world_size)
                            for i, n in enumerate(self._names)
                            if is_moe_param(n)}
        else:
            self._split_group = self._tp_group
            for i, n in enumerate(self._names):
                split = tp_split(n, self._tp_whole.get(n, ()),
                                 self.mp_world_size)
                if split is not None:
                    self._splits[i] = split
        self._split_leaves = sorted(self._splits)
        self._full_shapes = [
            (s[0] * self.ep_world_size,) + s[1:]
            if i in self._splits and self.ep_world_size > 1
            else tuple(self._tp_whole.get(n, s))
            for i, (n, s) in enumerate(zip(self._names, self._shapes))]
        zc = self.config.zero_config
        self._rules = ShardingRules(
            self.dp_world_size, self.zero_stage, self.dp_rank,
            param_persistence_threshold=(zc.param_persistence_threshold
                                         if self.zero_stage >= 3 else 0))
        self._shards = [self._rules.master_spec(n, s)
                        for n, s in zip(self._names, self._shapes)]
        self._grad_shards = [self._rules.grad_spec(n, s)
                             for n, s in zip(self._names, self._shapes)]
        self._param_shards = [self._rules.param_spec(n, s)
                              for n, s in zip(self._names, self._shapes)]
        # bytes this rank moved in each kind of collective (zero/stage3.py
        # and the grad reduction add to it)
        self.comm_bytes: collections.Counter = collections.Counter()
        self._units: List[GatherUnit] = []
        self._pending_loss = None
        self._last_grad_norm: Optional[torch.Tensor] = None
        fp16 = self.config.fp16
        self._scale = make_loss_scale_state(
            static_scale=fp16.loss_scale if self.fp16_enabled else 1.0,
            initial_scale_power=fp16.initial_scale_power,
            hysteresis=fp16.hysteresis)
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None \
            else build_lr_scheduler(self.config.scheduler)
        self._layer_streamer = None
        self._onebit = None
        if self.offload_enabled:
            self._init_offload(optimizer)
        elif self._onebit_type is not None:
            self._init_onebit(optimizer)
        else:
            self._init_dense(optimizer)

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)

        log_dist(
            f"engine ready: device={self.device} zero_stage="
            f"{self.zero_stage} offload={self.offload_device} dtype="
            f"{self.compute_dtype} batch="
            f"{self.train_batch_size()}={self.train_micro_batch_size_per_gpu()}"
            f"x{self.gradient_accumulation_steps()}x{self.dp_world_size}",
            ranks=[0])
        if self.config.dump_state:
            log_dist(f"resolved config: {dataclasses.asdict(self.config)}",
                     ranks=[0])

    def _init_dense(self, optimizer) -> None:
        """fp32 masters (the module's parameters; this rank's slices of
        them over dp > 1 from stage 1 on), the compute copy and the
        accumulator."""
        self.master: List[torch.Tensor] = list(self.module.parameters())
        if optimizer is not None and self._grad_split:
            raise _not_ported(
                f"a client torch.optim optimizer at ZeRO stage "
                f"{self.zero_stage} over dp > 1 (it would need the whole "
                f"grads); use a config-named optimizer", "A13")
        # ZeRO over dp > 1: the optimizer steps this rank's flat slices
        self._partitioned = self._rules.partitioned and optimizer is None
        self._opt_params = ([s.take(p.detach()) for s, p in
                             zip(self._shards, self.master)]
                            if self._partitioned else self.master)
        self._module_stale = False
        if self.compute_dtype == torch.float32:
            self.compute_module = self.module
        else:
            self.compute_module = copy.deepcopy(self.module).to(
                dtype=self.compute_dtype)
        self._compute_params = list(self.compute_module.parameters())
        # the compute copy is fresh; stage >= 1 over dp keeps it fresh
        self._compute_stale = not self._partitioned
        self.acc = self._zero_acc()
        self._dense_params = list(enumerate(self._compute_params))
        shared = self.compute_module is self.module
        if any(s.partitioned for s in self._param_shards):
            self._partition_compute()
        if self._grad_split:
            # stage >= 2: the slices are the master; drop the whole fp32
            # leaves that are not also compute parameters
            held = {i for u in self._units for i, _, _ in u.entries}
            for i, p in enumerate(self.master):
                if not shared or i in held:
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._build_optimizer(optimizer)

    def _init_onebit(self, optimizer) -> None:
        """The 1-bit runner (the TPU engine's ``OnebitRunner``,
        engine.py:421-447): the flat f32 master, this rank's optimizer
        state, the compute copy; no grad accumulator."""
        from .fp16.onebit.integration import OnebitRunner
        if optimizer is not None:
            raise ValueError(
                f"{self.config.optimizer.type} is a config-named 1-bit "
                f"optimizer: do not pass a client torch.optim optimizer too")
        self._onebit = OnebitRunner(self, self._onebit_type,
                                    dict(self.config.optimizer.params))
        self._onebit.setup_compute()
        self.client_optimizer = None
        self.optimizer = self._onebit.opt
        self._base_lr = self._onebit.lr

    @property
    def _grad_split(self) -> bool:
        """Grads reduce-scattered into 1/dp accumulators (stage >= 2)."""
        return self.zero_stage >= 2 and self.dp_world_size > 1

    def _zero_acc(self) -> List[torch.Tensor]:
        """The fp32 grad accumulator: this rank's flat slice of each leaf
        at stage >= 2 over dp, whole leaves otherwise."""
        return [torch.zeros(gs.numel if gs.partitioned else gs.shape,
                            dtype=torch.float32, device=self.device)
                for gs in self._grad_shards]

    def _partition_compute(self) -> None:
        """Stage 3: the compute module's partitioned parameters move into
        gather units (``zero/stage3.py``); the rest stay whole."""
        def make_unit(entries):
            return GatherUnit(entries, dtype=self.compute_dtype,
                              device=self.device, acc=self.acc,
                              comm_dtype=self._comm_dtype,
                              counts=self.comm_bytes)
        leaf_of = {n: i for i, n in enumerate(self._names)}
        self.compute_module, self._units = partition_module(
            self.compute_module, leaf_of, self._param_shards, make_unit)
        held = {i for u in self._units for i, _, _ in u.entries}
        self._dense_params = [(i, p) for i, p in
                              enumerate(self._compute_params)
                              if i not in held]
        # the units hold these leaves now: free their whole compute copies
        for i in held:
            p = self._compute_params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # ------------------------------------------------------------------ init
    def _reject_unported(self) -> None:
        """Every knob the TPU engine honours and this one cannot yet."""
        c = self.config
        zc = c.zero_config
        for what, dev in (("offload_optimizer", zc.offload_optimizer.device),
                          ("offload_param", zc.offload_param.device)):
            if dev not in (OFFLOAD_NONE, OFFLOAD_CPU, OFFLOAD_NVME):
                raise ValueError(f"{what}.device={dev!r}: use none, cpu or "
                                 f"nvme")
        if zc.offload_param.layer_streaming and OFFLOAD_NONE == \
                zc.offload_optimizer.device == zc.offload_param.device:
            raise ValueError(
                "offload_param.layer_streaming requires offload_optimizer "
                "(the host owns master+moments and serves the per-layer "
                "param fetches); a parsed knob must change the program or "
                "error, never silently do nothing")
        for axis, n in (("ep", self.ep_world_size),
                        ("tp", self.mp_world_size),
                        ("sp", self.sp_world_size)):
            if n == 1:
                continue
            tiers = {"ZeRO-3": self.config.zero_optimization_stage >= 3,
                     "offload_optimizer": zc.offload_optimizer.device
                     != OFFLOAD_NONE,
                     "offload_param": zc.offload_param.device != OFFLOAD_NONE}
            on = [name for name, flag in tiers.items() if flag]
            if on:
                raise _not_ported(f"{', '.join(on)} with mesh {axis}={n}",
                                  "A9")
        many = [f"{a}={n}" for a, n in (("ep", self.ep_world_size),
                                        ("tp", self.mp_world_size),
                                        ("sp", self.sp_world_size)) if n > 1]
        if len(many) > 1:
            raise _not_ported(f"a mesh with {' and '.join(many)}", "A9")
        if c.pipeline.stages > 1:
            # the TPU dense engine reads no pipeline block: stages come from
            # PipelineModule(num_stages=), which initialize() hands to the
            # PipelineEngine
            raise ValueError(
                f"pipeline.stages={c.pipeline.stages} given to the dense "
                f"engine: pipelining needs a runtime.pipe.PipelineModule "
                f"(its num_stages sets the stages)")
        otype = (c.optimizer.type if c.optimizer else "Adam").lower()
        self._onebit_type = otype if otype in _ONEBIT_TYPES else None
        if self._onebit_type is not None:
            self._reject_for_onebit()
        elif otype not in _OPTIMIZER_KEYS:
            raise ValueError(f"unknown optimizer type {c.optimizer.type!r}")
        features = {
            "progressive_layer_drop": c.progressive_layer_drop.enabled,
            "curriculum_learning": c.curriculum_learning.enabled,
            "eigenvalue": c.eigenvalue.enabled,
            "quantize_training (MoQ)": c.quantize_training.enabled,
            "flops_profiler": c.flops_profiler.enabled,
            "monitors (tensorboard / wandb / csv_monitor)":
                c.tensorboard.enabled or c.wandb.enabled
                or c.csv_monitor.enabled,
            "bf16.stochastic_rounding": c.bf16.stochastic_rounding,
        }
        on = [name for name, flag in features.items() if flag]
        if on:
            raise _not_ported(", ".join(on), "A13")
        ac = c.activation_checkpointing
        for knob in ("contiguous_memory_optimization",
                     "synchronize_checkpoint_boundary", "profile"):
            if getattr(ac, knob):
                raise ValueError(
                    f"activation_checkpointing.{knob} has no analogue here: "
                    f"remat is the model's cfg.remat / cfg.remat_policy; "
                    f"remove the knob")
        if ac.number_checkpoints is not None:
            raise ValueError(
                "activation_checkpointing.number_checkpoints cannot be "
                "honored: remat granularity is one checkpoint per block; "
                "control the trade with the model's remat_policy")

    def _reject_for_onebit(self) -> None:
        """What the TPU engine refuses beside a 1-bit optimizer, with its
        exception types (engine.py:421-439; the runner checks the mesh, the
        loss scale, clipping and the ZeRO stage)."""
        c = self.config
        zc = c.zero_config
        if OFFLOAD_NONE != zc.offload_optimizer.device or \
                OFFLOAD_NONE != zc.offload_param.device:
            raise ValueError(f"{c.optimizer.type} is incompatible with "
                             "offload_optimizer (reference parity)")
        if c.progressive_layer_drop.enabled or c.quantize_training.enabled:
            raise ValueError(
                "progressive_layer_drop / quantize_training are not wired "
                "into the 1-bit train path; disable them or use a dense "
                "optimizer")
        if c.bf16.stochastic_rounding:
            raise NotImplementedError(
                "bf16.stochastic_rounding with 1-bit optimizers: the 1-bit "
                "step casts master -> compute without a stochastic-rounding "
                "stream, so the knob would silently not apply")

    def _apply_activation_checkpointing_config(self, module: nn.Module
                                               ) -> nn.Module:
        """``activation_checkpointing.cpu_checkpointing`` and
        ``partition_activations`` are flipped on the model's config (the TPU
        engine's rule): the module and every submodule that holds that
        config get the new one."""
        ac = self.config.activation_checkpointing
        flips = {k: True for k in ("cpu_checkpointing",
                                   "partition_activations")
                 if getattr(ac, k)}
        if not flips:
            return module
        cfg = getattr(module, "cfg", None)
        if cfg is None or not dataclasses.is_dataclass(cfg) or \
                not all(hasattr(cfg, k) for k in flips):
            raise ValueError(
                f"activation_checkpointing.{' / '.join(flips)} needs a "
                f"model config that supports it (models.GPT does); got "
                f"module {type(module).__name__}")
        new = dataclasses.replace(cfg, **flips)
        for m in module.modules():
            if getattr(m, "cfg", None) is cfg:
                m.cfg = new
        return module

    def _offload_device(self) -> str:
        """Where the optimizer state lives: ``offload_optimizer.device``;
        ``offload_param`` alone keeps the parameters' masters and mirrors on
        the host too, so it implies the CPU optimizer (said in the log)."""
        zc = self.config.zero_config
        dev = zc.offload_optimizer.device
        if dev == OFFLOAD_NONE and zc.offload_param.device != OFFLOAD_NONE:
            log_dist(f"offload_param.device={zc.offload_param.device} keeps "
                     f"the parameters' fp32 masters on the host: the "
                     f"optimizer steps there too (offload_optimizer cpu)",
                     ranks=[0])
            dev = OFFLOAD_CPU
        return dev

    def _prepare_module(self, model, model_parameters) -> nn.Module:
        if not isinstance(model, nn.Module):
            raise TypeError(
                "model must be a torch.nn.Module (e.g. "
                "deepspeed_tpu_torch.models.gpt.GPT)")
        if is_abstract_tree(model) and not self.offload_enabled:
            raise ValueError(
                "the model is on the meta device (zero.abstract_init): the "
                "dense path needs real weights (build the model on a "
                "device); an abstract model is taken only with "
                "offload_optimizer, where each rank fills its own host "
                "shards")
        if isinstance(model_parameters, Mapping):
            model.load_state_dict(model_parameters)
        elif model_parameters is not None:
            own = {id(p) for p in model.parameters()}
            if any(id(p) not in own for p in model_parameters):
                raise ValueError(
                    "model_parameters must be the model's own parameters "
                    "(model.parameters()) or a state_dict for it")
        if not self.offload_enabled:
            # fp32 masters, in place: Parameter objects (and a client
            # optimizer built over them) are kept; _init_offload moves an
            # offloaded model itself, in compute dtype
            model = model.to(device=self.device, dtype=torch.float32)
            if comm.get_world_size() > 1:
                self._broadcast_master(list(model.parameters()))
        # an MoE model routes the dp group's tokens together; over ep each
        # rank keeps its share of the experts
        set_expert_parallel(
            model, self._ep_group,
            self._dp_group if self.dp_world_size > 1 else None)
        if self.sp_world_size > 1:
            # over sp each rank runs its columns of the whole model
            from ..models.gpt import GPT, set_sequence_parallel
            if not isinstance(model, GPT):
                raise ValueError(
                    f"mesh sp={self.sp_world_size} splits a GPT's sequence; "
                    f"got {type(model).__name__}")
            set_sequence_parallel(model, self._sp_group)
        if self.mp_world_size > 1:
            # over tp each rank keeps its shard of the one whole model
            from ..models.gpt import GPT, set_tensor_parallel
            if not isinstance(model, GPT):
                raise ValueError(
                    f"mesh tp={self.mp_world_size} splits a GPT by its "
                    f"tp_spec; got {type(model).__name__}")
            self._tp_whole = {n: tuple(p.shape)
                              for n, p in model.named_parameters()}
            set_tensor_parallel(model, self._tp_group)
        return model

    def _resolve_comm_dtype(self):
        cdt = self.config.communication_data_type
        if not cdt:
            return None
        if cdt not in _COMM_DTYPES:
            raise ValueError(f"communication_data_type={cdt!r}: use "
                             f"fp16/bf16/fp32")
        return _COMM_DTYPES[cdt]

    def _build_optimizer(self, optimizer) -> None:
        if optimizer is not None:
            if not isinstance(optimizer, torch.optim.Optimizer):
                raise TypeError("optimizer must be a torch.optim.Optimizer")
            if self.zero_stage >= 1 and \
                    not self.config.zero_allow_untested_optimizer:
                raise ValueError(
                    "a client optimizer with ZeRO >= 1 is untested: set "
                    "zero_optimization + zero_allow_untested_optimizer: "
                    "true to accept it, or use a config-named optimizer")
            self.client_optimizer = self.optimizer = optimizer
            self._base_lr = None
            return
        self.client_optimizer = None
        oc = self.config.optimizer
        otype = (oc.type if oc else "Adam").lower()
        params = dict(oc.params) if oc else {}
        valid = _OPTIMIZER_KEYS[otype]
        unknown = sorted(set(params) - set(valid))
        if unknown:
            raise ValueError(f"optimizer params {unknown} are not "
                             f"{oc.type} params (valid: {list(valid)})")
        self._base_lr = params.get("lr", 1e-3)
        sched = self.lr_scheduler
        lr = sched.lr_at if sched is not None else self._base_lr
        betas = tuple(params.get("betas", (0.9, 0.999)))
        wd = params.get("weight_decay", 0.0)
        # the TPU engine's table (engine.py:370-400): eps defaults to 1e-8
        # for Adam and LAMB; Adagrad takes its configured eps (the TPU
        # table always passes 1e-10); SGD has no weight decay there
        if otype in _ADAM_TYPES:
            # torch_adam picks the reference's torch.optim.Adam
            # implementation; the math is the same
            self.optimizer = fused_adam(
                self._opt_params, lr, betas=betas,
                eps=params.get("eps", 1e-8), weight_decay=wd,
                adam_w_mode=params.get("adam_w_mode", otype != "adam"),
                bias_correction=params.get("bias_correction", True))
        elif otype == "lamb":
            self.optimizer = fused_lamb(
                self._opt_params, lr, betas=betas,
                eps=params.get("eps", 1e-8), weight_decay=wd,
                max_coeff=params.get("max_coeff", 10.0),
                min_coeff=params.get("min_coeff", 0.01),
                bias_correction=params.get("bias_correction", True),
                norm_reduce=(self._lamb_norm_reduce if self._partitioned
                             or self._split_leaves else None))
        elif otype == "adagrad":
            self.optimizer = fused_adagrad(
                self._opt_params, lr, eps=params.get("eps", 1e-10),
                weight_decay=wd)
        else:
            if wd:
                raise ValueError(
                    "SGD takes no weight_decay (the TPU engine builds "
                    "optax.sgd without it); remove the key or set it to 0")
            self.optimizer = sgd(self._opt_params, lr,
                                 momentum=params.get("momentum", 0.0))

    # --------------------------------------------------------- ZeRO-Offload
    def _init_offload(self, optimizer) -> None:
        """The host optimizer (master and moments of this rank's slices,
        in DRAM or on NVMe) and, on the card, only the compute-dtype
        parameters and the fp32 grad accumulator (the TPU engine's
        ``_init_offload_state``, engine.py:1415)."""
        from .zero.offload import HostOffloadOptimizer
        if optimizer is not None:
            raise ValueError(
                "offload_optimizer is driven by the config optimizer; do "
                "not pass a client torch.optim optimizer")
        oc = self.config.optimizer
        params = dict(oc.params) if oc else {}
        otype = (oc.type if oc else "Adam").lower()
        if otype not in _ADAM_TYPES + ("cpuadam",):
            raise ValueError(
                f"offload_optimizer steps Adam/AdamW on the CPU, got "
                f"{oc.type!r}")
        unknown = sorted(set(params) - set(_ADAM_KEYS))
        if unknown:
            raise ValueError(f"optimizer params {unknown} are not Adam "
                             f"params (valid: {list(_ADAM_KEYS)})")
        if not params.get("bias_correction", True):
            raise ValueError("the CPU Adam always corrects the moments' "
                             "bias: remove bias_correction: false")
        zc = self.config.zero_config
        streaming = zc.offload_param.layer_streaming
        if streaming:
            if getattr(self.module, "stacked_spec", None) is None:
                raise ValueError(
                    "offload_param.layer_streaming drives the model's "
                    "stacked-trunk structure directly and needs a module "
                    "exposing .stacked_spec(loss_fn) -> StackedPipeSpec "
                    "(models.GPT and models.BertForMaskedLM do; see "
                    "runtime/pipe/spmd.py)")
            if self.dp_world_size > 1:
                raise ValueError(
                    "offload_param.layer_streaming is the SINGLE-chip "
                    "capacity tier (per-layer host fetches); over more "
                    "ranks use ZeRO-3 for capacity instead")
        nvme = (zc.offload_optimizer.nvme_path
                if self.offload_device == OFFLOAD_NVME else None)
        if self.offload_device == OFFLOAD_NVME and not nvme:
            raise ValueError("offload_optimizer.device=nvme requires "
                             "nvme_path")
        op = zc.offload_param
        # the param tier: no parameters on the card between steps
        self._params_resident = op.device == OFFLOAD_NONE
        mirror_nvme = None
        if op.device == OFFLOAD_NVME:
            mirror_nvme = op.nvme_path or (os.path.join(nvme, "params")
                                           if nvme else None)
            if not mirror_nvme:
                raise ValueError("offload_param.device=nvme requires "
                                 "offload_param.nvme_path")
        abstract = is_abstract_tree(self.module)
        named = list(self.module.named_parameters())
        if not abstract:
            named = [(n, self._host_leaf(p)) for n, p in named]
        raw_zero = self.config._raw.get("zero_optimization", {}) or {}
        self._base_lr = params.get("lr", 1e-3)
        self.host_optimizer = HostOffloadOptimizer(
            named, lr=self._base_lr,
            betas=tuple(params.get("betas", (0.9, 0.999))),
            eps=params.get("eps", 1e-8),
            weight_decay=params.get("weight_decay", 0.0),
            adamw=params.get("adam_w_mode", otype != "adam"),
            mirror_dtype=self.compute_dtype, nvme_path=nvme,
            aio_cfg=self.config.aio,
            dp_shard=(self.dp_rank, 1, self.dp_world_size),
            init_seed=self.config.seed,
            flax_leaves=flax_leaves(self.module) if abstract else None,
            mirror_nvme_path=mirror_nvme,
            # widen the swap window only when a prefetch budget is asked
            # for explicitly (the TPU engine's rule, engine.py:1459-1465)
            prefetch_numel=(zc.prefetch_bucket_size if any(
                k in raw_zero for k in ("prefetch_bucket_size",
                                        "stage3_prefetch_bucket_size"))
                else 0),
            pin=self.device.type == "cuda")
        self.optimizer = self.host_optimizer
        self.client_optimizer = None
        self._partitioned = self.dp_world_size > 1
        self.master, self._opt_params = [], []
        self._module_stale = self._compute_stale = False
        self.offload_timing: Optional[Dict[str, Any]] = None
        if streaming:
            self._init_streamed()
            return
        # the module becomes the compute copy: compute dtype, on the card,
        # its values from the host mirrors (no fp32 copy is ever built
        # there)
        self.module.to(dtype=self.compute_dtype)
        self.module.to_empty(device=self.device)
        self.compute_module = self.module
        self._compute_params = list(self.module.parameters())
        self._dense_params = list(enumerate(self._compute_params))
        self.acc = self._zero_acc()
        if any(s.partitioned for s in self._param_shards):
            self._partition_compute()
        # whole leaves over dp > 1 come back as this rank's slice and are
        # all-gathered (the step tail's all-gather)
        self._gather_leaves = [i for i, _ in self._dense_params
                               if self.dp_world_size > 1]
        self._streams = None
        if self.device.type == "cuda":
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        self._params_on_card = True
        self._offload_restore_params()
        if not self._params_resident:
            self._drop_params()
        log_dist(
            f"ZeRO-Offload ready: {self.host_optimizer.numel():,}/"
            f"{self.host_optimizer.global_numel():,} params on this rank "
            f"({self.offload_device}, params "
            f"{'resident' if self._params_resident else op.device}, "
            f"dp_shard={self.host_optimizer.dp_shard})", ranks=[0])

    def _init_streamed(self) -> None:
        """The layer-streamed tier: nothing of the model on the card
        between steps. The module stays on the meta device, as the
        template the streamer runs each block through."""
        from .zero.layer_stream import LayerStreamer
        self.module.to(device="meta", dtype=self.compute_dtype)
        self.compute_module = self.module
        self._compute_params, self._dense_params = [], []
        self.acc, self._gather_leaves, self._streams = [], [], None
        self._params_resident = False
        self._params_on_card = False
        self._stream_step = None
        self._stream_eval = None
        self._layer_streamer = LayerStreamer(
            self.host_optimizer, self.module.stacked_spec(self.loss_fn),
            self.compute_dtype, self.device)
        log_dist(
            f"layer streaming ready: {self.host_optimizer.numel():,} params "
            f"on the host ({self.offload_device}), "
            f"{self._layer_streamer.num_layers} blocks of "
            f"{self._layer_streamer.block_numel:,} streamed through two "
            f"device buffer sets", ranks=[0])

    def _host_leaf(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter's fp32 host copy; over dp > 1 rank 0's, so the ranks
        start from one model however each built it."""
        if self.dp_world_size == 1:
            return p.detach().to("cpu", torch.float32)
        t = p.detach().to(self.device, torch.float32)
        comm.broadcast(t, 0)
        return t.cpu()

    def _card_params(self) -> List[torch.Tensor]:
        """The tensors that hold the compute parameters on the card."""
        return ([p for _, p in self._dense_params]
                + [u.shard for u in self._units])

    def device_state_bytes(self) -> Dict[str, int]:
        """Bytes of the engine's own state on the device: the compute
        parameters (this rank's shards at stage 3) and the fp32 grad
        accumulator."""
        return {"params": sum(p.numel() * p.element_size()
                              for p in self._card_params()),
                "grad_acc": sum(a.numel() * 4 for a in self.acc)}

    def _drop_params(self) -> None:
        """offload_param: free the card's parameters between steps."""
        for p in self._card_params():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._params_on_card = False

    def _materialize_params(self) -> None:
        if self._streaming:
            raise RuntimeError(
                "the layer-streamed tier never materializes the full model "
                "on the device; train with train_batch, evaluate with "
                "eval_batch, or take host copies with get_params()")
        for (i, p) in self._dense_params:
            p.data = torch.empty(self._shapes[i], dtype=self.compute_dtype,
                                 device=self.device)
        for u in self._units:
            u.shard.data = torch.empty(sum(u.pers), dtype=self.compute_dtype,
                                       device=self.device)
        self._offload_restore_params()
        self._params_on_card = True

    def _upload_targets(self) -> Dict[int, torch.Tensor]:
        """Where each leaf's mirror slice lands on the card: its stage-3
        shard view, the whole parameter at dp 1, else a gather buffer."""
        out = {}
        for u in self._units:
            for view, (i, _, _) in zip(u.views(), u.entries):
                out[i] = view
        for i, p in self._dense_params:
            if self.dp_world_size == 1:
                out[i] = p.data.view(-1)
            else:
                out[i] = torch.empty(self._shards[i].numel,
                                     dtype=self.compute_dtype,
                                     device=self.device)
        return out

    @torch.no_grad()
    def _upload_leaf(self, i: int, targets, timing=None) -> None:
        """Leaf i's mirror slice to the card (on the upload stream)."""
        host = self.host_optimizer
        src = host.mirror_flat(i)
        dst = targets[i]
        n = min(dst.numel(), src.numel())
        if self._streams is None:
            dst[:n].copy_(src[:n])
            return
        # the NVMe param tier reads every leaf into one staging buffer:
        # that copy must finish before the next read reuses it
        blocking = host.mirror_store is not None
        with torch.cuda.stream(self._streams[1]):
            ev = self._timed_copy(dst[:n], src[:n], not blocking, timing,
                                  "h2d")
        if blocking and ev is not None:
            ev.synchronize()

    def _timed_copy(self, dst, src, non_blocking, timing, kind):
        """One copy on the current stream, bracketed by events when the
        step is being timed (their elapsed times sum the link's busy
        time)."""
        if timing is None:
            dst.copy_(src, non_blocking=non_blocking)
            return None
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        dst.copy_(src, non_blocking=non_blocking)
        end.record()
        timing[f"{kind}_events"].append((start, end))
        timing[f"{kind}_bytes"] += src.numel() * src.element_size()
        return end

    @torch.no_grad()
    def _finish_upload(self, targets) -> None:
        """The next forward waits for the uploads; whole leaves over dp > 1
        are all-gathered from the ranks' slices into the parameters."""
        if self._streams is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._streams[1])
        if self._gather_leaves:
            fulls = all_gather_coalesced(
                [targets[i] for i in self._gather_leaves])
            self.comm_bytes["all_gather"] += sum(
                f.numel() * f.element_size() for f in fulls)
            for i, f in zip(self._gather_leaves, fulls):
                self._compute_params[i].copy_(self._shards[i].unpad(f))

    def _offload_restore_params(self) -> None:
        """Every leaf's mirror slice onto the card (the TPU engine's
        ``_offload_restore_params``, engine.py:1560)."""
        targets = self._upload_targets()
        for i in range(len(self._names)):
            self._upload_leaf(i, targets)
        self._finish_upload(targets)
        if self._streams is not None:
            # outside a step nothing else orders the host's next write of
            # a mirror after these copies
            self._streams[1].synchronize()

    def _grad_source(self, i: int) -> torch.Tensor:
        """This rank's slice of leaf i's accumulated grad on the card (the
        part inside the leaf)."""
        a = self.acc[i].view(-1)
        if self._grad_shards[i].partitioned:
            return a[:self._shards[i].valid]
        s = self._shards[i]
        return a[s.offset:s.offset + s.valid]

    def _stream_grads(self, timing=None):
        """Start every leaf's grad slice copy to the pinned staging now (on
        the side stream, one event per leaf); returns the staging views,
        indexed so that reading leaf i waits for its copy only."""
        host = self.host_optimizer
        staging = host.grad_staging
        if self._streams is None:
            for i, g in enumerate(staging):
                src = self._grad_source(i)
                g[:src.numel()].copy_(src)
            return staging
        stream = self._streams[0]
        stream.wait_stream(torch.cuda.current_stream(self.device))
        events = []
        with torch.cuda.stream(stream):
            for i, g in enumerate(staging):
                src = self._grad_source(i)
                ev = self._timed_copy(g[:src.numel()], src, True, timing,
                                      "d2h")
                if ev is None:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                events.append(ev)
        return _ArrivingGrads(staging, events, timing)

    def _offload_lr(self) -> float:
        """The TPU offload engine's lr: the schedule at the host step count
        before this step (its dense path reads the count after)."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.lr_at(
                self.host_optimizer.step_count))
        return float(self._base_lr)

    def _offload_update(self, denom: float) -> Dict[str, Any]:
        """The offload boundary: grads / denom and their norm and finite
        flag on the card (two scalars read on the host), then the host
        step of each leaf as its grad arrives, each leaf's mirror back as
        soon as it is stepped (the TPU engine's ``_offload_train_batch``,
        engine.py:1712)."""
        timing = self.offload_timing
        if timing is not None:
            timing.clear()
            timing.update(d2h_events=[], h2d_events=[], d2h_bytes=0,
                          h2d_bytes=0, cpu_adam_s=0.0)
            t0 = time.perf_counter()
        host = self.host_optimizer
        with torch.no_grad():
            torch._foreach_div_(self.acc, denom)
            gnorm, finite = self._global_norm_and_finite(self.acc)
            finite = bool(finite) if finite is not None else True
            gn = float(gnorm)
            if timing is not None:
                # the norm's read waited for the micro-steps: their time
                timing["device_fwd_bwd_s"] = (time.perf_counter()
                                              - self._step_t0)
            if finite:
                clip = self.gradient_clipping()
                combined = gn / clip if clip and clip > 0 and gn > clip \
                    else 1.0
                lr = self._offload_lr()
                grads = self._stream_grads(timing)
                upload = None
                if self._params_resident:
                    targets = self._upload_targets()

                    def upload(i):
                        self._upload_leaf(i, targets, timing)
                t1 = time.perf_counter()
                host.step(grads, lr, combined, on_leaf=upload)
                if timing is not None:
                    timing["host_step_s"] = time.perf_counter() - t1
                if upload is not None:
                    self._finish_upload(targets)
            else:
                self.skipped_steps += 1
            if self._streams is not None:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._streams[0])
            torch._foreach_zero_(self.acc)
            if not self._params_resident and self._params_on_card:
                self._drop_params()
        if timing is not None:
            if self._streams is not None:
                torch.cuda.synchronize(self.device)
            timing["update_s"] = time.perf_counter() - t0
            for kind in ("d2h", "h2d"):
                evs = timing.pop(f"{kind}_events")
                timing[f"{kind}_s"] = sum(a.elapsed_time(b)
                                          for a, b in evs) / 1e3
        self._update_loss_scale(finite)
        self._last_grad_norm = gnorm
        return {"grad_norm": gnorm, "finite": finite}

    def _offload_gathered(self, key: str) -> List[torch.Tensor]:
        """Whole fp32 leaves of the host ``master`` or a moment, gathered
        from the ranks' slices (every rank must call it), on the CPU."""
        host = self.host_optimizer
        out = []
        for i, leaf in enumerate(host.leaves):
            mine = host.shard_state(i)[key]
            if self.dp_world_size > 1:
                full = comm.all_gather_base(mine.to(self.device)).cpu()
            else:
                full = mine
            out.append(self._shards[i].unpad(full).clone())
        return out

    def _offload_load(self, load_dir, tag, load_opt: bool):
        """A checkpoint into the host optimizer (host-shard files leaf by
        leaf, at any dp; or an npz one), then the mirrors to the card."""
        tag = tag or ckpt_saving.read_latest_tag(load_dir)
        if tag is None:
            return None
        ckpt_dir = os.path.join(load_dir, tag)
        host = self.host_optimizer
        with open(os.path.join(ckpt_dir, "meta.json")) as fh:
            meta = json.load(fh)
        if meta.get("format") == "host_sharded":
            host.load_shards(ckpt_dir, load_optimizer_states=load_opt)
        else:
            res = ckpt_saving.load_checkpoint_dir(load_dir, tag)
            opt = res["opt_state"]
            host.load_state(
                [res["master_params"][n] for n in self._names],
                {m: [opt[f"{m}/{n}"] for n in self._names]
                 for m in host.STATE} if load_opt else None,
                step=int(opt["count"]) if load_opt else None)
        if self._params_on_card:
            self._offload_restore_params()
        return {"tag": tag, "meta": meta}

    # ------------------------------------------------------- config accessors
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def gradient_clipping(self):
        return self.config.gradient_clipping

    def zero_optimization(self):
        return self.zero_stage > 0

    def zero_optimization_stage(self):
        return self.zero_stage

    def get_global_grad_norm(self) -> Optional[float]:
        g = self._last_grad_norm
        return None if g is None else float(g)

    def get_lr(self) -> List[float]:
        if self.lr_scheduler is not None:
            count = (self.global_steps if self.client_optimizer is not None
                     else self._onebit.count if self._onebit is not None
                     else self.optimizer.count)
            return [self.lr_scheduler.lr_at(count)]
        if self.client_optimizer is not None:
            return [float("nan")]
        return [self._base_lr]

    @property
    def loss_scale(self) -> float:
        return self._scale.cur_scale

    # ------------------------------------------------------------- model fns
    def _to_device(self, batch):
        """The batch on the device; over dp ranks, this rank's rows of it
        where the leading dim divides by dp (the TPU ``_shard_batch``: other
        leaves stay whole on every rank); over sp ranks also this rank's
        columns (:meth:`_sp_labels` first)."""
        dp, rank = self.dp_world_size, self.dp_rank
        sp, sp_rank = self.sp_world_size, self._sp_group.rank
        if sp > 1:
            batch = self._sp_labels(batch)

        def put(x):
            t = torch.as_tensor(x if isinstance(x, torch.Tensor)
                                else np.asarray(x))
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.long()
            if dp > 1 and t.dim() > 0 and t.shape[0] % dp == 0:
                n = t.shape[0] // dp
                t = t[rank * n:(rank + 1) * n]
            if sp > 1 and t.dim() > 1 and t.shape[1] % sp == 0:
                n = t.shape[1] // sp
                t = t[:, sp_rank * n:(sp_rank + 1) * n]
            return t.to(self.device, non_blocking=True)
        if isinstance(batch, Mapping):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def _sp_labels(self, batch):
        """A global batch made ready for its sp columns: the next-token
        ``labels`` taken from the whole row (a rank's last column predicts
        the next rank's first token; only the row's last position has no
        label) and a ``loss_mask`` over every column (the batch's own, as
        ``lm_loss_fn`` reads it, zero at that last position), so each rank's
        loss is a token mean whose count is known (:meth:`_loss_of`)."""
        if not isinstance(batch, Mapping) or "input_ids" not in batch:
            raise ValueError("mesh sp > 1 takes dict batches with "
                             "'input_ids'")

        def tensor(x):
            return x if isinstance(x, torch.Tensor) else \
                torch.as_tensor(np.asarray(x))
        ids = tensor(batch["input_ids"])
        B, S = ids.shape
        if S % self.sp_world_size:
            raise ValueError(f"mesh sp={self.sp_world_size} does not divide "
                             f"the sequence length {S}")
        out = dict(batch)
        mask = batch.get("loss_mask")
        mask = (torch.ones(B, S, device=ids.device) if mask is None
                else tensor(mask).float()[:, :S])
        if "labels" not in batch:
            out["labels"] = torch.cat([ids[:, 1:], ids[:, :1]], 1)
            mask = torch.cat([mask[:, :S - 1],
                              mask.new_zeros(B, 1)], 1)
        out["loss_mask"] = mask
        return out

    def _cast_params(self) -> None:
        """fp32 master -> the compute copy, once per step (under offload:
        the parameters back on the card when they left it)."""
        if self.offload_enabled:
            if not self._params_on_card:
                self._materialize_params()
            return
        if self._compute_stale and self.compute_module is not self.module:
            with torch.no_grad():
                torch._foreach_copy_(self._compute_params, self.master)
        self._compute_stale = False

    def _model_kwargs(self, train: bool) -> Dict[str, Any]:
        """The training switch the TPU engine hands a flax module
        (``deterministic=not train``) and, in training, the gate's random
        stream, for a forward that takes them (resolved once by
        signature)."""
        names = getattr(self, "_forward_params", None)
        if names is None:
            import inspect
            try:    # the model's own (a stage-3 wrapper passes them on)
                names = set(inspect.signature(
                    self.module.forward).parameters)
            except (TypeError, ValueError):
                names = set()
            self._forward_params = names
        kw: Dict[str, Any] = {}
        if "deterministic" in names:
            kw["deterministic"] = not train
        if train and "generator" in names and moe_layers(self.compute_module):
            if getattr(self, "_gating_generator", None) is None:
                # seeded alike on every rank: each draws the dp group's
                # whole token set the same way
                self._gating_generator = torch.Generator(
                    device=self.device).manual_seed(int(self.config.seed))
            kw["generator"] = self._gating_generator
        return kw

    def _loss_of(self, batch, train: bool = True) -> torch.Tensor:
        inputs = batch.get("input_ids", batch.get("inputs")) \
            if isinstance(batch, Mapping) else batch
        if inputs is None:
            raise ValueError("a dict batch needs 'input_ids' (or 'inputs')")
        out = self.compute_module(inputs, **self._model_kwargs(train))
        if self.sp_world_size > 1:
            if self.loss_fn is None:
                raise ValueError("mesh sp > 1 needs a loss_fn (a token mean "
                                 "over the batch's loss_mask: lm_loss_fn)")
            return self._sp_mean(self.loss_fn(out, batch), batch)
        if self.loss_fn is not None:
            return self.loss_fn(out, batch)
        if isinstance(out, torch.Tensor) and out.dim() == 0:
            return out
        raise ValueError("model output is not a scalar loss; pass loss_fn")

    def _sp_mean(self, loss: torch.Tensor, batch) -> torch.Tensor:
        """The sp group's token mean from each rank's mean over its columns'
        ``loss_mask``: the ranks' sums (loss x count) summed over sp and
        divided by the whole count, the sum's backward the identity (each
        rank's grads are its columns' share; they are summed over sp in
        the reduction)."""
        count = batch["loss_mask"].float().sum()
        total = comm.all_reduce(count.clone(), group=self._sp_group)
        return reduce_from_tp(loss * count, self._sp_group) \
            / total.clamp_min(1)

    def _micro_forward(self, batch) -> torch.Tensor:
        self._cast_params()
        return self._loss_of(self._to_device(batch))

    def _micro_backward(self, loss: torch.Tensor) -> None:
        """Backward of one micro-batch; its grads go through
        ``communication_data_type`` (as the TPU engine rounds them for the
        dp reduction), are summed over dp ranks and added, as f32, into the
        accumulator."""
        (loss.float() * self._scale.cur_scale).backward()
        with torch.no_grad():
            if self._grad_split:
                self._scatter_into_acc()
                return
            if self._grad_group.size > 1:
                self._reduce_into_acc()
                return
            grads, accs = [], []
            for p, a in zip(self._compute_params, self.acc):
                if p.grad is None:
                    continue
                g = p.grad
                if self._comm_dtype is not None:
                    g = g.to(self._comm_dtype)
                grads.append(g.float())
                accs.append(a)
                p.grad = None
            torch._foreach_add_(accs, grads)

    def _reduce_into_acc(self) -> None:
        """All-reduce (sum) of every grad over dp x sp in one flat buffer of
        the communication dtype, widened into the accumulator."""
        dt = self._comm_dtype or torch.float32
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).to(dt)
                          for p in self._compute_params])
        for p in self._compute_params:
            p.grad = None
        comm.all_reduce(flat, group=self._grad_group)
        self.comm_bytes["all_reduce"] += flat.numel() * flat.element_size()
        flat = flat.float()
        torch._foreach_add_(self.acc, [
            g.view_as(a) for g, a in
            zip(flat.split([a.numel() for a in self.acc]), self.acc)])

    def _scatter_into_acc(self) -> None:
        """Stage >= 2: one reduce-scatter (sum) of every whole grad, in the
        communication dtype, into this rank's accumulator slices (the
        stage-3 units' grads arrived in their backward already)."""
        idx, grads = [], []
        for i, p in self._dense_params:
            grads.append(p.grad if p.grad is not None
                         else torch.zeros_like(p))
            idx.append(i)
            p.grad = None
        if grads and self.sp_world_size > 1:
            # summed over sp first (one flat buffer), then scattered over dp
            dt = self._comm_dtype or torch.float32
            flat = comm.all_reduce(torch.cat(
                [g.reshape(-1).to(dt) for g in grads]), group=self._sp_group)
            self.comm_bytes["all_reduce"] += flat.numel() * flat.element_size()
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        if grads:
            scatter_into(self.acc, idx, grads, self._comm_dtype,
                         self.comm_bytes, group=self._dp_group)

    def _global_norm_and_finite(self, grads: List[torch.Tensor]):
        """The global grad norm and (fp16) the finite flag, over every
        rank's slices when the grads are split, and over every ep
        partner's experts."""
        norms = torch.stack(torch._foreach_norm(grads))
        finite = (grads_finite(grads).float() if self.fp16_enabled
                  else None)
        if self._split_leaves:
            return self._split_norm_and_finite(norms, finite)
        sq = norms.square().sum()
        if self._grad_split:
            comm.all_reduce(sq, group=self._dp_group)
            if finite is not None:
                comm.all_reduce(finite, "min", group=self._dp_group)
        return sq.sqrt(), finite

    def _split_norm_and_finite(self, norms, finite):
        """Over ep or tp > 1: the shared leaves' squares summed (over dp
        when split) once, the split leaves' (experts, tp shards) also over
        their ep or tp group, so each shard counts once."""
        mask = torch.zeros(len(norms), dtype=torch.bool, device=norms.device)
        mask[self._split_leaves] = True
        sq = norms.square()
        parts = torch.stack([sq[~mask].sum(), sq[mask].sum()])
        if self._grad_split:
            comm.all_reduce(parts, group=self._dp_group)
        expert = comm.all_reduce(parts[1:].clone(), group=self._split_group)
        if finite is not None:
            comm.all_reduce(finite, "min")          # the whole world
        return (parts[0] + expert[0]).sqrt(), finite

    def _lamb_norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """LAMB's per-leaf partial sums [n, 2] summed over the ranks that
        hold parts of each leaf: dp when partitioned, and ep or tp for the
        split leaves."""
        if self._partitioned:
            comm.all_reduce(sq, group=self._dp_group)
        if self._split_leaves:
            mask = torch.zeros(len(sq), 1, dtype=torch.bool,
                               device=sq.device)
            mask[self._split_leaves] = True
            experts = comm.all_reduce(sq * mask, group=self._split_group)
            sq = torch.where(mask, experts, sq)
        return sq

    def _apply_update(self) -> Dict[str, Any]:
        """Unscale + clip + optimizer step, with the fp16 overflow guard.
        The accumulator holds the sum over dp ranks of per-rank mean
        losses' grads, hence the ``dp`` in the denominator."""
        gas = self.gradient_accumulation_steps()
        denom = self._scale.cur_scale * gas * self.dp_world_size
        if self.config.prescale_gradients:
            denom *= self.config.gradient_predivide_factor
        if self.offload_enabled:
            return self._offload_update(denom)
        with torch.no_grad():
            grads = torch._foreach_div(self.acc, denom)
            if self._grad_split or self._split_leaves:
                gnorm, finite = self._global_norm_and_finite(grads)
                finite = bool(finite) if finite is not None else True
            else:
                finite = (bool(grads_finite(grads)) if self.fp16_enabled
                          else True)
                gnorm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
            clip = self.gradient_clipping()
            if clip and clip > 0:
                torch._foreach_mul_(grads, clip / gnorm.clamp(min=clip))
            if finite:
                self._optimizer_step(grads)
            else:
                self.skipped_steps += 1
            torch._foreach_zero_(self.acc)
        self._update_loss_scale(finite)
        if finite and not self._partitioned:
            self._compute_stale = True
        self._last_grad_norm = gnorm
        return {"grad_norm": gnorm, "finite": finite}

    def _optimizer_step(self, grads: List[torch.Tensor]) -> None:
        if self._partitioned:
            self.optimizer.step(grads if self._grad_split else
                                [s.take(g) for s, g in
                                 zip(self._shards, grads)])
            self._gather_compute()
            return
        if self.client_optimizer is None:
            self.optimizer.step(grads)
            return
        if self.lr_scheduler is not None:
            for group in self.client_optimizer.param_groups:
                group["lr"] = self.lr_scheduler.lr_at(self.global_steps + 1)
        for p, g in zip(self.master, grads):
            p.grad = g
        self.client_optimizer.step()
        for p in self.master:
            p.grad = None

    # ------------------------------------------------------------ train APIs
    def train_batch(self, data_iter=None) -> torch.Tensor:
        """Pull gas micro-batches and run one full optimizer step. Returns
        the mean micro-batch loss (a 0-dim f32 tensor on the device)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("no data_iter and no training_data")
            if not hasattr(self, "_train_iter"):
                self._train_iter = iter(RepeatingLoader(
                    self.training_dataloader))
            data_iter = self._train_iter
        gas = self.gradient_accumulation_steps()
        micros = [next(data_iter) for _ in range(gas)]
        if self.offload_enabled and self.offload_timing is not None:
            if self._streams is not None:
                torch.cuda.synchronize(self.device)
            self._step_t0 = time.perf_counter()
        wcb = self.config.wall_clock_breakdown
        self.tput_timer.start()
        if wcb:
            self.timers("train_batch").start()
        if self._streaming:
            metrics = self._streamed_update(micros)
        elif self._onebit is not None:
            metrics = self._onebit.train_batch(micros)
        else:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            for batch in micros:
                loss = self._micro_forward(batch)
                self._micro_backward(loss)
                loss_sum += loss.detach().float()
            metrics = self._apply_update()
            metrics["loss"] = comm.all_reduce(loss_sum / gas, "avg",
                                              group=self._dp_group)
        if wcb:
            self.timers("train_batch").stop(sync=True)
        will_report = (self.global_steps + 1) % self.steps_per_print() == 0
        self.tput_timer.stop(sync=will_report)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += self.train_batch_size()
        self._after_step(metrics)
        return metrics["loss"]

    @property
    def _streaming(self) -> bool:
        return self._layer_streamer is not None

    def _streamed_update(self, micros) -> Dict[str, Any]:
        """The layer-streamed step (``zero/layer_stream.streamed_update``),
        then the loss scale."""
        from .zero.layer_stream import streamed_update
        metrics = streamed_update(self, micros)
        self._update_loss_scale(metrics["finite"])
        self._last_grad_norm = metrics["grad_norm"]
        return metrics

    def _update_loss_scale(self, finite: bool) -> None:
        fp16 = self.config.fp16
        self._scale = update_scale(
            self._scale, finite, dynamic=self.dynamic_loss_scale,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)

    # --- 3-call API -------------------------------------------------------
    def _refuse_onebit(self) -> None:
        if self._onebit is not None:
            raise NotImplementedError(
                "1-bit optimizers fuse the micro loop with the compressed "
                "exchange: use engine.train_batch(data_iter)")

    def forward(self, batch) -> torch.Tensor:
        """One micro-batch's loss, with its graph (backward comes next)."""
        self._refuse_onebit()
        self._pending_loss = self._micro_forward(batch)
        return self._pending_loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None,
                 allreduce_gradients: bool = True) -> torch.Tensor:
        """Backward of ``loss`` (default: the last forward's) into the
        accumulator; the gradient-accumulation bookkeeping point."""
        self._refuse_onebit()
        loss = self._pending_loss if loss is None else loss
        self._micro_backward(loss)
        self._pending_loss = None
        self.micro_steps += 1
        self.global_samples += (self.train_micro_batch_size_per_gpu()
                                * self.dp_world_size)
        return loss.detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self) -> None:
        self._refuse_onebit()
        if not self.is_gradient_accumulation_boundary():
            return
        metrics = self._apply_update()
        self.global_steps += 1
        self._after_step(metrics)

    def _after_step(self, metrics) -> None:
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self.steps_per_print() == 0:
            if self.config.wall_clock_breakdown:
                self.timers.log(["train_batch"])
            self._report_progress(self.global_steps, metrics)
            if self.config.memory_breakdown:
                log_dist("memory: " + self.timers.memory_usage(), ranks=[0])

    def _report_progress(self, step, metrics) -> None:
        loss = metrics.get("loss")
        loss = float("nan") if loss is None else float(loss)
        log_dist(f"step={step}, loss={loss:.4f}, lr={self.get_lr()}, "
                 f"loss_scale={self.loss_scale:g}, "
                 f"samples/sec={self.tput_timer.avg_samples_per_sec():.2f}",
                 ranks=[0])

    # ---------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """Loss of ``batch`` on the compute-dtype params, no grads (over dp
        ranks: the mean of the ranks' losses on their rows). The
        layer-streamed tier streams the blocks here too."""
        if self._streaming:
            from .zero.layer_stream import build_streamed_eval
            if self._stream_eval is None:
                self._stream_eval = build_streamed_eval(self._layer_streamer)
            res = self._layer_streamer.upload_resident()
            return self._stream_eval(res, self._to_device(batch))
        self._cast_params()
        return comm.all_reduce(
            self._loss_of(self._to_device(batch), train=False), "avg",
            group=self._dp_group)

    def get_params(self, dtype=None) -> Dict[str, torch.Tensor]:
        """The parameters in ``dtype`` (default the compute dtype) by name,
        always a copy. The layer-streamed tier builds them on the host
        from the mirrors (the model is larger than the card by design);
        the other paths from the fp32 masters (every rank must call it over
        dp > 1), on the CPU."""
        dt = dtype or self.compute_dtype
        if self._streaming:
            return {n: t.to(dt) for n, t in
                    self.host_optimizer.mirror_tree().items()}
        return {n: torch.from_numpy(np.asarray(v)).to(dt) for n, v in
                self.consolidated_fp32_state_dict().items()}

    # ------------------------------------------------------------ dataloader
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        bs = batch_size or (self.train_micro_batch_size_per_gpu()
                            * self.dp_world_size)
        return DeepSpeedDataLoader(dataset, batch_size=bs,
                                   collate_fn=collate_fn or self.collate_fn,
                                   drop_last=self.config.dataloader_drop_last)

    # ------------------------------------------------------------- ZeRO-1
    @torch.no_grad()
    def _broadcast_master(self, params: List[torch.Tensor]) -> None:
        """Rank 0's initial weights on every rank of the world (one flat
        broadcast), so the ranks start from one model however each built
        it."""
        flat = torch.cat([p.reshape(-1) for p in params])
        comm.broadcast(flat, 0)
        torch._foreach_copy_(params, [
            f.view_as(p) for f, p in
            zip(flat.split([p.numel() for p in params]), params)])

    @torch.no_grad()
    def _gather_compute(self) -> None:
        """The updated slices, in the compute dtype, all-gathered into the
        compute copy (the module itself at f32 compute); at stage 3 a
        partitioned leaf's slice is its compute shard, copied without a
        collective."""
        dense = [i for i, _ in self._dense_params]
        if dense:
            fulls = all_gather_coalesced(
                [self._opt_params[i].to(self.compute_dtype) for i in dense],
                group=self._dp_group)
            self.comm_bytes["all_gather"] += sum(
                f.numel() * f.element_size() for f in fulls)
            torch._foreach_copy_([p for _, p in self._dense_params], [
                self._shards[i].unpad(f) for i, f in zip(dense, fulls)])
        for unit in self._units:
            torch._foreach_copy_(unit.views(), [
                self._opt_params[i].to(self.compute_dtype)
                for i, _, _ in unit.entries])
        self._compute_stale = False
        self._module_stale = (self.compute_module is not self.module
                              and not self._grad_split)

    def _gathered(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves from this rank's slices (every rank calls it);
        the tensors themselves when the state is not partitioned."""
        if not self._partitioned:
            return list(tensors)
        return [s.unpad(f) for s, f in
                zip(self._shards, all_gather_coalesced(
                    tensors, group=self._dp_group))]

    def _mp_full(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves -> the split leaves gathered over ep or tp (every
        rank calls it): the leaves an ep-1, tp-1 engine holds."""
        if not self._split_leaves:
            return list(tensors)
        out = list(tensors)
        for i in self._split_leaves:
            shards = comm.all_gather(out[i].detach().contiguous(),
                                     group=self._split_group)
            out[i] = self._splits[i].merge(list(shards.unbind(0)))
        return out

    def _mp_local(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of split leaf i's whole tensor (its experts, or
        its tp shard); other leaves pass whole."""
        if i not in self._splits:
            return full
        return self._splits[i].take(full, self._split_group.rank)

    @torch.no_grad()
    def _sync_module(self) -> None:
        if self._module_stale:
            torch._foreach_copy_(self.master,
                                 self._gathered(self._opt_params))
            self._module_stale = False

    def consolidated_fp32_state_dict(self) -> Dict[str, np.ndarray]:
        """Full fp32 weights keyed by ``state_dict`` name (zero_to_fp32's
        output, in process). Over dp > 1 from stage 1 on every rank must
        call it: it gathers the slices (at stage 1 it also refreshes
        ``module``; from stage 2 on the module holds no fp32 weights)."""
        if self.offload_enabled:
            return ckpt_saving.consolidated_fp32_state_dict(
                dict(zip(self._names, self._offload_gathered("master"))))
        if self._grad_split and self._partitioned:
            return ckpt_saving.consolidated_fp32_state_dict(
                dict(zip(self._names, self._mp_full(
                    self._gathered(self._opt_params)))))
        self._sync_module()
        return ckpt_saving.consolidated_fp32_state_dict(
            dict(zip(self._names, self._mp_full(self.master))))

    def optimizer_state_dict(self) -> Dict[str, Any]:
        """The optimizer's ``count`` and its moments as whole leaves
        (gathered over dp at stage 1: every rank must call it)."""
        if self.offload_enabled:
            return {"count": self.host_optimizer.step_count,
                    **{m: self._offload_gathered(m)
                       for m in self.host_optimizer.STATE}}
        sd = self.optimizer.state_dict()
        return {"count": sd["count"],
                **{m: self._mp_full(self._gathered(sd[m]))
                   for m in self.optimizer.STATE}}

    # ----------------------------------------------------------- checkpoints
    @torch.no_grad()
    def _load_dense(self, res, load_opt: bool) -> None:
        master = res["master_params"]
        split = self._grad_split and self._partitioned
        for i, name in enumerate(self._names):
            if name not in master:
                raise KeyError(f"checkpoint missing tensor {name!r}")
            arr = master[name]
            if tuple(arr.shape) != self._full_shapes[i]:
                raise ValueError(f"shape mismatch for {name}: ckpt "
                                 f"{arr.shape} vs model "
                                 f"{self._full_shapes[i]}")
            full = self._mp_local(i, torch.from_numpy(arr))
            if split:
                self._opt_params[i].copy_(self._shards[i].take(full))
            else:
                self.master[i].copy_(full)
        if self._partitioned and not split:
            torch._foreach_copy_(self._opt_params, [
                s.take(p) for s, p in zip(self._shards, self.master)])
        if load_opt:
            opt = res["opt_state"]
            state = {"count": int(opt["count"])}
            for m in self.optimizer.STATE:
                full = [self._mp_local(i, torch.from_numpy(
                    opt[f"{m}/{name}"])).to(self.device)
                        for i, name in enumerate(self._names)]
                state[m] = ([s.take(f) for s, f in zip(self._shards, full)]
                            if self._partitioned else full)
            self.optimizer.load_state_dict(state)
        if split:
            self._gather_compute()
        else:
            self._compute_stale, self._module_stale = True, False

    def _validate_checkpoint_tag(self, tag: str) -> None:
        """All ranks must save under the same tag (reference
        _checkpoint_tag_validation, engine.py:2750; warn|fail|ignore). Every
        rank sees every rank's hash, so all take the same branch."""
        mode = (self.config.checkpoint_tag_validation or "warn").lower()
        if mode not in ("warn", "fail", "ignore"):
            raise ValueError(
                f"checkpoint_tag_validation={mode!r}: use warn|fail|ignore")
        if mode == "ignore" or self.dp_world_size == 1:
            return
        mine = torch.tensor([zlib.crc32(tag.encode())], dtype=torch.int64,
                            device=self.device)
        if len(set(comm.all_gather(mine).flatten().tolist())) > 1:
            msg = (f"checkpoint tags differ across ranks (this rank: "
                   f"{tag!r}): mixed-tag checkpoints cannot be loaded back")
            if mode == "fail":
                raise ValueError(msg)
            log_dist("WARNING: " + msg, ranks=None)

    def _check_checkpointable(self) -> None:
        if self.client_optimizer is not None:
            raise _not_ported("checkpoints of a client torch.optim "
                              "optimizer", "A13")

    # Above this size the npz full gather (the whole state on rank 0)
    # gives way to per-rank shard files, as in the TPU engine
    SHARDED_CKPT_AUTO_BYTES = 2_000_000_000

    def _use_sharded_checkpoint(self) -> bool:
        mode = self.config.sharded_checkpoint
        if mode != "auto":
            return bool(mode)
        if self.dp_world_size > 1 or self.offload_enabled:
            # the offload tier writes its host slices leaf by leaf and
            # never gathers the state
            return True
        return sum(int(np.prod(s)) * 4 for s in self._shapes) \
            > self.SHARDED_CKPT_AUTO_BYTES

    def _shard_arrays(self):
        """This rank's ``<i>:master`` / ``<i>:<moment>`` slices and the
        per-leaf metadata of the host-shard files (the stage-1 layout over
        dp even when the state is whole here). Over ep or tp > 1 the slices
        are of the whole leaves (gathered over ep or tp), so the files are
        those of an ep-1, tp-1 engine at the same dp."""
        if self._split_leaves:
            return self._full_shard_arrays()
        rules = ShardingRules(self.dp_world_size, 1, self.dp_rank)
        shards = self._shards if self._partitioned else [
            rules.master_spec(n, s)
            for n, s in zip(self._names, self._shapes)]
        sd = self.optimizer.state_dict()

        def mine(tensors, i):
            t = tensors[i]
            t = t if self._partitioned else shards[i].take(t)
            return t.detach().float().cpu().numpy()

        arrays = {}
        for i in range(len(shards)):
            arrays[f"{i}:master"] = mine(self._opt_params, i)
            for m in self.optimizer.STATE:
                arrays[f"{i}:{m}"] = mine(sd[m], i)
        return arrays, self._leaf_meta(shards)

    @staticmethod
    def _leaf_meta(shards) -> List[Dict[str, Any]]:
        return [{"path": s.path, "offset": s.offset, "numel": s.numel,
                 "padded": s.padded, "global_numel": s.global_numel,
                 "shape": list(s.shape)} for s in shards]

    def _full_shard_arrays(self):
        """:meth:`_shard_arrays` over ep or tp > 1: every leaf gathered
        whole (over dp, then ep or tp), then this rank's dp slice of it."""
        rules = ShardingRules(self.dp_world_size, 1, self.dp_rank)
        shards = [rules.master_spec(n, s)
                  for n, s in zip(self._names, self._full_shapes)]
        master = self.consolidated_fp32_state_dict()
        moments = self.optimizer_state_dict()
        arrays = {}
        for i, (name, spec) in enumerate(zip(self._names, shards)):
            arrays[f"{i}:master"] = spec.take(
                torch.from_numpy(master[name])).numpy()
            for m in self.optimizer.STATE:
                arrays[f"{i}:{m}"] = spec.take(
                    moments[m][i].detach().float().cpu()).numpy()
        return arrays, self._leaf_meta(shards)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True) -> str:
        """Save under ``save_dir/tag`` (default ``global_step<N>``); every
        rank calls it. npz at one rank, per-rank shard files over dp > 1
        (``sharded_checkpoint``: "auto", or true / false to force)."""
        self._check_checkpointable()
        tag = tag or f"global_step{self.global_steps}"
        self._validate_checkpoint_tag(tag)
        sched = self.lr_scheduler
        meta = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "loss_scale": self.loss_scale,
            "lr_scheduler": sched.state_dict() if sched else None,
            "zero_stage": self.zero_stage,
            "dp_world_size": self.dp_world_size,
            "client_state": client_state or {},
            "curriculum": None,
            "quantizer": None,
        }
        if self._onebit is not None:
            # the master is the same on every rank (npz from rank 0); each
            # rank's optimizer state is its own file
            self._onebit.save(os.path.join(save_dir, tag))
            return ckpt_saving.save_checkpoint_dir(
                save_dir, tag,
                master_params=self.consolidated_fp32_state_dict(),
                opt_state={"count": np.asarray(self._onebit.count)},
                meta=dict(meta, onebit=self._onebit.kind),
                save_latest=save_latest)
        if self._use_sharded_checkpoint():
            if self.offload_enabled:
                arrays, leaves = self.host_optimizer.shard_arrays()
            else:
                arrays, leaves = self._shard_arrays()
            return ckpt_saving.save_host_sharded_dir(
                save_dir, tag, arrays=arrays, leaves=leaves,
                step=self.optimizer.count, meta=meta,
                save_latest=save_latest,
                shard=(self.dp_rank, self.dp_world_size),
                write=self.mesh.coord("ep") == 0
                and self.mesh.coord("tp") == 0
                and self.mesh.coord("sp") == 0)
        master = self.consolidated_fp32_state_dict()
        sd = self.optimizer_state_dict()
        opt = {"count": np.asarray(sd["count"])}
        for m in self.optimizer.STATE:
            for name, t in zip(self._names, sd[m]):
                opt[f"{m}/{name}"] = t.detach().float().cpu().numpy()
        return ckpt_saving.save_checkpoint_dir(
            save_dir, tag, master_params=master, opt_state=opt, meta=meta,
            save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Load ``load_dir/tag`` (default: the ``latest`` file's tag), saved
        at any dp, in either layout. Returns ``(tag directory,
        client_state)``, or ``(None, {})`` when there is no checkpoint."""
        self._check_checkpointable()
        load_opt = load_optimizer_states and not load_module_only
        if self.offload_enabled:
            res = self._offload_load(load_dir, tag, load_opt)
        else:
            res = ckpt_saving.load_checkpoint_dir(
                load_dir, tag,
                self.optimizer.STATE if self._onebit is None else ())
        if res is None:
            log_dist(f"no checkpoint found in {load_dir}", ranks=[0])
            return None, {}
        meta = res["meta"]
        if self._onebit is not None:
            self._onebit.load_master(self._names, res["master_params"])
            if load_opt:
                self._onebit.load(os.path.join(load_dir, res["tag"]))
            # the phase is keyed on applied updates: realign the counters
            # and the host-side policy to the loaded run
            self._onebit.realign(meta)
        elif not self.offload_enabled:
            self._load_dense(res, load_opt)
        self._scale = self._scale._replace(
            cur_scale=float(meta["loss_scale"]))
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        self.global_steps = meta["global_steps"]
        self.global_samples = meta["global_samples"]
        self.micro_steps = meta["micro_steps"]
        self.skipped_steps = int(meta.get("skipped_steps", 0) or 0)
        log_dist(f"loaded checkpoint tag={res['tag']} "
                 f"step={self.global_steps}", ranks=[0])
        return os.path.join(load_dir, res["tag"]), \
            meta.get("client_state", {})
