"""Pipeline engine: executes the 1F1B instruction schedule.

Counterpart of ``deepspeed_tpu/runtime/pipe/engine.py`` (reference
``PipelineEngine``, runtime/pipe/engine.py:46, its ``_INSTRUCTION_MAP``
dispatch :1346-1375 and ``train_batch`` :302). The TPU engine is a single
controller: one host drives one sub-mesh per stage. Here a stage is a group
of ranks of the device mesh (``parallel/mesh.py``):

  * **mesh ``{"pp": S, ...}``** (pp equal to the module's ``num_stages``):
    each rank runs one stage's ``TrainSchedule``. Activations and their
    cotangents hop to the neighbouring stage's rank with the same dp and
    ep coordinates through ``comm.isend`` / ``comm.recv_into`` (sends are
    posted and waited at the step's end, receives block: a blocking send
    would deadlock this schedule, whose sender and receiver of one hop act
    on different ticks). ``PipelineParallelGrid`` names the stage and its
    neighbours' ranks;
  * **pp 1**: this process runs every stage in turn, tick by tick, and a
    hop is a hand-over in memory, as the TPU engine's shared mode does.

Within a stage the port computes what the TPU stage programs compute:

  * stage-granular activation checkpointing: ``ForwardPass`` keeps the
    stage input and runs the stage without a graph; ``BackwardPass``
    replays the stage under autograd and backpropagates the received
    cotangent (the last stage seeds its loss, times the fp16 loss scale).
    The last stage's ``ForwardPass`` does nothing: its ``BackwardPass``
    replays the stage and returns the loss;
  * fp32 masters, a compute-dtype copy of each stage's layers and an fp32
    grad accumulator; train forwards run ``deterministic=False`` (an MoE
    gate takes its train capacity; there are no gate draws, as the TPU
    engine passes its layers no rng);
  * dp inside a stage: each rank takes its dp rows of every global
    micro-batch; grads are summed over the stage's dp group and divided by
    dp at the step. ZeRO-1 gives each dp rank a flat slice of every
    leaf's master and moments (``runtime/sharding.py``; the updated slices
    are all-gathered); ZeRO-2 also reduce-scatters each micro-batch's grads
    into a 1/dp accumulator. ZeRO-3 raises;
  * ``ReduceTiedGrads``: each tied key's grads are summed over its owner
    stages once (in memory, or an all-reduce over the ranks of the owner
    stages with this rank's dp and ep coordinates) and every replica takes
    the same update;
  * fp16: the loss scale seeds the last stage's backward, the step divides
    by M x scale (x dp), and one overflow anywhere (a min over the world)
    skips every stage's update; the lr scheduler steps on applied steps
    only;
  * pp x ep: each stage's MoE layers keep their ep coordinate's experts
    and route the stage's dp group's tokens together; the ``(hidden, aux)``
    pair hops as two tensors and aux's cotangent hops back with dx.

``train_batch`` returns the mean micro-batch loss on every rank (the last
stage broadcasts it over pp).

Deliberate divergences from the TPU engine: the TPU engine refuses more
than one process (``engine.py:86-95``: a single controller); the port has
no single controller, so that refusal has no counterpart. The TPU engine
ignores ``model_parameters`` (stored, never read); the port loads a state
dict given there (``"{layer index}.{name}"``, the keys of
``state_dict()``). The TPU engine builds SGD for ``"sgd"`` and Adam for
every other optimizer type (LAMB silently becomes Adam); the port takes
Adam, AdamW and SGD and raises on any other type, and on a client
optimizer. The TPU engine ignores ``gradient_clipping``; the port raises
on it. pp x tp and pp x sp (which the TPU engine has) raise naming
ROADMAP A9.
"""

from __future__ import annotations

import collections
import copy
import inspect
import itertools
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ...checkpoint import saving as ckpt_saving
from ...comm import comm
from ...comm.coalesced_collectives import (all_gather_coalesced,
                                           reduce_scatter_coalesced)
from ...moe.layer import set_expert_parallel
from ...moe.utils import is_moe_param
from ...ops.adam import fused_adam
from ...ops.sgd import sgd
from ...parallel import mesh as mesh_lib
from ...parallel.topology import PipelineParallelGrid, ProcessTopology
from ...utils.device import resolve_device
from ...utils.logging import log_dist
from ..config import DeepSpeedConfig
from ..dataloader import DeepSpeedDataLoader, RepeatingLoader
from ..engine import _not_ported
from ..fp16.loss_scaler import grads_finite, make_loss_scale_state, \
    update_scale
from ..lr_schedules import build_lr_scheduler
from ..sharding import ShardingRules
from . import schedule as sched_lib
from .module import PipelineModule, TiedLayerSpec

MPU_MESSAGE = (
    "mpu: the TPU engine stores it and never reads it "
    "(deepspeed_tpu/runtime/engine.py:111); the mesh comes from the "
    "config's 'mesh' block. Remove the argument")
_OPTIMIZER_KEYS = {"adam": ("lr", "betas", "eps", "weight_decay"),
                   "adamw": ("lr", "betas", "eps", "weight_decay"),
                   "sgd": ("lr", "momentum")}
# a hop's header: the count of tensors, then (dtype code, ndim, dims...)
_HEADER = 32
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64,
           torch.int32, torch.bool, torch.float64)
_ACT, _GRAD, _EVAL = 0, 1, 2


def _takes(cls_or_fn, name: str) -> bool:
    try:
        return name in inspect.signature(cls_or_fn).parameters
    except (TypeError, ValueError):
        return False


def _leaves(x) -> List:
    return list(x) if isinstance(x, tuple) else [x]


def _pack(leaves: List):
    return tuple(leaves) if len(leaves) > 1 else leaves[0]


class PipelineEngine:
    def __init__(self, model: PipelineModule, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, collate_fn=None, config=None,
                 loss_fn=None, device="cuda"):
        if not isinstance(model, PipelineModule):
            raise TypeError("the pipeline engine takes a PipelineModule")
        if mpu is not None:
            raise ValueError(MPU_MESSAGE)
        if optimizer is not None:
            raise ValueError(
                "the pipeline engine builds one optimizer a stage from the "
                "config's 'optimizer' block; do not pass a client optimizer")
        self.device = resolve_device(device)
        self.module = model
        self.num_stages = S = model.num_stages
        raw = config._raw if isinstance(config, DeepSpeedConfig) else config
        self.mesh = self._build_mesh(raw)
        shape = self.mesh.shape
        self.dp_world_size = shape["dp"]
        self.dp_rank = self.mesh.coord("dp")
        self.ep_world_size = shape["ep"]
        self.config = DeepSpeedConfig(raw, dp_world_size=self.dp_world_size)
        self.loss_fn = loss_fn or model.loss_fn
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.micro_batches = self.config.gradient_accumulation_steps
        self.compute_dtype = self.config.compute_dtype
        if self.config.bf16.stochastic_rounding:
            raise NotImplementedError(
                "bf16.stochastic_rounding is wired into the data-parallel "
                "engine's master->compute cast; the pipeline engines cast "
                "per stage without an rng stream yet — the knob would "
                "silently not apply, so it rejects loudly here")
        self.zero_stage = self.config.zero_optimization_stage
        if self.zero_stage >= 3:
            raise ValueError(
                "ZeRO-3 does not compose with the pipeline engine: stage "
                "params must be resident for the host-driven 1F1B replay. "
                "Use zero stage 0-2 with pp, or drop pp and use stage 3's "
                "scan-over-layers sharding")
        if self.config.gradient_clipping:
            raise ValueError(
                "gradient_clipping: the TPU pipeline engine does not clip "
                "(the knob would silently do nothing); remove it")
        fp16 = self.config.fp16
        self.fp16_enabled = fp16.enabled
        self.dynamic_loss_scale = (fp16.dynamic_loss_scale
                                   if self.fp16_enabled else False)
        self.scale_state = make_loss_scale_state(
            static_scale=fp16.loss_scale if self.fp16_enabled else 1.0,
            initial_scale_power=fp16.initial_scale_power,
            hysteresis=fp16.hysteresis)

        self._dp_group = comm.new_group("dp", self.mesh)
        self._ep_group = comm.new_group("ep", self.mesh)
        self._pp_group = comm.new_group("pp", self.mesh)
        self._distributed = shape["pp"] == S and S > 1
        topo = ProcessTopology(axes=["data", "pipe", "expert"],
                               dims=[shape["dp"], shape["pp"], shape["ep"]])
        self.grid = PipelineParallelGrid(topo, global_rank=comm.get_rank())
        self.stage_id = self.grid.get_stage_id()
        self.local_stages = [self.stage_id] if self._distributed \
            else list(range(S))
        self._rules = ShardingRules(self.dp_world_size, self.zero_stage,
                                    self.dp_rank)
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None \
            else build_lr_scheduler(self.config.scheduler)
        self._build_tied_groups()
        self._build_stages(model_parameters)

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data,
                batch_size=self.config.train_micro_batch_size_per_gpu,
                collate_fn=collate_fn)
        self._mail: Dict[tuple, Any] = {}
        self._pending: List[comm.PendingSend] = []
        # bytes this rank sent to a neighbour stage ("p2p") and reduced
        # over the tied and dp groups
        self.comm_bytes: collections.Counter = collections.Counter()
        where = ("one stage a rank" if self._distributed
                 else "every stage in this process")
        log_dist(f"pipeline engine: {model.num_layers} layers over {S} "
                 f"stages, parts={model.parts}, mesh={shape}, {where}",
                 ranks=[0])

    # ------------------------------------------------------------- mesh
    def _build_mesh(self, raw) -> "mesh_lib.DeviceMesh":
        m = dict((raw or {}).get("mesh") or {})
        for axis in ("tp", "sp"):
            if m.get(axis, 1) != 1:
                raise _not_ported(f"pp x {axis} (mesh {axis}={m[axis]} inside "
                                  f"a pipeline stage)", "A9")
        pp = m.get("pp", 1)
        if pp not in (1, self.num_stages):
            raise ValueError(
                f"mesh pp={pp} with a {self.num_stages}-stage PipelineModule: "
                f"use pp={self.num_stages} (one stage a rank) or pp=1 (every "
                f"stage in each process)")
        shape = mesh_lib.MeshShape.infer(comm.get_world_size(), pp=pp,
                                         ep=m.get("ep", 1), dp=m.get("dp"))
        return mesh_lib.ensure_global_mesh(shape)

    def _rank_of(self, **coord) -> int:
        c = self.mesh.coords()
        c.update(coord)
        return int(self.mesh.devices[tuple(c[a] for a in
                                           mesh_lib.MESH_AXES)])

    def _build_tied_groups(self) -> None:
        """Per tied key, the group of the ranks that hold its owner stages
        at this rank's dp and ep coordinates (every rank makes every group,
        in one order); none when one rank holds every owner."""
        self._tied_groups: Dict[str, comm.CommGroup] = {}
        shape = self.mesh.shape
        for key, idxs in self.module.tied_keys().items():
            stages = sorted({self.module.stage_owner(i) for i in idxs})
            if not self._distributed or len(stages) < 2:
                continue
            for d, e in itertools.product(range(shape["dp"]),
                                          range(shape["ep"])):
                ranks = [self._rank_of(dp=d, pp=s, ep=e) for s in stages]
                pg = dist.new_group(ranks)
                if comm.get_rank() in ranks:
                    self._tied_groups[key] = comm.CommGroup(
                        axes=("pp",), group=pg, ranks=tuple(ranks))

    # ----------------------------------------------------------- stages
    def _build_layer(self, idx: int, given: Optional[Mapping]) -> nn.Module:
        """Layer ``idx`` as fp32 masters on the device: from ``given``'s
        entries when a state dict is given (a tied replica may take its
        canonical owner's), else its class's own init under a seed of the
        config's ``seed`` and the canonical owner's index, so tied replicas
        and the ranks agree."""
        spec = self.module.layer_specs[idx]
        owner = idx
        if isinstance(spec, TiedLayerSpec):
            owner = self.module.tied_keys()[spec.key][0]
        layer = None
        if given is not None and _takes(spec.typename, "device"):
            layer = spec.build(device="meta")
            if any(True for _ in layer.buffers()):
                layer = None          # buffers keep their init: build it
            else:
                layer = layer.to_empty(device=self.device)
        if layer is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.config.seed * 1_000_003 + owner)
                layer = spec.build()
        layer = layer.to(device=self.device, dtype=torch.float32)
        if given is not None:
            names = [n for n, _ in layer.named_parameters()]
            sd = {}
            for n in names:
                for src in (idx, owner):
                    if f"{src}.{n}" in given:
                        sd[n] = given[f"{src}.{n}"]
                        break
                else:
                    raise KeyError(f"model_parameters has no '{idx}.{n}'")
            layer.load_state_dict(sd, strict=False)
        return layer

    def _build_stages(self, model_parameters) -> None:
        if model_parameters is not None and \
                not isinstance(model_parameters, Mapping):
            raise TypeError(
                "model_parameters: a state dict of the pipeline's layers "
                "('{layer index}.{name}', as state_dict() gives it)")
        self.stage_layers: Dict[int, nn.ModuleList] = {}
        self.compute_layers: Dict[int, nn.ModuleList] = {}
        self._names: Dict[int, List[str]] = {}
        self._master: Dict[int, List[torch.Tensor]] = {}
        self._compute: Dict[int, List[torch.Tensor]] = {}
        self._shards: Dict[int, list] = {}
        self._grad_shards: Dict[int, list] = {}
        self.acc: Dict[int, List[torch.Tensor]] = {}
        self._opt_params: Dict[int, List[torch.Tensor]] = {}
        self.optimizers: Dict[int, Any] = {}
        token_group = self._dp_group if self.dp_world_size > 1 else None
        for s in self.local_stages:
            lo = self.module.parts[s]
            layers = nn.ModuleList(
                self._build_layer(lo + j, model_parameters)
                for j in range(len(self.module.stage_layers(s))))
            if self.dp_world_size > 1 and model_parameters is None:
                for p in layers.parameters():
                    comm.broadcast(p.data, 0, group=self._dp_group)
            set_expert_parallel(layers, self._ep_group, token_group)
            self.stage_layers[s] = layers
            self.compute_layers[s] = layers \
                if self.compute_dtype == torch.float32 else \
                copy.deepcopy(layers).to(dtype=self.compute_dtype)
            names = [f"{lo + int(k.partition('.')[0])}.{k.partition('.')[2]}"
                     for k, _ in layers.named_parameters()]
            self._names[s] = names
            self._master[s] = list(layers.parameters())
            self._compute[s] = list(self.compute_layers[s].parameters())
            shapes = [tuple(p.shape) for p in self._master[s]]
            self._shards[s] = [self._rules.master_spec(n, sh)
                               for n, sh in zip(names, shapes)]
            self._grad_shards[s] = [self._rules.grad_spec(n, sh)
                                    for n, sh in zip(names, shapes)]
            self.acc[s] = self._zero_acc(s)
            self._opt_params[s] = (
                [sh.take(p.detach()) for sh, p in
                 zip(self._shards[s], self._master[s])]
                if self._partitioned else self._master[s])
            self.optimizers[s] = self._build_optimizer(self._opt_params[s])
        self.optimizer = self.optimizers[self.local_stages[0]]

    @property
    def _partitioned(self) -> bool:
        return self._rules.partitioned

    @property
    def _grad_split(self) -> bool:
        return self.zero_stage >= 2 and self.dp_world_size > 1

    def _zero_acc(self, s: int) -> List[torch.Tensor]:
        return [torch.zeros(gs.numel if gs.partitioned else gs.shape,
                            dtype=torch.float32, device=self.device)
                for gs in self._grad_shards[s]]

    def _build_optimizer(self, params: Sequence[torch.Tensor]):
        oc = self.config.optimizer
        otype = (oc.type if oc else "Adam").lower()
        args = dict(oc.params) if oc else {}
        if otype not in _OPTIMIZER_KEYS:
            raise ValueError(
                f"optimizer {oc.type!r}: the pipeline engine steps Adam, "
                f"AdamW or SGD (the TPU pipeline engine builds Adam for "
                f"every type but SGD)")
        unknown = sorted(set(args) - set(_OPTIMIZER_KEYS[otype]))
        if unknown:
            raise ValueError(f"optimizer params {unknown} are not {oc.type} "
                             f"params in the pipeline engine (valid: "
                             f"{list(_OPTIMIZER_KEYS[otype])})")
        lr = args.get("lr", 1e-3)
        sched = self.lr_scheduler
        lr_fn = sched.lr_at if sched is not None else lr
        if otype == "sgd":
            return sgd(params, lr_fn, momentum=args.get("momentum", 0.0))
        return fused_adam(params, lr_fn,
                          betas=tuple(args.get("betas", (0.9, 0.999))),
                          eps=args.get("eps", 1e-8),
                          weight_decay=args.get("weight_decay", 0.0),
                          adam_w_mode=otype == "adamw")

    # ------------------------------------------------------------ hops
    def _stage_rank(self, s: int) -> int:
        return self.grid.stage_to_global(s)

    def _tag(self, kind: int, m: int) -> int:
        return (m * 3 + kind) * 8

    def _post(self, src: int, dst: int, kind: int, m: int, x) -> None:
        """Stage ``src`` hands ``x`` (a tensor or a tuple of them) to stage
        ``dst``."""
        if dst in self.local_stages:
            self._mail[(src, kind, m)] = x
            return
        leaves = [t.detach() for t in _leaves(x)]
        header = torch.zeros(_HEADER, dtype=torch.int64, device=self.device)
        fields = [len(leaves)]
        for t in leaves:
            fields += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        header[:len(fields)] = torch.tensor(fields)
        rank, tag = self._stage_rank(dst), self._tag(kind, m)
        self._pending.append(comm.isend(header, rank, tag=tag))
        for i, t in enumerate(leaves):
            self._pending.append(comm.isend(t, rank, tag=tag + 1 + i))
            self.comm_bytes["p2p"] += t.numel() * t.element_size()

    def _fetch(self, src: int, kind: int, m: int):
        """What stage ``src`` handed this stage (blocking)."""
        if src in self.local_stages:
            return self._mail.pop((src, kind, m))
        rank, tag = self._stage_rank(src), self._tag(kind, m)
        header = comm.recv_into(torch.zeros(_HEADER, dtype=torch.int64,
                                            device=self.device),
                                rank, tag=tag).tolist()
        leaves, at = [], 1
        for i in range(header[0]):
            dt, nd = _DTYPES[header[at]], header[at + 1]
            shape = header[at + 2:at + 2 + nd]
            at += 2 + nd
            leaves.append(comm.recv_into(
                torch.empty(shape, dtype=dt, device=self.device), rank,
                tag=tag + 1 + i))
        return _pack(leaves)

    def _drain_sends(self) -> None:
        for p in self._pending:
            p.wait()
        self._pending.clear()

    # ---------------------------------------------------------- compute
    def _run_stage(self, s: int, x, train: bool):
        for layer in self.compute_layers[s]:
            if train and _takes(layer.forward, "deterministic"):
                x = layer(x, deterministic=False)
            else:
                x = layer(x)
        return x

    def _split_batch(self, batch):
        if isinstance(batch, Mapping):
            return batch["input_ids"], batch.get("labels",
                                                 batch["input_ids"])
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return batch
        return batch, batch

    def _put(self, x) -> torch.Tensor:
        """A batch leaf on the device: this rank's dp rows when dp divides
        the leading dim (the TPU engine's ``_batch_spec``), else whole."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        dp = self.dp_world_size
        if dp > 1 and t.dim() > 0 and t.shape[0] % dp == 0:
            n = t.shape[0] // dp
            t = t[self.dp_rank * n:(self.dp_rank + 1) * n]
        return t.to(self.device)

    def _micro_of(self, s: int, forward: bool) -> int:
        """The micro-batch of this stage's next forward (or backward): the
        schedule's ``buffer_id`` is ``micro % buffers``, so the engine
        counts them in order (the TPU engine's ``_micro_of``)."""
        key = (s, forward)
        m = self._micro_counters.get(key, 0)
        self._micro_counters[key] = m + 1
        return m

    def _exec(self, cmd, s: int, micros, acts) -> None:
        t = type(cmd)
        last = s == self.num_stages - 1
        if t is sched_lib.ForwardPass:
            m = self._micro_of(s, True)
            if s == 0:
                x = self._put(self._split_batch(micros[m])[0])
            else:
                x = self._fetch(s - 1, _ACT, m)
            acts[(s, m)] = x      # the stage INPUT, for the backward replay
            if last:
                acts[("labels", m)] = self._put(
                    self._split_batch(micros[m])[1])
                return
            with torch.no_grad():
                out = self._run_stage(s, x, train=True)
            self._post(s, s + 1, _ACT, m, out)
        elif t is sched_lib.BackwardPass:
            m = self._micro_of(s, False)
            x = acts.pop((s, m))
            ins = [v.detach().requires_grad_() if v.is_floating_point()
                   else v for v in _leaves(x)]
            with torch.enable_grad():
                out = self._run_stage(s, _pack(ins), train=True)
                if last:
                    loss = self.loss_fn(out, acts.pop(("labels", m))).float()
                    (loss * self.scale_state.cur_scale).backward()
                    self._loss_sum += loss.detach()
                else:
                    outs = [o for o in _leaves(out)]
                    cots = _leaves(self._fetch(s + 1, _GRAD, m))
                    torch.autograd.backward(outs, cots)
            self._take_grads(s)
            if s > 0:
                self._post(s, s - 1, _GRAD, m, _pack([
                    v.grad if v.grad is not None else torch.zeros_like(v)
                    for v in ins if v.is_floating_point()]))
        elif t is sched_lib.ReduceTiedGrads:
            # every stage's schedule emits it at the final tick; one
            # reduction a step, on the first local stage's turn
            if s == self.local_stages[0]:
                self._reduce_tied_grads()
        elif t is sched_lib.ReduceGrads:
            if s == self.local_stages[0]:
                self._reduce_grads()
        # LoadMicroBatch: the micro-batch is read at the ForwardPass;
        # OptimizerStep runs after the tick loop (the fp16 check spans
        # every stage)

    @torch.no_grad()
    def _take_grads(self, s: int) -> None:
        """One micro-batch's grads (compute dtype) into the f32
        accumulator: added whole, or at ZeRO-2 over dp > 1 reduce-scattered
        into this rank's slices."""
        params = self._compute[s]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            p.grad = None
        if self._grad_split:
            parts = reduce_scatter_coalesced(grads, group=self._dp_group)
            torch._foreach_add_(self.acc[s], parts)
            return
        torch._foreach_add_(self.acc[s], [g.float() for g in grads])

    @torch.no_grad()
    def _reduce_tied_grads(self) -> None:
        """Each tied key's grads summed over its owners exactly once and
        written back to every owner this rank holds."""
        for key, idxs in self.module.tied_keys().items():
            held = [(self.module.stage_owner(i), i) for i in idxs
                    if self.module.stage_owner(i) in self.local_stages]
            group = self._tied_groups.get(key)
            if len(held) + (group.size - 1 if group else 0) < 2:
                continue
            slots = [self._layer_slots(s, i) for s, i in held]
            total = [sum(vals) for vals in zip(*[[self.acc[s][j]
                                                  for j in js]
                                                 for s, js in slots])]
            if group is not None:
                flat = torch.cat([t.reshape(-1) for t in total])
                comm.all_reduce(flat, group=group)
                self.comm_bytes["tied_all_reduce"] += \
                    flat.numel() * flat.element_size()
                total = [f.view_as(t) for f, t in
                         zip(flat.split([t.numel() for t in total]), total)]
            for s, js in slots:
                for j, t in zip(js, total):
                    self.acc[s][j].copy_(t)

    def _layer_slots(self, s: int, idx: int):
        pre = f"{idx}."
        return s, [j for j, n in enumerate(self._names[s])
                   if n.startswith(pre)]

    @torch.no_grad()
    def _reduce_grads(self) -> None:
        """ReduceGrads: the accumulators summed over the stage's dp group
        (ZeRO-2 reduced them in every backward already)."""
        if self.dp_world_size == 1 or self._grad_split:
            return
        for s in self.local_stages:
            flat = torch.cat([a.reshape(-1) for a in self.acc[s]])
            comm.all_reduce(flat, group=self._dp_group)
            self.comm_bytes["dp_all_reduce"] += \
                flat.numel() * flat.element_size()
            torch._foreach_copy_(self.acc[s], [
                f.view_as(a) for f, a in
                zip(flat.split([a.numel() for a in self.acc[s]]),
                    self.acc[s])])

    # ----------------------------------------------------------- training
    def train_batch(self, data_iter=None) -> torch.Tensor:
        """Pull M micro-batches, run the 1F1B schedule and one optimizer
        step. Returns the mean micro-batch loss (a 0-dim f32 tensor) on
        every rank."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("no data_iter and no training_data")
            if not hasattr(self, "_train_iter"):
                self._train_iter = iter(RepeatingLoader(
                    self.training_dataloader))
            data_iter = self._train_iter
        M, S = self.micro_batches, self.num_stages
        micros = [next(data_iter) for _ in range(M)]
        self._micro_counters: Dict[tuple, int] = {}
        self._loss_sum = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        acts: Dict[tuple, Any] = {}
        iters = {s: iter(sched_lib.TrainSchedule(M, S, s))
                 for s in self.local_stages}
        for _tick in range(2 * (M + S - 1)):
            for s in self.local_stages:
                for cmd in next(iters[s]):
                    self._exec(cmd, s, micros, acts)
        self._drain_sends()
        stepped = self._optimizer_step()
        self.global_steps += 1
        # an overflow-skipped step does not march the lr schedule
        if self.lr_scheduler is not None and stepped:
            self.lr_scheduler.step()
        return self._mean_loss(self._loss_sum / M)

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The last stage's loss, averaged over dp, on every rank."""
        if self.dp_world_size > 1 and \
                self.num_stages - 1 in self.local_stages:
            comm.all_reduce(loss, "avg", group=self._dp_group)
        if self._distributed:
            comm.broadcast(loss, self.num_stages - 1, group=self._pp_group)
        return loss

    @torch.no_grad()
    def _optimizer_step(self) -> bool:
        """Divide by M x scale x dp, check every stage's grads finite (fp16:
        one overflow anywhere skips every stage), step, zero the
        accumulators. Returns whether the step was applied."""
        denom = self.micro_batches * self.scale_state.cur_scale \
            * self.dp_world_size
        grads = {s: torch._foreach_div(self.acc[s], denom)
                 for s in self.local_stages}
        finite = True
        if self.fp16_enabled:
            flag = torch.stack([grads_finite(g) for g in grads.values()]
                               ).all().float()
            comm.all_reduce(flag, "min")
            finite = bool(flag)
            fp16 = self.config.fp16
            self.scale_state = update_scale(
                self.scale_state, finite, dynamic=self.dynamic_loss_scale,
                scale_window=fp16.loss_scale_window,
                min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self._last_grad_norm = self._global_norm(grads)
        for s in self.local_stages:
            if finite:
                g = grads[s]
                if self._partitioned and not self._grad_split:
                    g = [sh.take(x) for sh, x in zip(self._shards[s], g)]
                self.optimizers[s].step(g)
                self._refresh_compute(s)
            torch._foreach_zero_(self.acc[s])
        return finite

    def _global_norm(self, grads) -> torch.Tensor:
        """The global L2 norm of the step's grads: every leaf of every stage
        once (a tied key's canonical owner's copy only), slices summed over
        dp (ZeRO-2) and expert banks over ep."""
        tied_copies = {i for idxs in self.module.tied_keys().values()
                       for i in idxs[1:]}
        parts = torch.zeros(2, dtype=torch.float32, device=self.device)
        for s in self.local_stages:
            for j, (n, g) in enumerate(zip(self._names[s], grads[s])):
                if int(n.partition(".")[0]) in tied_copies:
                    continue
                expert = self.ep_world_size > 1 and is_moe_param(n)
                parts[int(expert)] += g.float().square().sum()
        if self._grad_split:
            comm.all_reduce(parts, group=self._dp_group)
        if self.ep_world_size > 1:
            parts[1:] = comm.all_reduce(parts[1:].clone(),
                                        group=self._ep_group)
        if self._distributed:
            comm.all_reduce(parts, group=self._pp_group)
        return parts.sum().sqrt()

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's global grad norm (before the step), or None."""
        norm = getattr(self, "_last_grad_norm", None)
        return None if norm is None else float(norm)

    @torch.no_grad()
    def _refresh_compute(self, s: int) -> None:
        """The stepped masters into the compute copy: the updated slices
        all-gathered over dp (ZeRO >= 1 over dp > 1; the fp32 masters are
        gathered too), else cast."""
        if self._partitioned:
            fulls = self._gathered(s, self._opt_params[s])
            torch._foreach_copy_(self._master[s], fulls)
        if self.compute_layers[s] is not self.stage_layers[s]:
            torch._foreach_copy_(self._compute[s], self._master[s])

    def _gathered(self, s: int, slices) -> List[torch.Tensor]:
        return [sh.unpad(f) for sh, f in
                zip(self._shards[s], all_gather_coalesced(
                    slices, group=self._dp_group))]

    # --------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_batch(self, data_iter) -> torch.Tensor:
        """One batch forward through every stage (deterministic) and its
        loss, on every rank."""
        batch = data_iter if isinstance(data_iter, (Mapping, tuple, list)) \
            else next(data_iter)
        x, labels = self._split_batch(batch)
        S = self.num_stages
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in range(S):
            if s not in self.local_stages:
                continue
            h = self._put(x) if s == 0 else self._fetch(s - 1, _EVAL, 0)
            out = self._run_stage(s, h, train=False)
            if s == S - 1:
                loss = self.loss_fn(out, self._put(labels)).float()
            else:
                self._post(s, s + 1, _EVAL, 0, out)
        self._drain_sends()
        return self._mean_loss(loss)

    @property
    def skipped_steps(self) -> int:
        """Single source of truth: the scaler's overflow counter."""
        return int(self.scale_state.overflows)

    # -------------------------------------------------------------- state
    def _whole(self, s: int, j: int, t: torch.Tensor) -> torch.Tensor:
        """Stage ``s``'s leaf ``j`` whole over ep (an expert bank holds this
        rank's experts; every ep rank calls it)."""
        if self.ep_world_size > 1 and is_moe_param(self._names[s][j]):
            return torch.cat(list(comm.all_gather(t.contiguous(),
                                                  group=self._ep_group)))
        return t

    def _local(self, s: int, j: int, whole: torch.Tensor) -> torch.Tensor:
        if self.ep_world_size > 1 and is_moe_param(self._names[s][j]):
            n = whole.shape[0] // self.ep_world_size
            r = self._ep_group.rank
            return whole[r * n:(r + 1) * n]
        return whole

    def stage_state_dict(self, s: int) -> Dict[str, torch.Tensor]:
        """Stage ``s``'s fp32 masters, whole, by ``"{layer}.{name}"`` (every
        rank of the stage calls it)."""
        return {n: self._whole(s, j, p.detach()) for j, (n, p) in
                enumerate(zip(self._names[s], self._master[s]))}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The local stages' fp32 masters (a pp rank holds its own)."""
        out = {}
        for s in self.local_stages:
            out.update(self.stage_state_dict(s))
        return out

    def _opt_whole(self, s: int) -> Dict[str, Any]:
        opt = self.optimizers[s]
        out = {"count": np.asarray(opt.count)}
        for name in opt.STATE:
            tensors = getattr(opt, name)
            if self._partitioned:
                tensors = self._gathered(s, tensors)
            for j, t in enumerate(tensors):
                out[f"{name}/{self._names[s][j]}"] = \
                    self._whole(s, j, t).detach().cpu().numpy()
        return out

    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        """``save_dir/tag/`` with one ``stage_{s}_model_states.npz`` and
        ``stage_{s}_optim_states.npz`` a stage (whole leaves, written by
        the stage's rank at dp 0 and ep 0), ``meta.json`` and ``latest``."""
        tag = tag or f"global_step{self.global_steps}"
        ckpt_dir = os.path.join(save_dir, tag)
        writer = self.dp_rank == 0 and self.mesh.coord("ep") == 0
        for s in self.local_stages:
            master = {n: t.cpu().numpy()
                      for n, t in self.stage_state_dict(s).items()}
            opt = self._opt_whole(s)
            if writer:
                os.makedirs(ckpt_dir, exist_ok=True)
                ckpt_saving.save_tree(os.path.join(
                    ckpt_dir, f"stage_{s}_model_states.npz"), master)
                ckpt_saving.save_tree(os.path.join(
                    ckpt_dir, f"stage_{s}_optim_states.npz"), opt)
        meta = {"global_steps": self.global_steps,
                "parts": list(self.module.parts),
                "scale_state": dict(self.scale_state._asdict()),
                "client_state": client_state or {}}
        if comm.get_rank() == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
        return ckpt_saving._finish(save_dir, tag, meta, True)

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, **kw):
        """Load :meth:`save_checkpoint`'s directory (the same partition;
        any dp). Returns (tag, client_state), or (None, {}) without one."""
        import json
        tag = tag or ckpt_saving.read_latest_tag(load_dir)
        if tag is None:
            return None, {}
        ckpt_dir = os.path.join(load_dir, tag)
        with open(os.path.join(ckpt_dir, "meta.json")) as fh:
            meta = json.load(fh)
        if list(meta["parts"]) != list(self.module.parts):
            raise ValueError(f"checkpoint parts {meta['parts']} != this "
                             f"module's {self.module.parts}")
        for s in self.local_stages:
            master = ckpt_saving.load_tree_arrays(
                os.path.join(ckpt_dir, f"stage_{s}_model_states.npz"))
            opt_arrays = ckpt_saving.load_tree_arrays(
                os.path.join(ckpt_dir, f"stage_{s}_optim_states.npz"))
            for j, (n, p) in enumerate(zip(self._names[s], self._master[s])):
                p.copy_(self._local(s, j, torch.from_numpy(master[n])))
            opt = self.optimizers[s]
            opt.count = int(opt_arrays["count"])
            for name in opt.STATE:
                for j, t in enumerate(getattr(opt, name)):
                    whole = self._local(s, j, torch.from_numpy(
                        opt_arrays[f"{name}/{self._names[s][j]}"])).to(
                            self.device)
                    t.copy_(self._shards[s][j].take(whole)
                            if self._partitioned else whole)
            if self._partitioned:
                for sh, dst, p in zip(self._shards[s], self._opt_params[s],
                                      self._master[s]):
                    dst.copy_(sh.take(p))
            if self.compute_layers[s] is not self.stage_layers[s]:
                torch._foreach_copy_(self._compute[s], self._master[s])
        self.global_steps = int(meta["global_steps"])
        self.scale_state = type(self.scale_state)(**meta["scale_state"])
        return tag, meta.get("client_state", {})
