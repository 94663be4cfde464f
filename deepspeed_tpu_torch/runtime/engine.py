"""The training engine, dense path.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (reference
``DeepSpeedEngine``, deepspeed/runtime/engine.py:175) at one data-parallel
rank. The TPU engine compiles a whole step into one program; here the same
step runs eagerly:

  * fp32 master params (the module's own parameters) and an fp32 gradient
    accumulator. Once per step the master is cast to the compute dtype into
    a compute copy of the module (``_cast_params``, hoisted out of the micro
    loop as in the TPU engine); each micro-batch runs forward and backward
    on that copy and adds its grads, cast to f32, into the accumulator;
  * at the boundary (``_apply_update``): divide by ``scale * gas`` (and
    ``gradient_predivide_factor`` under ``prescale_gradients``), take the
    global norm, clip to ``gradient_clipping``, step Adam on the master,
    skip the step on non-finite grads (fp16 only: the overflow flag is read
    on the host, as the reference does), update the loss scale and zero the
    accumulator;
  * ZeRO stage 0 and 1 at data-parallel world size 1, where partitioning
    the optimizer state over dp is the identity.

What the TPU engine supports beyond that raises ``NotImplementedError``
naming its ROADMAP item; a parsed knob never silently does nothing.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..ops.adam import fused_adam
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .config import DeepSpeedConfig
from .constants import OFFLOAD_NONE
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import grads_finite, make_loss_scale_state, \
    update_scale
from .lr_schedules import build_lr_scheduler

_ADAM_TYPES = ("adam", "adamw", "fusedadam")
_ADAM_KEYS = ("lr", "betas", "eps", "weight_decay", "bias_correction",
              "adam_w_mode", "torch_adam")
_LATER_OPTIMIZERS = {"lamb": "A4.8", "adagrad": "A4.8", "sgd": "A4.8",
                     "onebitadam": "A4.6", "onebitlamb": "A4.6",
                     "zerooneadam": "A4.6"}
_COMM_DTYPES = {"fp16": torch.float16, "float16": torch.float16,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "fp32": None, "float32": None}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what}: not ported to PyTorch yet (ROADMAP {item})")


def _dp_world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise _not_ported(
            f"data parallelism over {dist.get_world_size()} ranks (ZeRO-1 "
            f"across dp > 1)", "A4.7")
    return 1


class DeepSpeedEngine:
    def __init__(self, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 config=None, loss_fn=None, device="cuda"):
        self.device = resolve_device(device)
        self.dp_world_size = _dp_world_size()
        self.mp_world_size = 1
        raw = config._raw if isinstance(config, DeepSpeedConfig) else config
        self.config = DeepSpeedConfig(raw, dp_world_size=self.dp_world_size)
        self._config = self.config            # reference-name parity
        self._reject_unported()

        self.module = self._prepare_module(model, model_parameters)
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
            log_dist("disable_allgather is inert at one data-parallel "
                     "rank: there is no allgather to replace", ranks=[0])

        # ---- state: fp32 master, compute copy, f32 accumulator ----------
        self.master: List[torch.Tensor] = list(self.module.parameters())
        if self.compute_dtype == torch.float32:
            self.compute_module = self.module
        else:
            self.compute_module = copy.deepcopy(self.module).to(
                dtype=self.compute_dtype)
        self._compute_params = list(self.compute_module.parameters())
        self._compute_stale = True
        self.acc = [torch.zeros_like(p) for p in self.master]
        fp16 = self.config.fp16
        self._scale = make_loss_scale_state(
            static_scale=fp16.loss_scale if self.fp16_enabled else 1.0,
            initial_scale_power=fp16.initial_scale_power,
            hysteresis=fp16.hysteresis)
        self._last_grad_norm: Optional[torch.Tensor] = None
        self._pending_loss = None

        self.lr_scheduler = lr_scheduler if lr_scheduler is not None \
            else build_lr_scheduler(self.config.scheduler)
        self._build_optimizer(optimizer)

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)

        log_dist(
            f"engine ready: device={self.device} zero_stage="
            f"{self.zero_stage} dtype={self.compute_dtype} batch="
            f"{self.train_batch_size()}={self.train_micro_batch_size_per_gpu()}"
            f"x{self.gradient_accumulation_steps()}x{self.dp_world_size}",
            ranks=[0])
        if self.config.dump_state:
            log_dist(f"resolved config: {dataclasses.asdict(self.config)}",
                     ranks=[0])

    # ------------------------------------------------------------------ init
    def _reject_unported(self) -> None:
        """Every knob the TPU engine honours and this one cannot yet."""
        c = self.config
        zc = c.zero_config
        if zc.stage >= 2:
            raise _not_ported(f"ZeRO stage {zc.stage}", "A4.1")
        if zc.offload_optimizer.device != OFFLOAD_NONE \
                or zc.offload_param.device != OFFLOAD_NONE:
            raise _not_ported("offload_optimizer / offload_param", "A4.1")
        m = c.mesh
        if (m.tp, m.pp, m.ep, m.sp) != (1, 1, 1, 1) or m.dp not in (None, 1):
            raise _not_ported("a tp/pp/ep/sp (or dp > 1) mesh", "A4.2")
        if c.pipeline.stages > 1:
            raise _not_ported("pipeline stages", "A4.3")
        otype = (c.optimizer.type if c.optimizer else "Adam").lower()
        if otype in _LATER_OPTIMIZERS:
            raise _not_ported(f"optimizer {c.optimizer.type}",
                              _LATER_OPTIMIZERS[otype])
        if otype not in _ADAM_TYPES:
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
            raise _not_ported(", ".join(on), "A4.6")
        ac = c.activation_checkpointing
        if ac.cpu_checkpointing:
            raise _not_ported("activation_checkpointing.cpu_checkpointing",
                              "A4.1")
        if ac.partition_activations:
            raise _not_ported(
                "activation_checkpointing.partition_activations (a tp "
                "sharding of the checkpoints)", "A4.2")
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

    def _prepare_module(self, model, model_parameters) -> nn.Module:
        if not isinstance(model, nn.Module):
            raise TypeError(
                "model must be a torch.nn.Module (e.g. "
                "deepspeed_tpu_torch.models.gpt.GPT)")
        if isinstance(model_parameters, Mapping):
            model.load_state_dict(model_parameters)
        elif model_parameters is not None:
            own = {id(p) for p in model.parameters()}
            if any(id(p) not in own for p in model_parameters):
                raise ValueError(
                    "model_parameters must be the model's own parameters "
                    "(model.parameters()) or a state_dict for it")
        # fp32 masters, in place: Parameter objects (and a client
        # optimizer built over them) are kept
        return model.to(device=self.device, dtype=torch.float32)

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
        unknown = sorted(set(params) - set(_ADAM_KEYS))
        if unknown:
            raise ValueError(f"optimizer params {unknown} are not Adam "
                             f"params (valid: {list(_ADAM_KEYS)})")
        self._base_lr = params.get("lr", 1e-3)
        sched = self.lr_scheduler
        lr = sched.lr_at if sched is not None else self._base_lr
        # torch_adam picks the reference's torch.optim.Adam implementation;
        # the math is the same
        self.optimizer = fused_adam(
            self.master, lr, betas=tuple(params.get("betas", (0.9, 0.999))),
            eps=params.get("eps", 1e-8),
            weight_decay=params.get("weight_decay", 0.0),
            adam_w_mode=params.get("adam_w_mode", otype != "adam"),
            bias_correction=params.get("bias_correction", True))

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
            count = self.global_steps if self.client_optimizer is not None \
                else self.optimizer.count
            return [self.lr_scheduler.lr_at(count)]
        if self.client_optimizer is not None:
            return [float("nan")]
        return [self._base_lr]

    @property
    def loss_scale(self) -> float:
        return self._scale.cur_scale

    # ------------------------------------------------------------- model fns
    def _to_device(self, batch):
        def put(x):
            t = torch.as_tensor(x if isinstance(x, torch.Tensor)
                                else np.asarray(x))
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.long()
            return t.to(self.device, non_blocking=True)
        if isinstance(batch, Mapping):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def _cast_params(self) -> None:
        """fp32 master -> the compute copy, once per step."""
        if self._compute_stale and self.compute_module is not self.module:
            with torch.no_grad():
                torch._foreach_copy_(self._compute_params, self.master)
        self._compute_stale = False

    def _loss_of(self, batch) -> torch.Tensor:
        inputs = batch.get("input_ids", batch.get("inputs")) \
            if isinstance(batch, Mapping) else batch
        if inputs is None:
            raise ValueError("a dict batch needs 'input_ids' (or 'inputs')")
        out = self.compute_module(inputs)
        if self.loss_fn is not None:
            return self.loss_fn(out, batch)
        if isinstance(out, torch.Tensor) and out.dim() == 0:
            return out
        raise ValueError("model output is not a scalar loss; pass loss_fn")

    def _micro_forward(self, batch) -> torch.Tensor:
        self._cast_params()
        return self._loss_of(self._to_device(batch))

    def _micro_backward(self, loss: torch.Tensor) -> None:
        """Backward of one micro-batch; its grads, cast to f32, are added
        into the accumulator (through ``communication_data_type`` first,
        as the TPU engine rounds them for the dp reduction)."""
        (loss.float() * self._scale.cur_scale).backward()
        with torch.no_grad():
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

    def _apply_update(self) -> Dict[str, Any]:
        """Unscale + clip + Adam step, with the fp16 overflow guard."""
        gas = self.gradient_accumulation_steps()
        denom = self._scale.cur_scale * gas
        if self.config.prescale_gradients:
            denom *= self.config.gradient_predivide_factor
        with torch.no_grad():
            grads = torch._foreach_div(self.acc, denom)
            finite = bool(grads_finite(grads)) if self.fp16_enabled else True
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
        fp16 = self.config.fp16
        self._scale = update_scale(
            self._scale, finite, dynamic=self.dynamic_loss_scale,
            scale_window=fp16.loss_scale_window,
            min_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis)
        self._compute_stale = True
        self._last_grad_norm = gnorm
        return {"grad_norm": gnorm, "finite": finite}

    def _optimizer_step(self, grads: List[torch.Tensor]) -> None:
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
        wcb = self.config.wall_clock_breakdown
        self.tput_timer.start()
        if wcb:
            self.timers("train_batch").start()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for batch in micros:
            loss = self._micro_forward(batch)
            self._micro_backward(loss)
            loss_sum += loss.detach().float()
        metrics = self._apply_update()
        metrics["loss"] = loss_sum / gas
        if wcb:
            self.timers("train_batch").stop(sync=True)
        will_report = (self.global_steps + 1) % self.steps_per_print() == 0
        self.tput_timer.stop(sync=will_report)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += self.train_batch_size()
        self._after_step(metrics)
        return metrics["loss"]

    # --- 3-call API -------------------------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """One micro-batch's loss, with its graph (backward comes next)."""
        self._pending_loss = self._micro_forward(batch)
        return self._pending_loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None,
                 allreduce_gradients: bool = True) -> torch.Tensor:
        """Backward of ``loss`` (default: the last forward's) into the
        accumulator; the gradient-accumulation bookkeeping point."""
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
        """Loss of ``batch`` on the compute-dtype params, no grads."""
        self._cast_params()
        return self._loss_of(self._to_device(batch))

    # ------------------------------------------------------------ dataloader
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        bs = batch_size or (self.train_micro_batch_size_per_gpu()
                            * self.dp_world_size)
        return DeepSpeedDataLoader(dataset, batch_size=bs,
                                   collate_fn=collate_fn or self.collate_fn,
                                   drop_last=self.config.dataloader_drop_last)

    # ----------------------------------------------------------- checkpoints
    def save_checkpoint(self, *args, **kwargs):
        raise _not_ported("checkpoint save", "A4.9")

    def load_checkpoint(self, *args, **kwargs):
        raise _not_ported("checkpoint load", "A4.9")
