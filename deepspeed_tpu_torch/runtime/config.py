"""Typed config system: the port's own copy of
``deepspeed_tpu/runtime/config.py`` (same JSON vocabulary, same unknown-key
rejection, same batch algebra). ``compute_dtype`` is a torch dtype. The
elasticity block parses, but enabling it raises until elasticity is ported.

Reference analogue: ``deepspeed/runtime/config.py`` (``DeepSpeedConfig`` at
config.py:765, ~90 ``get_*`` accessors at :82-746, batch-size reconciliation
``train_batch = micro_batch x GAS x dp_world`` and sanity checks at :1026),
plus the nested sub-configs (``zero/config.py:14``, ``zero/offload_config.py``,
``swap_tensor/aio_config.py:18``, monitor/flops/autotuning configs).

Design: plain dataclasses with a single ``from_dict`` path that accepts the
SAME JSON key vocabulary as the reference (so existing DeepSpeed configs work
unmodified), performs strict unknown-key detection, and resolves the batch
algebra against the data-parallel world size taken from the device mesh.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from .constants import OFFLOAD_CPU, OFFLOAD_NONE, OFFLOAD_NVME


def _tolerant_json_load(text: str, path: str) -> Dict[str, Any]:
    """Parse a config file, tolerating hjson-style relaxations the
    reference ecosystem uses in its shipped configs (// and /* */ and #
    comments, trailing commas). Strict JSON parses unchanged; only on a
    strict failure is the comment-stripped form tried, so no valid JSON
    document can change meaning (string literals are respected while
    stripping)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError as strict_err:
        out, i, n = [], 0, len(text)
        in_str = False
        while i < n:
            c = text[i]
            if in_str:
                out.append(c)
                if c == "\\" and i + 1 < n:
                    out.append(text[i + 1])
                    i += 2
                    continue
                if c == '"':
                    in_str = False
                i += 1
            elif c == '"':
                in_str = True
                out.append(c)
                i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "/":
                while i < n and text[i] != "\n":
                    i += 1
            elif c == "#":
                while i < n and text[i] != "\n":
                    i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "*":
                i += 2
                while i + 1 < n and not (text[i] == "*"
                                         and text[i + 1] == "/"):
                    i += 1
                i += 2
            elif c in "}]":
                # trailing comma: drop a comma whose next non-space char
                # closes the container (done HERE, outside strings — a
                # whole-document regex would mangle string values
                # containing ",}" / ",]")
                k = len(out) - 1
                while k >= 0 and out[k] in " \t\r\n":
                    k -= 1
                if k >= 0 and out[k] == ",":
                    del out[k]
                out.append(c)
                i += 1
            else:
                out.append(c)
                i += 1
        try:
            return json.loads("".join(out))
        except json.JSONDecodeError:
            raise DeepSpeedConfigError(
                f"could not parse {path!r} as JSON (also tried "
                f"comment/trailing-comma-tolerant mode): {strict_err}"
            ) from strict_err


class DeepSpeedConfigError(Exception):
    pass


def _take(d: Dict[str, Any], cls, aliases: Dict[str, str] = None):
    """Build dataclass `cls` from dict `d`, erroring on unknown keys."""
    aliases = aliases or {}
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        k2 = aliases.get(k, k)
        if k2 not in names:
            raise DeepSpeedConfigError(
                f"{cls.__name__}: unknown config key {k!r} "
                f"(valid: {sorted(names)})")
        if k2 in kwargs:
            raise DeepSpeedConfigError(
                f"{cls.__name__}: {k!r} duplicates a key already given "
                f"under another spelling ({k2!r}); set it once")
        kwargs[k2] = v
    return cls(**kwargs)


# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------

@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0          # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False
    auto_cast: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclass
class BF16Config:
    enabled: bool = False
    # stochastic rounding for the per-step fp32-master -> bf16 compute
    # cast (the reference's StochasticTransformerBuilder training mode,
    # csrc/transformer/ds_transformer_cuda.cpp:1031-1046): unbiased casts
    # remove the systematic round-to-nearest drift at low precision
    stochastic_rounding: bool = False


@dataclass
class OffloadParamConfig:
    """zero/offload_config.py:38 — param offload target."""
    device: str = OFFLOAD_NONE       # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False
    # stream transformer blocks through HBM one layer at a time (ZeRO-
    # Infinity capacity tier on a single chip: max params becomes a host
    # DRAM/NVMe bound, not an HBM bound); see runtime/zero/layer_stream.py
    layer_streaming: bool = False


@dataclass
class OffloadOptimizerConfig:
    """zero/offload_config.py:55 — optimizer-state offload target."""
    device: str = OFFLOAD_NONE
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0


@dataclass
class ZeROConfig:
    """zero/config.py:14-197."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: OffloadParamConfig = field(default_factory=OffloadParamConfig)
    offload_optimizer: OffloadOptimizerConfig = field(default_factory=OffloadOptimizerConfig)
    sub_group_size: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    cpu_offload: Optional[bool] = None          # legacy alias
    cpu_offload_params: Optional[bool] = None   # legacy alias

    def __post_init__(self):
        if isinstance(self.offload_param, dict):
            self.offload_param = _take(self.offload_param, OffloadParamConfig)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = _take(self.offload_optimizer, OffloadOptimizerConfig)
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3
        if self.cpu_offload:
            self.offload_optimizer.device = OFFLOAD_CPU
        if self.cpu_offload_params:
            self.offload_param.device = OFFLOAD_CPU
        if not 0 <= self.stage <= 3:
            raise DeepSpeedConfigError(f"zero stage must be 0-3, got {self.stage}")


@dataclass
class ActivationCheckpointingConfig:
    """activation_checkpointing/config.py."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass
class AIOConfig:
    """swap_tensor/aio_config.py:18 — knobs for the native async-IO module."""
    block_size: int = 1_048_576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class FlopsProfilerConfig:
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class MonitorBackendConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"
    # wandb extras
    team: Optional[str] = None
    group: Optional[str] = None
    project: Optional[str] = None


@dataclass
class CurriculumConfig:
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ProgressiveLayerDropConfig:
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclass
class EigenvalueConfig:
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


@dataclass
class QuantizeTrainingConfig:
    """MoQ (runtime/quantize.py): progressive bit-width quantization-aware
    training."""
    enabled: bool = False
    quantize_verbose: bool = False
    quantizer_kernel: bool = False
    quantize_type: str = "symmetric"
    quantize_bits: Dict[str, int] = field(default_factory=lambda: {"start_bits": 16, "target_bits": 8})
    quantize_schedule: Dict[str, Any] = field(default_factory=dict)
    quantize_groups: int = 1
    fp16_mixed_quantize: Dict[str, Any] = field(default_factory=dict)
    eigenvalue: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SparseAttentionConfig:
    mode: str = "fixed"
    block: int = 16
    different_layout_per_head: bool = False
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1
    num_random_blocks: int = 0
    local_window_blocks: List[int] = field(default_factory=lambda: [4])
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None
    num_sliding_window_blocks: int = 3


@dataclass
class PipelineConfig:
    stages: int = 1
    partition_method: str = "parameters"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True


@dataclass
class CommsConfig:
    """Compressed-communication settings (1-bit style)."""
    compression: str = "none"        # none | onebit
    comm_backend_name: str = "nccl"


@dataclass
class AutotuningConfig:
    enabled: bool = False
    fast: bool = True
    results_dir: Optional[str] = None
    exps_dir: Optional[str] = None
    overwrite: bool = False
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    arg_mappings: Dict[str, str] = field(default_factory=dict)
    max_train_batch_size: Optional[int] = None
    mp_size: int = 1


@dataclass
class ElasticityConfig:
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.1
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True
    chip_multiple: int = 1   # TPU extension: scale in whole hosts/slices


@dataclass
class MeshConfig:
    """TPU-only extension: requested mesh axis sizes. dp=None => fill to
    cover all devices."""
    dp: Optional[int] = None
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1


@dataclass
class OptimizerConfig:
    type: str = "Adam"
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: Dict[str, Any] = field(default_factory=dict)


# Reference JSON spells the stage-3 working-set knobs with a "stage3_"
# prefix (zero/config.py:14-197); accept both spellings.
_ZERO_KEY_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save":
        "gather_16bit_weights_on_model_save",
}

_SUBCONFIG_KEYS = {
    "fp16": ("fp16", FP16Config),
    "bf16": ("bf16", BF16Config),
    "bfloat16": ("bf16", BF16Config),
    "zero_optimization": ("zero_config", ZeROConfig),
    "activation_checkpointing": ("activation_checkpointing", ActivationCheckpointingConfig),
    "aio": ("aio", AIOConfig),
    "flops_profiler": ("flops_profiler", FlopsProfilerConfig),
    "tensorboard": ("tensorboard", MonitorBackendConfig),
    "wandb": ("wandb", MonitorBackendConfig),
    "csv_monitor": ("csv_monitor", MonitorBackendConfig),
    "curriculum_learning": ("curriculum_learning", CurriculumConfig),
    "progressive_layer_drop": ("progressive_layer_drop", ProgressiveLayerDropConfig),
    "eigenvalue": ("eigenvalue", EigenvalueConfig),
    "quantize_training": ("quantize_training", QuantizeTrainingConfig),
    "sparse_attention": ("sparse_attention", SparseAttentionConfig),
    "pipeline": ("pipeline", PipelineConfig),
    "comms": ("comms", CommsConfig),
    "autotuning": ("autotuning", AutotuningConfig),
    "elasticity": ("elasticity", ElasticityConfig),
    "optimizer": ("optimizer", OptimizerConfig),
    "scheduler": ("scheduler", SchedulerConfig),
    "mesh": ("mesh", MeshConfig),
}

# JSON key -> attribute name (defaults live on the dataclass fields).
_SCALAR_KEYS = {k: k for k in (
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "gradient_accumulation_steps", "steps_per_print", "gradient_clipping",
    "prescale_gradients", "gradient_predivide_factor", "wall_clock_breakdown",
    "memory_breakdown", "dump_state", "disable_allgather",
    "communication_data_type", "sparse_gradients",
    "zero_allow_untested_optimizer", "checkpoint_tag_validation",
    "dataloader_drop_last", "amp", "seed", "sharded_checkpoint",
)}


@dataclass
class DeepSpeedConfig:
    """The resolved config. Construct with ``DeepSpeedConfig(json_or_dict,
    dp_world_size=...)``; attribute names follow the reference's engine
    accessors (engine.py:457-746)."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False
    disable_allgather: bool = False
    communication_data_type: Optional[str] = None
    sparse_gradients: bool = False
    zero_allow_untested_optimizer: bool = False
    checkpoint_tag_validation: str = "warn"
    # "auto": per-rank parallel shard files when the state is big or the job
    # is multi-host; True/False force. Reference always shards
    # (zero_pp_rank_* files); npz full-gather is kept as the small-model path
    sharded_checkpoint: "str | bool" = "auto"
    dataloader_drop_last: bool = False
    amp: Optional[dict] = None
    seed: int = 42

    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_config: ZeROConfig = field(default_factory=ZeROConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(default_factory=ActivationCheckpointingConfig)
    aio: AIOConfig = field(default_factory=AIOConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    tensorboard: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    wandb: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    csv_monitor: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    curriculum_learning: CurriculumConfig = field(default_factory=CurriculumConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(default_factory=ProgressiveLayerDropConfig)
    eigenvalue: EigenvalueConfig = field(default_factory=EigenvalueConfig)
    quantize_training: QuantizeTrainingConfig = field(default_factory=QuantizeTrainingConfig)
    sparse_attention: Optional[SparseAttentionConfig] = None
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    comms: CommsConfig = field(default_factory=CommsConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)

    dp_world_size: int = 1

    def __init__(self, config=None, dp_world_size: int = 1, **kwargs):
        # dataclass-style defaults
        for f in dataclasses.fields(type(self)):
            if f.default is not dataclasses.MISSING:
                setattr(self, f.name, f.default)
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                setattr(self, f.name, f.default_factory())  # type: ignore
        self.sparse_attention = None
        self.optimizer = None
        self.scheduler = None
        self.dp_world_size = dp_world_size

        raw: Dict[str, Any] = {}
        if isinstance(config, str):
            with open(config) as fh:
                raw = _tolerant_json_load(fh.read(), config)
        elif isinstance(config, dict):
            raw = dict(config)
        elif config is None:
            raw = {}
        else:
            raise DeepSpeedConfigError(
                f"config must be a dict or a path, got {type(config)}")
        raw.update(kwargs)
        self._raw = raw

        for key, value in raw.items():
            if key in _SUBCONFIG_KEYS:
                attr, cls = _SUBCONFIG_KEYS[key]
                if not isinstance(value, dict):
                    raise DeepSpeedConfigError(f"{key} must be an object")
                aliases = _ZERO_KEY_ALIASES if key == "zero_optimization" else None
                setattr(self, attr, _take(value, cls, aliases))
            elif key in _SCALAR_KEYS:
                setattr(self, _SCALAR_KEYS[key], value)
            elif key.startswith("#") or key.startswith("_comment"):
                continue
            else:
                raise DeepSpeedConfigError(f"unknown top-level config key {key!r}")

        self._resolve_batch_sizes()
        self._sanity_check()

    # -- batch algebra (reference config.py:934-1024) ----------------------
    def _resolve_batch_sizes(self):
        if self.elasticity.enabled:
            self._resolve_elastic_batch_sizes()
            return
        tb = self.train_batch_size
        mb = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = self.dp_world_size
        if tb is not None and mb is not None and gas is not None:
            pass
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp)
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp
        elif tb is not None:
            gas = 1
            mb = tb // dp
        elif mb is not None:
            gas = 1
            tb = mb * dp
        else:
            mb, gas = 1, 1
            tb = dp
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    def _resolve_elastic_batch_sizes(self):
        """Elasticity owns the batch algebra in the TPU package
        (elasticity/elasticity.py); it is not ported yet."""
        raise NotImplementedError(
            "elasticity.enabled: elasticity is not ported yet "
            "(ROADMAP A13)")

    def _sanity_check(self):
        tb = self.train_batch_size
        mb = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if tb != mb * gas * self.dp_world_size:
            raise DeepSpeedConfigError(
                f"batch algebra violated: train_batch_size({tb}) != "
                f"micro_batch({mb}) * gas({gas}) * dp_world({self.dp_world_size})")
        if tb <= 0 or mb <= 0 or gas <= 0:
            raise DeepSpeedConfigError("batch sizes must be positive")
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        zc = self.zero_config
        if zc.offload_param.device == OFFLOAD_NVME and zc.stage != 3:
            raise DeepSpeedConfigError("NVMe param offload requires ZeRO stage 3")
        if zc.offload_optimizer.device != OFFLOAD_NONE and zc.stage == 0:
            raise DeepSpeedConfigError("optimizer offload requires ZeRO >= 1")

    # -- convenience views --------------------------------------------------
    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    def print_config(self):
        from ..utils.logging import logger
        logger.info(json.dumps(self._raw, indent=2, sort_keys=True))
