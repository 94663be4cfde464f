"""deepspeed_tpu_torch: the PyTorch / CUDA port of deepspeed_tpu.

Imports ``torch`` and never JAX or ``deepspeed_tpu``. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, where the
kernel wrappers run their plain PyTorch versions.
"""

from .comm.comm import init_distributed
from .inference.engine import InferenceEngine
from .models.gpt import GPT, GPTConfig
from .ops.transformer import (DeepSpeedTransformerConfig,
                              DeepSpeedTransformerLayer)
from .runtime import activation_checkpointing as checkpointing
from .runtime.config import DeepSpeedConfig, DeepSpeedConfigError
# zero.Init analogue: abstract (meta-device) construction, the counter-based
# shard fill and sharded_init (runtime/zero/partition_params.py)
from .runtime.zero import partition_params as zero
from .serving.engine import ServingEngine

__all__ = ["InferenceEngine", "ServingEngine", "GPT", "GPTConfig",
           "DeepSpeedConfig", "DeepSpeedConfigError",
           "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
           "initialize", "init_inference", "init_distributed", "zero",
           "checkpointing"]


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, rng=None, device="cuda"):
    """Build the training engine (reference ``deepspeed.initialize``).
    Returns ``(engine, optimizer, dataloader, lr_scheduler)``.

    ``model`` is a ``torch.nn.Module`` whose parameters become the fp32
    masters; ``model_parameters`` is None, ``model.parameters()`` or a
    ``state_dict`` to load into it. Under ``offload_optimizer`` the model
    may be built on the meta device (``zero.abstract_init``): each rank then
    fills its own host shards from the counter-based init. ``device`` defaults to the card; a CUDA
    device without CUDA raises. Unless ``dist_init_required`` is False the
    process joins its group first (:func:`init_distributed`: the one already
    set up, or the launcher's environment; none at one rank); the config's
    ``mesh`` block lays its ranks out over dp and ep (dp fills the world
    by default). A ``runtime.pipe.PipelineModule`` gets a
    ``PipelineEngine`` (the mesh's pp axis lays its stages over the ranks).
    ``mpu`` raises: the TPU engines store it and never read it. ``rng``
    (the engine keeps no random stream to seed) is not ported yet."""
    from .runtime.engine import DeepSpeedEngine, _not_ported
    from .runtime.pipe.engine import MPU_MESSAGE, PipelineEngine
    from .runtime.pipe.module import PipelineModule
    if mpu is not None:
        raise ValueError(MPU_MESSAGE)
    if dist_init_required is not False:
        init_distributed(device=device)
    if rng is not None:
        raise _not_ported("initialize(rng=...): the engine's random stream",
                          "A13")
    config = config if config is not None else config_params
    if args is not None and config is None:
        config = getattr(args, "deepspeed_config", None)
    engine_cls = PipelineEngine if isinstance(model, PipelineModule) \
        else DeepSpeedEngine
    engine = engine_cls(model=model, optimizer=optimizer,
                        model_parameters=model_parameters,
                        training_data=training_data,
                        lr_scheduler=lr_scheduler,
                        collate_fn=collate_fn, config=config,
                        loss_fn=loss_fn, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, **kwargs) -> InferenceEngine:
    """Build an :class:`InferenceEngine`: every keyword of the TPU
    package's ``init_inference``, and ``device``."""
    return InferenceEngine(model, **kwargs)
