"""Pipeline parallelism (counterpart of ``deepspeed_tpu/runtime/pipe``).

Two engines:
  * ``PipelineEngine`` (engine.py): 1F1B over the mesh's pp axis, one
    stage a rank (or every stage in one process at pp 1); composes with
    dp / ZeRO-1/2 / ep inside each stage;
  * ``GPipeSpmdEngine`` (spmd.py): GPipe over a (pp, dp) grid of ranks,
    every rank running the same tick loop over its stage's blocks.
"""

from .module import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: F401
from .spmd import (GPipeSpmdEngine, StackedPipeSpec,  # noqa: F401
                   bert_mlm_pipe_spec, gpt_pipe_spec)
