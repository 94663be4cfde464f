"""deepspeed_tpu_torch: the PyTorch / CUDA port of deepspeed_tpu.

Imports ``torch`` and never JAX or ``deepspeed_tpu``. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, where the
kernel wrappers run their plain PyTorch versions.
"""

from .inference.engine import InferenceEngine
from .models.gpt import GPT, GPTConfig
from .serving.engine import ServingEngine

__all__ = ["InferenceEngine", "ServingEngine", "GPT", "GPTConfig",
           "init_inference"]


def init_inference(model=None, **kwargs) -> InferenceEngine:
    """Build an :class:`InferenceEngine` (``dtype``, ``model_parameters``,
    ``device`` keywords)."""
    return InferenceEngine(model, **kwargs)
