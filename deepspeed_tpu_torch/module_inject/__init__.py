"""Module injection: HF and Megatron checkpoints into the port's models."""

from .policies import (HFGPT2Policy, HFGPTNeoPolicy, load_hf_model,
                       policy_for)
