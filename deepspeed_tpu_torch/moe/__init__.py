"""Mixture-of-Experts (the port of ``deepspeed_tpu/moe``)."""

from .experts import Experts, ExpertMLP
from .layer import MoE, moe_layers, set_expert_parallel
from .sharded_moe import (GateDraws, MOELayer, TopKGate, draw_gate_noise,
                          top1gating, top2gating)
from .utils import (count_moe_params, is_moe_param, is_moe_param_path,
                    moe_param_mask, split_params_into_shared_and_expert)
