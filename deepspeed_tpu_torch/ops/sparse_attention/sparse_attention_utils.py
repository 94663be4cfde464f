"""Model-integration helpers for block-sparse attention.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``
(reference ``SparseAttentionUtils``): sequences must be whole layout blocks,
so BERT pads its inputs and masks the padding as keys
(``pad_to_block_size``, ``unpad_sequence_output``); a learned position
table is tiled out to a longer sequence (``extend_position_embedding``);
and a GPT runs block-sparse by config, not by module surgery
(``sparse_gpt_config``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    @staticmethod
    def pad_to_block_size(block: int, input_ids: torch.Tensor, *,
                          attention_mask=None, token_type_ids=None,
                          pad_token_id: int = 0):
        """Right-pad [B, S] inputs so S is a whole number of sparsity
        blocks. Returns (pad_len, input_ids, attention_mask,
        token_type_ids); the mask zeros the padding so attention ignores
        it."""
        b, s = input_ids.shape
        pad_len = (-s) % block
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=input_ids.device)
        if pad_len == 0:
            return 0, input_ids, attention_mask, token_type_ids
        input_ids = F.pad(input_ids, (0, pad_len), value=pad_token_id)
        attention_mask = F.pad(attention_mask, (0, pad_len))
        if token_type_ids is not None:
            token_type_ids = F.pad(token_type_ids, (0, pad_len))
        return pad_len, input_ids, attention_mask, token_type_ids

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Drop the padding rows again."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]

    @staticmethod
    def extend_position_embedding(wpe: torch.Tensor,
                                  max_position: int) -> torch.Tensor:
        """The position table [P, D] tiled (or cut) to ``max_position`` rows:
        the learned table repeats, so a 512-position model can run longer
        sparse sequences."""
        cur = wpe.shape[0]
        if max_position <= cur:
            return wpe[:max_position]
        reps = -(-max_position // cur)
        return wpe.repeat(reps, 1)[:max_position]

    @staticmethod
    def sparse_gpt_config(cfg, sparsity_config) -> Any:
        """``cfg`` (a ``models.gpt.GPTConfig``) with block-sparse attention
        over ``sparsity_config``: the module-patch step of the reference
        (``replace_model_self_attention``) is a config choice here."""
        return dataclasses.replace(cfg, attention_impl="sparse",
                                   sparse_attention=sparsity_config)
