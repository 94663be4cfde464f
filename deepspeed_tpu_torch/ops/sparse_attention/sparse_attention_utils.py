"""Input-geometry helpers for block-sparse attention.

Counterpart of ``pad_to_block_size`` and ``unpad_sequence_output`` in
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``: sequences
must be whole layout blocks, so BERT pads its inputs and masks the padding
as keys. The rest of that module (``extend_position_embedding``,
``sparse_gpt_config``) is not ported yet (ROADMAP A4.5).
"""

from __future__ import annotations

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
