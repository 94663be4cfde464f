"""Inference engine: KV-cached generation on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py`` at tp=1: no mesh, no
weight quantization, no checkpoint loading (each waits for a later slice).
The engine casts the model's floating-point parameters to ``dtype`` (the
reference's ``_convert_to_dtype``), moves the model to ``device`` in place,
and serves ``forward`` and ``generate``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import log_dist


class InferenceEngine:
    def __init__(self, model, *, dtype: torch.dtype = torch.bfloat16,
                 model_parameters: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda"):
        """``model``: a ``deepspeed_tpu_torch.models.gpt.GPT`` (or any module
        with the same ``prefill`` / ``decode`` / ``logits`` interface).
        ``model_parameters``: an optional ``state_dict`` loaded into it
        (``convert.jax_params_to_state_dict`` makes one from TPU weights).
        ``device`` defaults to the card; a CUDA device without CUDA
        raises."""
        self.device = resolve_device(device)
        if model_parameters is not None:
            model.load_state_dict(model_parameters)
        self.module = model.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype
        log_dist(f"inference engine ready: device={self.device} "
                 f"dtype={dtype}", ranks=[0])

    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        return ids[None] if ids.dim() == 1 else ids

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Plain (non-incremental) causal forward -> logits [B, S, V]."""
        return self.module(self._ids(input_ids))

    __call__ = forward

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Greedy (temperature 0) or sampled generation with a KV cache:
        one prefill over the [b, s] prompt, then one decode step per token.
        Rows that hit ``eos_token_id`` keep emitting it. Returns
        [b, s + max_new_tokens]."""
        ids = self._ids(input_ids)
        b, s = ids.shape
        cfg = self.module.cfg
        if s + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the model's max_seq_len ({cfg.max_seq_len})")

        def sample(logits):
            logits = logits.float()
            if temperature not in (0.0, 1.0):
                logits = logits / temperature
            if top_k is not None:
                kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
                logits = torch.where(logits < kth, -1e10, logits)
            if temperature == 0.0:
                return torch.argmax(logits, dim=-1)
            return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=generator)[:, 0]

        hidden, keys, values = self.module.prefill(ids)
        shape = (cfg.num_layers, b, cfg.max_seq_len, keys.shape[-1])
        cache_k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        cache_v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        cache_k[:, :, :s] = keys
        cache_v[:, :, :s] = values
        token = sample(self.module.logits(hidden[:, -1]))
        done = (torch.zeros_like(token, dtype=torch.bool)
                if eos_token_id is None else token == eos_token_id)
        out = [token]
        pos = torch.full((b,), s, dtype=torch.long, device=self.device)
        for _ in range(max_new_tokens - 1):
            logits = self.module.decode(token[:, None], pos[:, None],
                                        cache_k, cache_v, pos)
            nxt = sample(logits[:, -1])
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt)
            token = nxt
            pos = pos + 1
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
