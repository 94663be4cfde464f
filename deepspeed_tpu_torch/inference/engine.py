"""Inference engine: KV-cached generation on one device, or over tp or ep
ranks.

Counterpart of ``deepspeed_tpu/inference/engine.py``.
The engine takes its weights from ``model_parameters`` (a ``state_dict``),
a ``checkpoint`` written by the port's ``save_checkpoint``, or the module
itself; applies an ``injection_policy`` to that ``state_dict``; casts the
floating-point parameters to ``dtype`` (the reference's
``_convert_to_dtype``); under ``quantize_bits=8`` quantizes the cast GEMM
weights to int8 at rest (``ops/quantizer.quantize_module``: each Linear
dequantized just before its matmul, one at a time); moves the model to
``device`` in place; and serves ``forward`` and ``generate``.

It takes the TPU engine's whole parameter list. ``config``, ``max_tokens``
and ``replace_with_kernel_inject`` are read by neither engine and are taken
at any value; ``quantize_mode`` keeps the TPU engine's ``ValueError``s.

``mp_size`` (tensor parallelism) lays the world out as a mesh with that tp
axis (tp partners are consecutive ranks; the rest of the world is dp):
each rank keeps its shard of the model, by the TPU package's ``tp_spec``
(``models.gpt.set_tensor_parallel``) or, under ``replace_method="auto"``,
by the policy-free classification (``module_inject.auto_tp``; at one rank
it splits nothing). The model is given whole and split here, after the
int8 quantization (a row-split shard's scales are its whole columns'), or
given already split at ``mp_size`` (``models.gpt.init_tp_shards``: a model
too large to build whole). Every tp rank is given the same inputs and
returns the same whole logits and tokens. An MoE model, or ``mp_size`` and
``ep_size`` both above 1, raise naming ROADMAP A9.

``ep_size`` (an MoE model) lays the world out as a mesh with that ep axis
(``parallel/mesh.py``; the world must be a multiple of it): each rank
keeps its ep coordinate's ``E / ep`` experts of every expert bank, so the
expert bytes at rest divide by ep, and each MoE call all-gathers the
expert outputs over the ep group. Every rank is given the same inputs and
computes the same outputs. As in the TPU engine, ``ep_size > 1`` with
``replace_method="auto"`` raises, and so does an ep that shards no expert
bank; the cast to ``dtype`` covers the gate's ``wg`` too (the gate then
computes in f32 from the cast weights).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..checkpoint import saving as ckpt_saving
from ..comm import comm
from ..models.gpt import GPT, set_tensor_parallel
from ..module_inject.auto_tp import auto_tp
from ..moe.layer import moe_layers, set_expert_parallel
from ..ops.quantizer import quantize_module
from ..parallel import mesh as mesh_lib
from ..runtime.engine import _not_ported
from ..utils.device import resolve_device
from ..utils.logging import log_dist



class InferenceEngine:
    def __init__(self, model, config=None, *, mp_size: int = 1,
                 ep_size: int = 1, dtype: torch.dtype = torch.bfloat16,
                 model_parameters: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint: Optional[str] = None,
                 replace_with_kernel_inject: bool = False,
                 injection_policy=None, quantize_bits: Optional[int] = None,
                 quantize_mode: str = "symmetric",
                 max_tokens: Optional[int] = None,
                 replace_method: Optional[str] = None, device="cuda"):
        """``model``: a ``deepspeed_tpu_torch.models.gpt.GPT`` (or any module
        with the same ``prefill`` / ``decode`` / ``logits`` interface; a
        ``BertModel`` serves ``forward``), on any device, the meta device
        included when weights are given. ``model_parameters``: an optional
        ``state_dict`` loaded into it (``convert.jax_params_to_state_dict``
        makes one from TPU weights, ``module_inject`` from HF or Megatron
        ones); ``checkpoint``: a checkpoint directory (its ``latest`` tag)
        or a ``model_states.npz``, read when ``model_parameters`` is None;
        without either the model keeps its own weights.
        ``injection_policy``: a callable applied to that ``state_dict``
        before the cast. ``quantize_bits=8``: int8 GEMM weights,
        ``quantize_mode`` "symmetric" or "asymmetric", grouped across the
        layers when the model's config has ``scan_layers``, as the TPU
        engine's stacked tree is. ``device`` defaults to the card; a CUDA
        device without CUDA raises."""
        if replace_method == "auto" and ep_size > 1:
            raise ValueError(
                "ep_size > 1 with replace_method='auto' is unsupported: "
                "auto-TP classifies plain Linear kernels and knows nothing "
                "about expert banks; use the native MoE model path")
        if quantize_mode not in ("symmetric", "asymmetric"):
            raise ValueError(
                f"quantize_mode {quantize_mode!r}: use 'symmetric' or "
                f"'asymmetric'")
        if quantize_mode != "symmetric" and quantize_bits != 8:
            raise ValueError(
                "quantize_mode='asymmetric' without quantize_bits=8 would "
                "silently run unquantized; pass quantize_bits=8")
        if quantize_bits not in (None, 8):
            raise ValueError(f"quantize_bits={quantize_bits!r}: the engine "
                             f"quantizes weights to 8 bits only")
        self.device = resolve_device(device)
        self.ep_world_size = int(ep_size)
        self.mp_world_size = int(mp_size)
        if self.mp_world_size > 1 and self.ep_world_size > 1:
            raise _not_ported(f"mp_size={mp_size} with ep_size={ep_size}",
                              "A9")
        if self.ep_world_size > 1 or self.mp_world_size > 1:
            comm.init_distributed(device=self.device)
        self.mesh = self.tp_group = None
        if model_parameters is None and checkpoint is not None:
            model_parameters = self._load_checkpoint(checkpoint)
        if injection_policy is not None:
            if model_parameters is None:
                model_parameters = model.state_dict()
            model_parameters = injection_policy(model_parameters)
        if model_parameters is not None:
            # a meta-device model takes the tensors themselves
            meta = any(p.is_meta for p in model.parameters())
            model.load_state_dict(model_parameters, assign=meta)
        self.quantized = quantize_bits == 8
        if self.quantized and moe_layers(model):
            raise _not_ported("quantize_bits=8 over an MoE model (the "
                              "expert banks and the gate)", "A9")
        if self.ep_world_size > 1:
            self._shard_experts(model)
        presplit = getattr(model, "tp_size", 1) > 1
        if presplit and model.tp_size != self.mp_world_size:
            raise ValueError(f"the model is split over tp={model.tp_size}, "
                             f"the engine's mp_size is {mp_size}")
        if self.quantized:
            if presplit:
                raise ValueError(
                    "quantize_bits=8 over a model split already: the int8 "
                    "scales are the whole columns', so quantize whole "
                    "weights (give the model whole)")
            cfg = getattr(model, "cfg", None)
            quantize_module(model, mode=quantize_mode, dtype=dtype,
                            device=self.device,
                            scan_layers=getattr(cfg, "scan_layers", False))
        if self.mp_world_size > 1:
            self._build_mesh()
            if not presplit:
                self._split_tp(model, replace_method == "auto")
        self.module = model.to(device=self.device, dtype=dtype).eval()
        self.dtype = dtype
        log_dist(f"inference engine ready: device={self.device} "
                 f"dtype={dtype} tp={self.mp_world_size} "
                 f"ep={self.ep_world_size} quantized={self.quantized}",
                 ranks=[0])

    def _build_mesh(self) -> None:
        """The world laid out with the engine's tp and ep axes (the rest
        dp), and this rank's tp group."""
        self.mesh = mesh_lib.ensure_global_mesh(mesh_lib.MeshShape.infer(
            comm.get_world_size(), tp=self.mp_world_size,
            ep=self.ep_world_size))
        self.tp_group = comm.new_group("tp", self.mesh)

    def _split_tp(self, model, auto: bool) -> None:
        """This rank's tp shard of the whole ``model``: by classification
        under ``replace_method="auto"``, else by ``tp_spec`` (a GPT)."""
        if moe_layers(model):
            raise _not_ported(f"an MoE model at mp_size="
                              f"{self.mp_world_size}", "A9")
        if auto:
            auto_tp(model, self.tp_group)
            return
        if not hasattr(model, "cfg") or not isinstance(model, GPT):
            raise ValueError(
                f"mp_size={self.mp_world_size} splits a GPT by its tp_spec; "
                f"pass replace_method='auto' to split a "
                f"{type(model).__name__} by classification")
        set_tensor_parallel(model, self.tp_group)

    def _shard_experts(self, model) -> None:
        """The ep mesh over the world; each MoE layer keeps this rank's
        experts. An ep that shards no expert bank raises, as in the TPU
        engine."""
        ep = self.ep_world_size
        banks = [layer.experts.num_experts for layer in moe_layers(model)]
        if not banks or any(n % ep for n in banks):
            raise ValueError(
                f"ep_size={ep} sharded no parameter: the model has no "
                f"expert banks whose expert dim divides by {ep} (check "
                f"num_experts % ep_size == 0, or drop ep_size)")
        self._build_mesh()
        set_expert_parallel(model, comm.new_group("ep", self.mesh))

    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        return ids[None] if ids.dim() == 1 else ids

    def _load_checkpoint(self, checkpoint: str):
        """The fp32 weights by ``state_dict`` name from a checkpoint
        directory (the tag its ``latest`` file names) or a
        ``model_states.npz`` path."""
        if os.path.isdir(checkpoint):
            tag = ckpt_saving.read_latest_tag(checkpoint)
            path = os.path.join(checkpoint, tag or "", "model_states.npz")
        else:
            path = checkpoint
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path}: no model_states.npz (a host-sharded checkpoint "
                f"has per-rank shard files: consolidate it with the "
                f"zero_to_fp32.py script in its tag directory, then pass "
                f"the .npz it writes)")
        arrays = ckpt_saving.load_tree_arrays(path)
        log_dist(f"loaded inference checkpoint from {path}", ranks=[0])
        return {k: torch.from_numpy(v) for k, v in arrays.items()}

    @torch.inference_mode()
    def forward(self, input_ids, **kwargs):
        """Plain (non-incremental) forward: a GPT's logits [B, S, V]. Extra
        model inputs (``attention_mask``, ``token_type_ids``, ...) pass
        through, moved to the device; None ones are dropped. A ``(logits,
        scalar)`` pair is unwrapped to the logits, as the TPU engine does;
        other tuples (BERT's sequence and pooled outputs) pass through."""
        kw = {k: (v if torch.is_tensor(v) else torch.as_tensor(
                  np.asarray(v))).to(self.device)
              for k, v in kwargs.items() if v is not None}
        out = self.module(self._ids(input_ids), **kw)
        if (isinstance(out, tuple) and len(out) == 2
                and torch.is_tensor(out[1]) and out[1].dim() == 0):
            out = out[0]
        return out

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

        # (hidden, keys, values) or, under the int8 cache, also the scales
        hidden, keys, values, *scales = self.module.prefill(ids)
        shape = (cfg.num_layers, b, cfg.max_seq_len, keys.shape[-1])
        cache_k = torch.zeros(shape, dtype=keys.dtype, device=self.device)
        cache_v = torch.zeros(shape, dtype=keys.dtype, device=self.device)
        cache_k[:, :, :s] = keys
        cache_v[:, :, :s] = values
        k_scale = v_scale = None
        if scales:
            k_scale = torch.zeros(shape[:3], device=self.device)
            v_scale = torch.zeros(shape[:3], device=self.device)
            k_scale[:, :, :s], v_scale[:, :, :s] = scales
        token = sample(self.module.logits(hidden[:, -1]))
        done = (torch.zeros_like(token, dtype=torch.bool)
                if eos_token_id is None else token == eos_token_id)
        out = [token]
        pos = torch.full((b,), s, dtype=torch.long, device=self.device)
        for _ in range(max_new_tokens - 1):
            logits = self.module.decode(token[:, None], pos[:, None],
                                        cache_k, cache_v, pos,
                                        k_scale=k_scale, v_scale=v_scale)
            nxt = sample(logits[:, -1])
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt)
            token = nxt
            pos = pos + 1
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
