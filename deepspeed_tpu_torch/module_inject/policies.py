"""Injection policies: HuggingFace and Megatron checkpoints -> the port's
models.

Counterpart of ``deepspeed_tpu/module_inject/policies.py`` (reference
``module_inject/replace_policy.py``: the per-architecture weight
adapters). A policy's ``config_from_hf`` gives the port's ``GPTConfig`` or
``BertConfig`` with the TPU policy's fields, and its ``convert`` maps a
foreign state dict (torch tensors or numpy arrays) straight onto the port
model's ``state_dict``: per-layer names, Linear weights ``[out, in]``, each
tensor on its input's device and in its dtype. The TPU policy builds a
flax tree instead; ``convert.jax_params_to_state_dict`` of that tree equals
this ``state_dict``. ``export`` goes back (GPT-2, BERT).

``load_hf_model`` takes any object with ``.config.model_type`` and
``.state_dict()``; this module never imports ``transformers``.

One deliberate divergence: the TPU GPT-J policy drops ``lm_head.bias``
(its head is bias-free). The port's policy takes a zero bias and raises on
a nonzero one rather than serve different logits.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.bert import BertConfig
from ..models.gpt import GPTConfig


def _t(x) -> torch.Tensor:
    """A tensor or an array -> a tensor (a numpy array shares its memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.asarray(x))


def _lin_t(x) -> torch.Tensor:
    """An HF ``Conv1D`` weight [in, out] -> a Linear weight [out, in]."""
    return _t(x).T.contiguous()


def _zeros_like_rows(w: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=w.dtype, device=w.device)


def _strip(state_dict: Dict[str, Any], *prefixes: str) -> Dict[str, Any]:
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            k = k.removeprefix(p)
        out[k] = v
    return out


def _gpt_cfg(**kw) -> GPTConfig:
    return GPTConfig(dtype=torch.float32, param_dtype=torch.float32,
                     remat=False, **kw)


class HFGPT2Policy:
    """GPT-2: ``Conv1D`` layers ([in, out], transposed here) with the fused
    ``c_attn`` = q | k | v, the port's qkv order; tied head."""

    @staticmethod
    def config_from_hf(hf_config) -> GPTConfig:
        return _gpt_cfg(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.n_positions,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            d_model=hf_config.n_embd,
            d_ff=hf_config.n_inner or 4 * hf_config.n_embd,
            rotary=False, parallel_residual=False, tie_embeddings=True,
            scan_layers=True)

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "transformer.")
        out = {"wte.weight": _t(sd["wte.weight"]),
               "wpe": _t(sd["wpe.weight"])}
        names = {"attn.qkv": "attn.c_attn", "attn.out_proj": "attn.c_proj",
                 "mlp.up_proj": "mlp.c_fc", "mlp.down_proj": "mlp.c_proj"}
        for i in range(n_layer):
            pre, src = f"blocks.{i}.", f"h.{i}."
            for ln in ("ln_1", "ln_2"):
                out[pre + ln + ".weight"] = _t(sd[src + ln + ".weight"])
                out[pre + ln + ".bias"] = _t(sd[src + ln + ".bias"])
            for ours, theirs in names.items():
                out[pre + ours + ".weight"] = _lin_t(
                    sd[src + theirs + ".weight"])
                out[pre + ours + ".bias"] = _t(sd[src + theirs + ".bias"])
        out["ln_f.weight"] = _t(sd["ln_f.weight"])
        out["ln_f.bias"] = _t(sd["ln_f.bias"])
        return out

    @staticmethod
    def export(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The port's GPT-2 ``state_dict`` -> an HF GPT-2 state dict
        (``Conv1D`` layout, tied ``lm_head``)."""
        sd = {k: _t(v) for k, v in state_dict.items()}
        out = {"transformer.wte.weight": sd["wte.weight"],
               "transformer.wpe.weight": sd["wpe"],
               "transformer.ln_f.weight": sd["ln_f.weight"],
               "transformer.ln_f.bias": sd["ln_f.bias"]}
        n_layer = len({k.split(".")[1] for k in sd
                       if k.startswith("blocks.")})
        names = {"attn.qkv": "attn.c_attn", "attn.out_proj": "attn.c_proj",
                 "mlp.up_proj": "mlp.c_fc", "mlp.down_proj": "mlp.c_proj"}
        for i in range(n_layer):
            pre, dst = f"blocks.{i}.", f"transformer.h.{i}."
            for ln in ("ln_1", "ln_2"):
                out[dst + ln + ".weight"] = sd[pre + ln + ".weight"]
                out[dst + ln + ".bias"] = sd[pre + ln + ".bias"]
            for ours, theirs in names.items():
                out[dst + theirs + ".weight"] = \
                    sd[pre + ours + ".weight"].T.contiguous()
                out[dst + theirs + ".bias"] = sd[pre + ours + ".bias"]
        out["lm_head.weight"] = out["transformer.wte.weight"]     # tied
        return out


class HFGPTNeoPolicy:
    """GPT-Neo: separate bias-free q / k / v Linears fused into qkv,
    unscaled scores (``qk_scale=1.0``) and alternating global / local
    layers (``attn_windows`` from ``attention_layers`` and
    ``window_size``), which need ``scan_layers=False``."""

    @staticmethod
    def config_from_hf(hf_config) -> GPTConfig:
        windows = tuple(hf_config.window_size if t == "local" else None
                        for t in hf_config.attention_layers)
        return _gpt_cfg(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.max_position_embeddings,
            num_layers=hf_config.num_layers,
            num_heads=hf_config.num_heads,
            d_model=hf_config.hidden_size,
            d_ff=hf_config.intermediate_size or 4 * hf_config.hidden_size,
            rotary=False, tie_embeddings=True,
            qk_scale=1.0, attn_windows=windows, scan_layers=False)

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "transformer.")
        out = {"wte.weight": _t(sd["wte.weight"]),
               "wpe": _t(sd["wpe.weight"])}
        for i in range(n_layer):
            pre, att = f"blocks.{i}.", f"h.{i}.attn.attention."
            for ln in ("ln_1", "ln_2"):
                out[pre + ln + ".weight"] = _t(sd[f"h.{i}.{ln}.weight"])
                out[pre + ln + ".bias"] = _t(sd[f"h.{i}.{ln}.bias"])
            ws = [_t(sd[att + f"{n}_proj.weight"]) for n in "qkv"]
            bs = [_t(sd[att + f"{n}_proj.bias"])
                  if att + f"{n}_proj.bias" in sd
                  else _zeros_like_rows(w, w.shape[0])
                  for n, w in zip("qkv", ws)]
            out[pre + "attn.qkv.weight"] = torch.cat(ws, 0)
            out[pre + "attn.qkv.bias"] = torch.cat(bs, 0)
            out[pre + "attn.out_proj.weight"] = _t(
                sd[att + "out_proj.weight"])
            out[pre + "attn.out_proj.bias"] = _t(sd[att + "out_proj.bias"])
            for ours, theirs in (("up_proj", "c_fc"),
                                 ("down_proj", "c_proj")):
                out[pre + f"mlp.{ours}.weight"] = _t(
                    sd[f"h.{i}.mlp.{theirs}.weight"])
                out[pre + f"mlp.{ours}.bias"] = _t(
                    sd[f"h.{i}.mlp.{theirs}.bias"])
        out["ln_f.weight"] = _t(sd["ln_f.weight"])
        out["ln_f.bias"] = _t(sd["ln_f.bias"])
        return out


class HFGPTJPolicy:
    """GPT-J: parallel residual with one shared LayerNorm (mapped onto both
    ln_1 and ln_2), bias-free q / k / v fused into qkv and a bias-free
    out_proj, interleaved rotary over ``rotary_dim``, untied ``lm_head``.
    A nonzero ``lm_head.bias`` raises: the TPU policy drops it."""

    @staticmethod
    def config_from_hf(hf_config) -> GPTConfig:
        head_dim = hf_config.n_embd // hf_config.n_head
        return _gpt_cfg(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.n_positions,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            d_model=hf_config.n_embd,
            d_ff=hf_config.n_inner or 4 * hf_config.n_embd,
            rotary=True, rotary_pct=hf_config.rotary_dim / head_dim,
            parallel_residual=True, tie_embeddings=False,
            scan_layers=True)

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "transformer.")
        bias = sd.get("lm_head.bias")
        if bias is not None and bool((_t(bias) != 0).any()):
            raise ValueError(
                "GPT-J lm_head.bias is nonzero: the port's (and the TPU "
                "package's) untied head is bias-free, and the TPU policy "
                "would drop this bias and serve different logits")
        out = {"wte.weight": _t(sd["wte.weight"])}
        for i in range(n_layer):
            pre, src = f"blocks.{i}.", f"h.{i}."
            ln_w, ln_b = _t(sd[src + "ln_1.weight"]), _t(sd[src + "ln_1.bias"])
            out[pre + "ln_1.weight"], out[pre + "ln_1.bias"] = ln_w, ln_b
            out[pre + "ln_2.weight"] = ln_w.clone()
            out[pre + "ln_2.bias"] = ln_b.clone()
            ws = [_t(sd[src + f"attn.{n}_proj.weight"]) for n in "qkv"]
            qkv = torch.cat(ws, 0)
            out[pre + "attn.qkv.weight"] = qkv
            out[pre + "attn.qkv.bias"] = _zeros_like_rows(qkv, qkv.shape[0])
            o = _t(sd[src + "attn.out_proj.weight"])
            out[pre + "attn.out_proj.weight"] = o
            out[pre + "attn.out_proj.bias"] = _zeros_like_rows(o, o.shape[0])
            for ours, theirs in (("up_proj", "fc_in"),
                                 ("down_proj", "fc_out")):
                out[pre + f"mlp.{ours}.weight"] = _t(
                    sd[src + f"mlp.{theirs}.weight"])
                out[pre + f"mlp.{ours}.bias"] = _t(
                    sd[src + f"mlp.{theirs}.bias"])
        out["ln_f.weight"] = _t(sd["ln_f.weight"])
        out["ln_f.bias"] = _t(sd["ln_f.bias"])
        # a headless GPTJModel falls back to the embedding (tied)
        out["lm_head.weight"] = _t(sd.get("lm_head.weight", sd["wte.weight"]))
        return out


class MegatronGPTPolicy:
    """Megatron-LM GPT checkpoints: input / post-attention LayerNorms onto
    ln_1 / ln_2 of the sequential-residual block; the fused
    ``query_key_value`` is per-head interleaved [np, 3, hn] in checkpoint
    version >= 1.0 and block-ordered [3, np hn] in version 0, both
    regrouped to q | k | v. Per-mp-rank shard sets go through
    ``checkpoint/state_dict_factory.py`` first."""

    @staticmethod
    def _regroup_qkv(w, num_heads: int, version: float) -> torch.Tensor:
        """[3h(, h)] Megatron row order -> q | k | v row blocks."""
        w = _t(w)
        if version == 0:
            return w                        # already q | k | v blocks
        hn = w.shape[0] // 3 // num_heads
        parts = w.reshape(num_heads, 3, hn, *w.shape[1:])
        return torch.cat([parts[:, j].reshape(num_heads * hn, *w.shape[1:])
                          for j in range(3)], 0)

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int, *,
                num_heads: int, version: float = 2.0
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "model.", "language_model.")
        rq = MegatronGPTPolicy._regroup_qkv
        out = {"wte.weight": _t(sd["word_embeddings.weight"]),
               "wpe": _t(sd["position_embeddings.weight"])}
        names = {"ln_1": "input_layernorm", "ln_2": "post_attention_layernorm",
                 "attn.out_proj": "attention.dense",
                 "mlp.up_proj": "mlp.dense_h_to_4h",
                 "mlp.down_proj": "mlp.dense_4h_to_h"}
        for i in range(n_layer):
            pre, src = f"blocks.{i}.", f"transformer.layers.{i}."
            qkv = src + "attention.query_key_value."
            out[pre + "attn.qkv.weight"] = rq(sd[qkv + "weight"], num_heads,
                                              version)
            out[pre + "attn.qkv.bias"] = rq(sd[qkv + "bias"], num_heads,
                                            version)
            for ours, theirs in names.items():
                out[pre + ours + ".weight"] = _t(sd[src + theirs + ".weight"])
                out[pre + ours + ".bias"] = _t(sd[src + theirs + ".bias"])
        out["ln_f.weight"] = _t(sd["transformer.final_layernorm.weight"])
        out["ln_f.bias"] = _t(sd["transformer.final_layernorm.bias"])
        return out


# the port BertModel's per-layer Linears and norms <- HF BERT's
_BERT_LAYER = {"attn.out_proj": "attention.output.dense",
               "ln_attn": "attention.output.LayerNorm",
               "up_proj": "intermediate.dense",
               "down_proj": "output.dense",
               "ln_ffn": "output.LayerNorm"}
_BERT_QKV = ("query", "key", "value")


def _bert_cfg(**kw) -> BertConfig:
    return BertConfig(hidden_dropout=0.0, dtype=torch.float32,
                      param_dtype=torch.float32, scan_layers=True, **kw)


class HFBertPolicy:
    """BERT: q / k / v Linears fused into qkv; post-LN encoder layers."""

    @staticmethod
    def config_from_hf(hf_config) -> BertConfig:
        return _bert_cfg(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            d_model=hf_config.hidden_size,
            d_ff=hf_config.intermediate_size,
            layer_norm_eps=hf_config.layer_norm_eps)

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "bert.")
        emb = "embeddings."
        out = {"wte.weight": _t(sd[emb + "word_embeddings.weight"]),
               "wpe": _t(sd[emb + "position_embeddings.weight"]),
               "wtt.weight": _t(sd[emb + "token_type_embeddings.weight"]),
               "ln_emb.weight": _t(sd[emb + "LayerNorm.weight"]),
               "ln_emb.bias": _t(sd[emb + "LayerNorm.bias"])}
        for i in range(n_layer):
            pre, src = f"blocks.{i}.", f"encoder.layer.{i}."
            for p in ("weight", "bias"):
                out[pre + "attn.qkv." + p] = torch.cat(
                    [_t(sd[src + f"attention.self.{n}.{p}"])
                     for n in _BERT_QKV], 0)
            for ours, theirs in _BERT_LAYER.items():
                for p in ("weight", "bias"):
                    out[pre + f"{ours}.{p}"] = _t(sd[src + f"{theirs}.{p}"])
        if "pooler.dense.weight" in sd:
            out["pooler.weight"] = _t(sd["pooler.dense.weight"])
            out["pooler.bias"] = _t(sd["pooler.dense.bias"])
        return out

    @staticmethod
    def export(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The port's BertModel ``state_dict`` -> an HF BERT state dict
        (standalone ``BertModel`` keys, no ``bert.`` prefix)."""
        sd = {k: _t(v) for k, v in state_dict.items()}
        emb = "embeddings."
        out = {emb + "word_embeddings.weight": sd["wte.weight"],
               emb + "position_embeddings.weight": sd["wpe"],
               emb + "token_type_embeddings.weight": sd["wtt.weight"],
               emb + "LayerNorm.weight": sd["ln_emb.weight"],
               emb + "LayerNorm.bias": sd["ln_emb.bias"]}
        if "pooler.weight" in sd:
            out["pooler.dense.weight"] = sd["pooler.weight"]
            out["pooler.dense.bias"] = sd["pooler.bias"]
        n_layer = len({k.split(".")[1] for k in sd
                       if k.startswith("blocks.")})
        for i in range(n_layer):
            pre, dst = f"blocks.{i}.", f"encoder.layer.{i}."
            for p in ("weight", "bias"):
                for n, part in zip(_BERT_QKV,
                                   sd[pre + "attn.qkv." + p].chunk(3, 0)):
                    out[dst + f"attention.self.{n}.{p}"] = part
            for ours, theirs in _BERT_LAYER.items():
                for p in ("weight", "bias"):
                    out[dst + f"{theirs}.{p}"] = sd[pre + f"{ours}.{p}"]
        return out


class HFDistilBertPolicy:
    """DistilBERT: a BERT-shaped post-LN encoder without token types or a
    pooler; q / k / v are ``q_lin`` / ``k_lin`` / ``v_lin``."""

    @staticmethod
    def config_from_hf(hf_config) -> BertConfig:
        return _bert_cfg(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.max_position_embeddings,
            type_vocab_size=0,
            use_pooler=False,
            num_layers=hf_config.n_layers,
            num_heads=hf_config.n_heads,
            d_model=hf_config.dim,
            d_ff=hf_config.hidden_dim,
            layer_norm_eps=getattr(hf_config, "layer_norm_eps", 1e-12))

    @staticmethod
    def convert(state_dict: Dict[str, Any], n_layer: int
                ) -> Dict[str, torch.Tensor]:
        sd = _strip(state_dict, "distilbert.")
        emb = "embeddings."
        out = {"wte.weight": _t(sd[emb + "word_embeddings.weight"]),
               "wpe": _t(sd[emb + "position_embeddings.weight"]),
               "ln_emb.weight": _t(sd[emb + "LayerNorm.weight"]),
               "ln_emb.bias": _t(sd[emb + "LayerNorm.bias"])}
        names = {"attn.out_proj": "attention.out_lin",
                 "ln_attn": "sa_layer_norm", "up_proj": "ffn.lin1",
                 "down_proj": "ffn.lin2", "ln_ffn": "output_layer_norm"}
        for i in range(n_layer):
            pre, src = f"blocks.{i}.", f"transformer.layer.{i}."
            for p in ("weight", "bias"):
                out[pre + "attn.qkv." + p] = torch.cat(
                    [_t(sd[src + f"attention.{n}_lin.{p}"]) for n in "qkv"],
                    0)
            for ours, theirs in names.items():
                for p in ("weight", "bias"):
                    out[pre + f"{ours}.{p}"] = _t(sd[src + f"{theirs}.{p}"])
        return out


_POLICIES = {
    "gpt2": HFGPT2Policy,
    "gpt_neo": HFGPTNeoPolicy,
    "gptj": HFGPTJPolicy,
    "bert": HFBertPolicy,
    "distilbert": HFDistilBertPolicy,
    "megatron": MegatronGPTPolicy,
}


def policy_for(model_type: str):
    if model_type not in _POLICIES:
        raise ValueError(f"no injection policy for {model_type!r}; have "
                         f"{sorted(_POLICIES)}")
    return _POLICIES[model_type]


def export_hf_state_dict(model_type: str, state_dict: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Inverse injection: the port's ``state_dict`` back to an HF state
    dict, to hand a trained or tuned model back to the torch ecosystem."""
    pol = policy_for(model_type)
    if not hasattr(pol, "export"):
        raise ValueError(f"no export path for {model_type!r}")
    return pol.export(state_dict)


def load_hf_model(hf_model) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """An HF model (anything with ``.config.model_type`` and
    ``.state_dict()``) -> (the port's config, the port's ``state_dict``)."""
    pol = policy_for(hf_model.config.model_type)
    cfg = pol.config_from_hf(hf_model.config)
    return cfg, pol.convert(dict(hf_model.state_dict()), cfg.num_layers)
