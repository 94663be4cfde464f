"""TPU-package GPT and BERT weights -> the port's ``state_dict``.

``jax_params_to_state_dict`` takes the flax ``params`` tree of
``deepspeed_tpu.models.gpt.GPT`` with every leaf already a numpy array (the
caller converts; this module imports no JAX) and returns a ``state_dict``
for ``deepspeed_tpu_torch.models.gpt.GPT`` with the same config:

  * ``blocks`` leaves stacked ``[L, ...]`` (``scan_layers=True``) are split
    per layer; ``block_{i}`` subtrees (``scan_layers=False``) map directly;
  * a Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``; the
    fused ``qkv`` kernel keeps its q|k|v order along the output dim, which
    the port splits the same way;
  * LayerNorm ``scale`` becomes ``weight``; ``wte.embedding`` becomes
    ``wte.weight``; ``wpe`` stays; a tied head has no ``lm_head``;
  * an MoE block's ``moe`` subtree (``cfg.moe``): the gate's
    ``moe/gate/wg/kernel`` [M, E] becomes ``moe.deepspeed_moe.gate.wg.weight``
    [E, M]; the expert bank ``moe/Experts_0/experts/inner/{up,down}_proj``
    (kernels [E, in, out], stacked over the experts, [L, E, ...] when the
    blocks are) becomes ``moe.deepspeed_moe.experts.{up,down}_proj``
    (weights [E, out, in]); a residual MoE's ``moe/mlp/inner`` and
    ``moe/coefficient`` Denses become ``moe.mlp`` and ``moe.coefficient``.

``jax_params_to_tp_state_dict`` gives tp rank r's ``state_dict`` of the
same tree: each leaf that ``runtime.sharding.tp_split`` splits becomes the
rank's shard (a fused ``qkv``'s heads of each third), the rest stays whole;
it loads into a model split by ``models.gpt.set_tensor_parallel``.

``jax_params_to_state_dict`` serves every ``attention_impl`` ("sparse"
adds no parameter). ``bert_params_to_state_dict`` maps the trees of
``deepspeed_tpu.models.bert.BertModel`` and ``BertForMaskedLM`` the same
way onto ``deepspeed_tpu_torch.models.bert``, and
``transformer_layer_params_to_state_dict`` the tree of one
``deepspeed_tpu.ops.transformer.DeepSpeedTransformerLayer`` onto the port's
layer of the same name, and ``tiled_params_to_state_dict`` one
``TiledDense`` onto ``runtime.zero.tiling.TiledLinear`` (its ``kernel``
[p·q, in/p, out/q] keeps its layout).

Any tree with the params' structure maps the same way: a JAX gradient tree
(``jax.grad`` of the loss) or an Adam moment tree (``AdamState.mu`` /
``.nu``) becomes a name -> tensor dict that lines up with the port model's
``named_parameters()``; the training parity tests compare grads and moments
through it.

``pipe_params_to_state_dict`` maps the TPU ``PipelineEngine``'s
``stage_params`` (a list a stage of per-layer trees: the
``models.gpt_pipe`` layers, or modules of flax Dense / LayerNorm / Embed
children) to the port ``PipelineEngine``'s state dict (``"{layer}.{name}"``,
every tied replica), and ``state_dict_to_pipe_params`` back.

``gpt_flax_leaves`` runs the map the other way, element by element: for
each port parameter name it gives the flax leaf it came from (its path,
its shape, the layer of a stacked leaf, whether the port transposed its
last two dims) and maps the port's flat element indices to that leaf's.
The counter-based shard fill of ``runtime/zero/partition_params.py`` is
defined over the flax leaf's elements, and generates a port slice through
it. ``state_dict_to_jax_params`` builds the TPU GPT's params tree (numpy
leaves, stacked or per layer) from a port ``state_dict`` through it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.bert import BertConfig
from .models.gpt import GPTConfig


def _dense(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _norm(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _moe(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    _dense(f"{prefix}.deepspeed_moe.gate.wg", tree["gate"]["wg"], out)
    bank = tree["Experts_0"]["experts"]["inner"]
    for name in ("up_proj", "down_proj"):
        pre = f"{prefix}.deepspeed_moe.experts.{name}"
        out[f"{pre}.weight"] = np.swapaxes(np.asarray(bank[name]["kernel"]),
                                           -1, -2)
        out[f"{pre}.bias"] = np.asarray(bank[name]["bias"])
    if "mlp" in tree:
        for name in ("up_proj", "down_proj"):
            _dense(f"{prefix}.mlp.{name}", tree["mlp"]["inner"][name], out)
        _dense(f"{prefix}.coefficient", tree["coefficient"], out)


def _block(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    _norm(f"{prefix}.ln_1", tree["ln_1"], out)
    _norm(f"{prefix}.ln_2", tree["ln_2"], out)
    _dense(f"{prefix}.attn.qkv", tree["attn"]["qkv"], out)
    _dense(f"{prefix}.attn.out_proj", tree["attn"]["out_proj"], out)
    if "moe" in tree:
        _moe(f"{prefix}.moe", tree["moe"], out)
        return
    _dense(f"{prefix}.mlp.up_proj", tree["mlp"]["up_proj"], out)
    _dense(f"{prefix}.mlp.down_proj", tree["mlp"]["down_proj"], out)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def jax_params_to_state_dict(params_np: Mapping[str, Any],
                             cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, Any] = {"wte.weight": np.asarray(
        params_np["wte"]["embedding"])}
    if not cfg.rotary:
        out["wpe"] = np.asarray(params_np["wpe"])
    for i in range(cfg.num_layers):
        if "blocks" in params_np:
            blk = _layer(params_np["blocks"], i)
        else:
            blk = params_np[f"block_{i}"]
        _block(f"blocks.{i}", blk, out)
    _norm("ln_f", params_np["ln_f"], out)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = np.asarray(
            params_np["lm_head"]["kernel"]).T
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def jax_params_to_tp_state_dict(params_np: Mapping[str, Any],
                                cfg: GPTConfig, tp: int,
                                rank: int) -> Dict[str, torch.Tensor]:
    """Tp rank ``rank``'s ``state_dict`` of the TPU GPT ``params_np`` at
    ``tp`` ranks (:func:`jax_params_to_state_dict`, then each split leaf's
    shard)."""
    from .runtime.sharding import tp_split
    out = {}
    for name, t in jax_params_to_state_dict(params_np, cfg).items():
        split = tp_split(name, t.shape, tp)
        out[name] = t if split is None else \
            split.take(t, rank).contiguous()
    return out


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """The flax leaf one port parameter comes from: ``path`` ("/"-joined,
    as the JAX package names leaves), the leaf's ``shape`` (``[L, ...]``
    when the blocks are stacked), the ``layer`` of a stacked leaf the
    parameter is (None otherwise), and whether the port stores it
    ``transposed`` (a Dense ``kernel [..., in, out]`` as ``weight [...,
    out, in]``: the last two dims swapped, an expert bank's expert dim
    kept)."""
    path: str
    shape: Tuple[int, ...]
    layer: Optional[int] = None
    transposed: bool = False

    def jax_index(self, index: np.ndarray) -> np.ndarray:
        """Flat indices into the port parameter -> flat indices into the
        flax leaf (int64)."""
        idx = np.asarray(index, np.int64)
        inner = self.shape[1:] if self.layer is not None else self.shape
        if self.transposed:                       # the last two dims
            n_in, n_out = inner[-2:]
            lead, rest = np.divmod(idx, n_in * n_out)
            o, i = np.divmod(rest, n_in)          # port [..., out, in]
            idx = lead * (n_in * n_out) + i * n_out + o   # flax [.., in, out]
        if self.layer is not None:
            idx = idx + self.layer * math.prod(inner)
        return idx


def gpt_flax_leaves(cfg: GPTConfig, scan_layers: bool = True
                    ) -> Dict[str, FlaxLeaf]:
    """Port parameter name -> :class:`FlaxLeaf` of the TPU package's GPT
    with the same config (blocks stacked under ``scan_layers``, as the TPU
    GPT builds them by default), in ``named_parameters()`` order."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    out = {}
    if not cfg.rotary:
        out["wpe"] = FlaxLeaf("wpe", (cfg.max_seq_len, D))
    out["wte.weight"] = FlaxLeaf("wte/embedding", (V, D))

    def leaf(i, sub, shape, transposed=False):
        if scan_layers:
            return FlaxLeaf(f"blocks/{sub}", (L, *shape), i, transposed)
        return FlaxLeaf(f"block_{i}/{sub}", shape, None, transposed)
    # port name -> (flax path, in, out, leading expert dims, has a bias)
    dense = {"attn.qkv": ("attn/qkv", D, 3 * D, (), True),
             "attn.out_proj": ("attn/out_proj", D, D, (), True)}
    if not cfg.moe:
        dense.update({"mlp.up_proj": ("mlp/up_proj", D, F, (), True),
                      "mlp.down_proj": ("mlp/down_proj", F, D, (), True)})
    else:
        E = (cfg.num_experts,)
        bank = "moe/Experts_0/experts/inner"
        dense.update({
            "moe.deepspeed_moe.gate.wg": ("moe/gate/wg", D, E[0], (), False),
            "moe.deepspeed_moe.experts.up_proj": (f"{bank}/up_proj", D, F, E,
                                                  True),
            "moe.deepspeed_moe.experts.down_proj": (f"{bank}/down_proj", F, D,
                                                    E, True)})
        if cfg.moe_use_residual:
            dense.update({
                "moe.mlp.up_proj": ("moe/mlp/inner/up_proj", D, F, (), True),
                "moe.mlp.down_proj": ("moe/mlp/inner/down_proj", F, D, (),
                                      True),
                "moe.coefficient": ("moe/coefficient", D, 2, (), True)})
    for i in range(L):
        pre = f"blocks.{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{pre}.{ln}.weight"] = leaf(i, f"{ln}/scale", (D,))
            out[f"{pre}.{ln}.bias"] = leaf(i, f"{ln}/bias", (D,))
        for name, (sub, n_in, n_out, lead, bias) in dense.items():
            out[f"{pre}.{name}.weight"] = leaf(i, f"{sub}/kernel",
                                               lead + (n_in, n_out), True)
            if bias:
                out[f"{pre}.{name}.bias"] = leaf(i, f"{sub}/bias",
                                                 lead + (n_out,))
    out["ln_f.weight"] = FlaxLeaf("ln_f/scale", (D,))
    out["ln_f.bias"] = FlaxLeaf("ln_f/bias", (D,))
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = FlaxLeaf("lm_head/kernel", (D, V), None, True)
    return out


def state_dict_to_jax_params(state_dict: Mapping[str, Any], cfg: GPTConfig,
                             scan_layers: bool = True) -> Dict[str, Any]:
    """A port GPT ``state_dict`` -> the TPU GPT's params tree (nested dicts
    of numpy arrays; blocks stacked ``[L, ...]`` under ``scan_layers``,
    ``block_{i}`` subtrees otherwise): the inverse of
    :func:`jax_params_to_state_dict`."""
    leaves = gpt_flax_leaves(cfg, scan_layers)
    arrays: Dict[str, np.ndarray] = {}
    for name, fl in leaves.items():
        v = state_dict[name]
        v = np.asarray(v.detach().cpu().float() if torch.is_tensor(v) else v,
                       np.float32)
        if fl.transposed:
            v = np.swapaxes(v, -1, -2)
        if fl.layer is None:
            arrays[fl.path] = v
        else:
            if fl.path not in arrays:
                arrays[fl.path] = np.empty(fl.shape, np.float32)
            arrays[fl.path][fl.layer] = v
    tree: Dict[str, Any] = {}
    for path, v in arrays.items():
        node = tree
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.ascontiguousarray(v)
    return tree


def _bert_layer(prefix: str, tree: Mapping[str, Any],
                out: Dict[str, Any]) -> None:
    _dense(f"{prefix}.attn.qkv", tree["attn"]["qkv"], out)
    _dense(f"{prefix}.attn.out_proj", tree["attn"]["out_proj"], out)
    _norm(f"{prefix}.ln_attn", tree["ln_attn"], out)
    _dense(f"{prefix}.up_proj", tree["up_proj"], out)
    _dense(f"{prefix}.down_proj", tree["down_proj"], out)
    _norm(f"{prefix}.ln_ffn", tree["ln_ffn"], out)


def _bert_encoder(prefix: str, tree: Mapping[str, Any], cfg: BertConfig,
                  out: Dict[str, Any]) -> None:
    out[f"{prefix}wte.weight"] = np.asarray(tree["wte"]["embedding"])
    out[f"{prefix}wpe"] = np.asarray(tree["wpe"])
    if cfg.type_vocab_size:
        out[f"{prefix}wtt.weight"] = np.asarray(tree["wtt"]["embedding"])
    _norm(f"{prefix}ln_emb", tree["ln_emb"], out)
    for i in range(cfg.num_layers):
        blk = (_layer(tree["blocks"], i) if "blocks" in tree
               else tree[f"block_{i}"])
        _bert_layer(f"{prefix}blocks.{i}", blk, out)
    if cfg.use_pooler:
        _dense(f"{prefix}pooler", tree["pooler"], out)


def bert_params_to_state_dict(params_np: Mapping[str, Any],
                              cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """A ``BertModel`` or ``BertForMaskedLM`` params tree (numpy leaves,
    ``blocks`` stacked or ``block_{i}``) -> the port model's state_dict."""
    out: Dict[str, Any] = {}
    if "bert" in params_np:                      # BertForMaskedLM
        _bert_encoder("bert.", params_np["bert"], cfg, out)
        _dense("transform", params_np["transform"], out)
        _norm("ln_head", params_np["ln_head"], out)
        _dense("decoder", params_np["decoder"], out)
    else:
        _bert_encoder("", params_np, cfg, out)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def transformer_layer_params_to_state_dict(
        params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ``DeepSpeedTransformerLayer`` params tree (numpy leaves:
    ``attn_ln``/``out_ln`` ``{scale, bias}``, ``attn_qkv``/``attn_out``/
    ``inter``/``output`` ``{kernel, bias}``) -> the port layer's
    state_dict."""
    out: Dict[str, Any] = {}
    for name in ("attn_ln", "out_ln"):
        _norm(name, params_np[name], out)
    for name in ("attn_qkv", "attn_out", "inter", "output"):
        _dense(name, params_np[name], out)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def tiled_params_to_state_dict(
        params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One ``TiledDense`` params tree (``kernel`` [p·q, in/p, out/q], and
    ``bias`` [out] when it has one) -> ``TiledLinear``'s state_dict: the
    tiles keep their layout and order."""
    out = {"kernel": np.asarray(params_np["kernel"])}
    if "bias" in params_np:
        out["bias"] = np.asarray(params_np["bias"])
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def _pipe_layer_params(kind: str, tree: Mapping[str, Any],
                       out: Dict[str, Any]) -> None:
    """One TPU pipeline layer's params tree -> the port layer's names."""
    if kind == "PipeGPTEmbed":
        out["wte.weight"] = np.asarray(tree["wte"]["embedding"])
        out["wpe"] = np.asarray(tree["wpe"])
    elif kind == "PipeGPTBlock":
        sub: Dict[str, Any] = {}
        _block("b", tree, sub)
        out.update({k[2:]: v for k, v in sub.items()})
    elif kind == "PipeGPTFinalNorm":
        _norm("ln_f", tree["ln_f"], out)
    elif kind == "PipeGPTLMHead":
        out["lm_head.weight"] = np.asarray(tree["lm_head"]["kernel"]).T
    else:                          # Dense / LayerNorm / Embed modules
        for name, v in tree.items():
            if not isinstance(v, Mapping):
                out[name] = np.asarray(v)
            elif "kernel" in v:
                _dense(name, v, out)
            elif "scale" in v:
                _norm(name, v, out)
            elif "embedding" in v:
                out[f"{name}.weight"] = np.asarray(v["embedding"])
            else:
                sub = {}
                _pipe_layer_params("", v, sub)
                out.update({f"{name}.{k}": s for k, s in sub.items()})


def pipe_params_to_state_dict(stage_params, module
                              ) -> Dict[str, torch.Tensor]:
    """The TPU ``PipelineEngine.stage_params`` (numpy leaves: a list a
    stage of per-layer params trees, None for a layer without any) ->
    the port ``PipelineEngine``'s state dict (``"{layer}.{name}"``, every
    tied replica; ``model_parameters`` takes it). ``module`` is the
    port's ``PipelineModule`` with the same layer list and parts: its
    layer classes name each tree's kind (the ``models.gpt_pipe`` layers,
    or modules of Dense / LayerNorm / Embed children named as in flax)."""
    out: Dict[str, Any] = {}
    for s, layers in enumerate(stage_params):
        for j, tree in enumerate(layers):
            if tree is None:
                continue
            idx = module.parts[s] + j
            sub: Dict[str, Any] = {}
            _pipe_layer_params(module.layer_specs[idx].typename.__name__,
                               tree, sub)
            out.update({f"{idx}.{k}": v for k, v in sub.items()})
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def _nest(arrays: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in arrays.items():
        node = tree
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.ascontiguousarray(v)
    return tree


def state_dict_to_pipe_params(state_dict: Mapping[str, Any], module
                              ) -> list:
    """The inverse of :func:`pipe_params_to_state_dict`: a port pipeline
    state dict -> the TPU engine's ``stage_params`` layout (numpy)."""
    def arr(v):
        return np.asarray(v.detach().cpu().float() if torch.is_tensor(v)
                          else v, np.float32)
    stages = []
    for s in range(module.num_stages):
        layers = []
        for idx in range(module.parts[s], module.parts[s + 1]):
            spec = module.layer_specs[idx]
            kind = spec.typename.__name__
            pre = f"{idx}."
            mine = {k[len(pre):]: arr(v) for k, v in state_dict.items()
                    if k.startswith(pre)}
            if not mine:
                layers.append(None)
                continue
            flat: Dict[str, np.ndarray] = {}
            if kind == "PipeGPTEmbed":
                flat = {"wte/embedding": mine["wte.weight"],
                        "wpe": mine["wpe"]}
            elif kind == "PipeGPTBlock":
                cfg = dataclasses.replace(spec.module_args[0], num_layers=1,
                                          scan_layers=False,
                                          attn_windows=None)
                for name, fl in gpt_flax_leaves(cfg, False).items():
                    if name.startswith("blocks.0."):
                        v = mine[name[len("blocks.0."):]]
                        flat[fl.path[len("block_0/"):]] = (
                            np.swapaxes(v, -1, -2) if fl.transposed else v)
            else:
                for name, v in mine.items():
                    mod, _, leaf = name.rpartition(".")
                    mod = mod.replace(".", "/")
                    if leaf == "weight" and v.ndim == 2 and \
                            mod.split("/")[-1] in ("wte", "embedding"):
                        flat[f"{mod}/embedding"] = v
                    elif leaf == "weight" and v.ndim >= 2:
                        flat[f"{mod}/kernel"] = np.swapaxes(v, -1, -2)
                    elif leaf == "weight":
                        flat[f"{mod}/scale"] = v
                    else:
                        flat[f"{mod}/{leaf}" if mod else leaf] = v
            layers.append(_nest(flat))
        stages.append(layers)
    return stages
