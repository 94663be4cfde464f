"""A model factored into prefix / a trunk of identical blocks / suffix.

Counterpart of ``deepspeed_tpu/runtime/pipe/spmd.py``: ``StackedPipeSpec``,
its tree helpers, ``gpt_pipe_spec`` and ``bert_mlm_pipe_spec``, driven by two
runtimes: the GPipe pipeline (``GPipeSpmdEngine``, below) and the
layer-streamed capacity tier (``runtime/zero/layer_stream.py``).

The TPU trunk is one stacked ``[L, ...]`` leaf per block parameter; here the
blocks are an ``nn.ModuleList`` and the parameters are flat dicts keyed by
the model's own ``named_parameters`` names, so "layer i" is the set of names
under ``f"{blocks_key}.{i}."``. A block runs through
``torch.func.functional_call`` on a template block (any block of the model,
its own storage unused, on the meta device or not) with the layer's
tensors, so one layer's parameters can be fetched into any device buffer and
differentiated there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.func import functional_call
from torch.utils import checkpoint as torch_checkpoint

from ...comm import comm
from ...ops.adam import fused_adam
from ...parallel import mesh as mesh_lib
from ...utils.device import resolve_device
from ...utils.logging import log_dist

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StackedPipeSpec:
    """A model, factored into prefix / identical blocks / suffix.

    prefix(resident, batch) -> (x, aux)   embedding and preamble. ``x`` is
                                          the trunk carry [B, T, D]; ``aux``
                                          the per-block side input (GPT:
                                          positions; BERT: the attention
                                          mask or None). It must not depend
                                          on the parameters: the streamed
                                          backward differentiates the prefix
                                          only through ``x``, so the
                                          streamer detaches it.
    block(block_params, x, aux) -> x      one layer, given that layer's
                                          tensors by their names inside a
                                          block ("attn.qkv.weight", ...)
    suffix_loss(resident, x, batch)       final norm, head and loss
    blocks_key                            the blocks' name prefix
                                          ("blocks", "bert.blocks")
    num_layers                            L
    dtype                                 the trunk's compute dtype (the
                                          carry keeps one dtype)

    ``resident`` is the dict of every parameter outside the blocks, by its
    full name.
    """
    prefix: Callable[[Params, Dict], Any]
    block: Callable[[Params, torch.Tensor, Any], torch.Tensor]
    suffix_loss: Callable[[Params, torch.Tensor, Dict], torch.Tensor]
    blocks_key: str
    num_layers: int
    dtype: Any = None


def tree_get(params: Params, path: str) -> Params:
    """The entries under ``path`` (a dotted name prefix), by their names
    below it."""
    pre = path + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def tree_without(params: Params, path: str) -> Params:
    """``params`` without the entries under ``path``."""
    pre = path + "."
    return {k: v for k, v in params.items() if not k.startswith(pre)}


def tree_with(params: Params, path: str, value: Params) -> Params:
    """``params`` with the entries under ``path`` replaced by ``value``'s
    (named below ``path``)."""
    out = tree_without(params, path)
    out.update({f"{path}.{k}": v for k, v in value.items()})
    return out


def layer_of(name: str, blocks_key: str):
    """(layer index, name inside the block) of a block parameter's full
    name, or None for a parameter outside the blocks."""
    pre = blocks_key + "."
    if not name.startswith(pre):
        return None
    idx, _, rest = name[len(pre):].partition(".")
    return int(idx), rest


def gpt_pipe_spec(model, loss_fn=None) -> StackedPipeSpec:
    """``models/gpt.py``'s GPT as a stacked trunk. The prefix, block and
    suffix are the functions ``GPT.forward`` itself runs
    (``embed_tokens``, ``Block``, ``final_logits``), so a streamed step
    computes what the module computes. Refuses what the TPU adapter refuses
    (``partition_activations``, ``sequence_parallel``, dropout, MoE)."""
    from ...models.gpt import embed_tokens, final_logits, lm_loss_fn
    cfg = model.cfg
    if cfg.partition_activations or cfg.sequence_parallel:
        raise ValueError("tp/sp sharding constraints inside the stacked "
                         "trunk are not supported; disable "
                         "partition_activations/sequence_parallel")
    if cfg.dropout:
        raise ValueError("the stacked trunk runs deterministic; train with "
                         "dropout=0.0 (silently disabling dropout would "
                         "change training semantics)")
    if cfg.moe:
        raise ValueError("MoE blocks return a load-balancing aux loss the "
                         "stacked trunk does not carry; a streamed step "
                         "that dropped it would collapse the router")
    loss_fn = loss_fn or lm_loss_fn
    template = model.blocks[0]

    def prefix(res, batch):
        ids = batch["input_ids"]
        b, s = ids.shape
        positions = torch.arange(s, device=ids.device)[None, :].expand(b, s)
        return embed_tokens(cfg, res["wte.weight"], res.get("wpe"), ids,
                            positions), positions

    def block(p, x, positions):
        return functional_call(template, p, (x, positions),
                               {"attention_impl": cfg.attention_impl})[0]

    def suffix_loss(res, x, batch):
        head = res["wte.weight" if cfg.tie_embeddings else "lm_head.weight"]
        return loss_fn(final_logits(cfg, x, res["ln_f.weight"],
                                    res["ln_f.bias"], head), batch)

    return StackedPipeSpec(prefix=prefix, block=block,
                           suffix_loss=suffix_loss, blocks_key="blocks",
                           num_layers=cfg.num_layers, dtype=cfg.dtype)


def bert_mlm_pipe_spec(model, loss_fn) -> StackedPipeSpec:
    """``models/bert.py``'s BertForMaskedLM as a stacked trunk: the
    embeddings prefix, the ``bert.blocks`` trunk with the attention mask
    (or None) as its side input, the MLM head. Refuses hidden dropout, as
    the TPU adapter does."""
    from ...models.bert import bert_embed, mlm_head
    cfg = model.cfg
    if cfg.hidden_dropout:
        raise ValueError("the stacked trunk runs deterministic; set "
                         "hidden_dropout=0.0 (silently disabling dropout "
                         "would change training semantics)")
    template = model.bert.blocks[0]

    def prefix(res, batch):
        mask = batch.get("attention_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=batch["input_ids"].device
                                   ).bool()
        return bert_embed(cfg, tree_get(res, "bert"), batch["input_ids"],
                          batch.get("token_type_ids")), mask

    def block(p, x, mask):
        return functional_call(template, p, (x, mask, True))

    def suffix_loss(res, x, batch):
        return loss_fn(mlm_head(cfg, res, x), batch)

    return StackedPipeSpec(prefix=prefix, block=block,
                           suffix_loss=suffix_loss, blocks_key="bert.blocks",
                           num_layers=cfg.num_layers, dtype=cfg.dtype)


class GPipeSpmdEngine:
    """GPipe over a (pp, dp) grid of ranks: every rank runs the same tick
    loop over its own stage's blocks (the TPU engine's one SPMD program,
    ``spmd.py:268-517``).

    ``params`` is the plain model's state dict (the blocks under
    ``spec.blocks_key``). Rank (dp d, pp s) holds layers ``s L/S .. (s +
    1) L/S - 1`` (the TPU ``_stage_restack`` sharded over pp) and every
    other parameter whole, as fp32 masters under AdamW (``fused_adam``,
    ``adam_w_mode``); the compute dtype is the model's (its layers cast).
    The ranks join ``torch.distributed`` first; the engine lays them out as
    the mesh ``{"dp": dp, "pp": S}``.

    A step takes M micro-batches (``{"input_ids": [mb, T]}``, every rank
    the same; a rank computes its dp rows):

      * forward: M + S - 1 ticks. At tick t stage 0 takes micro t's prefix
        output (its index clipped to M - 1), every other stage what its
        left neighbour made at tick t - 1 (``comm.ppermute``, cyclic), and
        runs its blocks (each under remat when ``remat``). Stage s holds
        micro t - s; the others are warm-up and drain ticks, whose outputs
        never reach the loss. The last stage's ticks S - 1 .. M + S - 2 are
        the outputs, in micro order (the TPU ``ys[S-1:]``);
      * the suffix (final norm, head, loss) runs once, on the last stage;
        the prefix's grads arise on stage 0 only. The grads of the
        parameters outside the blocks are summed over pp (each part counted
        once) and every grad over dp (then divided by dp);
      * backward: the ticks in reverse, every tick's blocks backpropagated
        with the cotangent its output got: from the loss (the last stage)
        or, one reverse hop (the reverse permutation), from what the next
        stage's input took at tick t + 1;
      * the global grad norm (``get_global_grad_norm``, and
        ``gradient_clipping``'s) counts every stage's blocks once (summed
        over pp) and the other parameters once;
      * the loss (on every rank) is the last stage's, averaged over dp.
    """

    def __init__(self, spec: StackedPipeSpec, params: Dict[str, torch.Tensor],
                 *, num_stages: int, micro_batches: int, dp: int = 1,
                 lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, gradient_clipping: float = 0.0,
                 remat: bool = True, device="cuda"):
        if micro_batches < 1:
            raise ValueError("micro_batches must be >= 1")
        self.spec = spec
        self.num_stages = S = int(num_stages)
        self.micro_batches = int(micro_batches)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay = weight_decay
        self.remat = remat
        self.device = resolve_device(device)
        L = spec.num_layers
        if L % S:
            raise ValueError(
                f"stacked layer count {L} not divisible by pp={S}")
        if comm.get_world_size() != S * dp:
            raise ValueError(f"pp={S} x dp={dp} needs {S * dp} ranks, the "
                             f"world has {comm.get_world_size()}")
        self.mesh = mesh_lib.ensure_global_mesh(mesh_lib.MeshShape(dp=dp,
                                                                   pp=S))
        self.stage = self.mesh.coord("pp")
        self.dp = dp
        self._pp_group = comm.new_group("pp", self.mesh)
        self._dp_group = comm.new_group("dp", self.mesh)
        self._world = comm.new_group(("dp", "pp"), self.mesh)
        self.layers_per_stage = L // S
        lo = self.stage * self.layers_per_stage
        self._dtypes = {k: v.dtype for k, v in params.items()}

        def master(v):
            return torch.as_tensor(v).detach().to(
                self.device, torch.float32).clone().requires_grad_()
        self.rest = {k: master(v) for k, v in
                     tree_without(params, spec.blocks_key).items()}
        every = tree_get(params, spec.blocks_key)
        self.blocks: List[Dict[str, torch.Tensor]] = []
        for i in range(lo, lo + self.layers_per_stage):
            pre = f"{i}."
            self.blocks.append({k[len(pre):]: master(v)
                                for k, v in every.items()
                                if k.startswith(pre)})
        # bytes this rank sent in the tick hops and all-reduced
        self.comm_bytes = {"ppermute": 0, "all_reduce": 0}
        self._clip = float(gradient_clipping)
        self._tx = fused_adam(self._leaves(), learning_rate=lr, betas=betas,
                              eps=eps, weight_decay=weight_decay,
                              adam_w_mode=True)
        self.step_count = 0
        log_dist(f"GPipe pipeline: {L} layers over {S} stages x dp={dp}, "
                 f"M={self.micro_batches}, bubble="
                 f"{(S - 1) / (self.micro_batches + S - 1):.2f}", ranks=[0])

    def _leaves(self) -> List[torch.Tensor]:
        """This rank's masters: its blocks', then the rest, in order."""
        return [t for blk in self.blocks for t in blk.values()] + \
            list(self.rest.values())

    # ------------------------------------------------------------ trunk
    def _stage_fwd(self, x, aux):
        block = self.spec.block
        for p in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = torch_checkpoint.checkpoint(
                    lambda h, p=p: block(p, h, aux), x, use_reentrant=False)
            else:
                x = block(p, x, aux)
        return x

    def _hop(self, y, reverse: bool = False):
        S = self.num_stages
        if S == 1:
            return torch.zeros_like(y)
        perm = [((i + 1) % S, i) if reverse else (i, (i + 1) % S)
                for i in range(S)]
        self.comm_bytes["ppermute"] += y.numel() * y.element_size()
        return comm.ppermute(y.contiguous(), perm, group=self._pp_group)

    def _local_ids(self, ids3) -> torch.Tensor:
        ids3 = torch.as_tensor(np.asarray(ids3) if not isinstance(
            ids3, torch.Tensor) else ids3).long()
        n = ids3.shape[1] // self.dp
        r = self.mesh.coord("dp")
        return ids3[:, r * n:(r + 1) * n].to(self.device)

    def _forward(self, ids3, train: bool):
        """The tick loop. Returns (the loss on the last stage, else None;
        what the backward needs)."""
        S, M, s = self.num_stages, self.micro_batches, self.stage
        ids3 = self._local_ids(ids3)
        _, b, T = ids3.shape
        ids = ids3.reshape(M * b, T)
        batch = {"input_ids": ids}
        with torch.set_grad_enabled(train and s == 0):
            x, aux = self.spec.prefix(self.rest, batch)
        xs = x.reshape((M, b) + tuple(x.shape[1:]))
        aux3 = aux.reshape((M, b) + tuple(aux.shape[1:])) \
            if aux is not None else None
        xs_in = xs.detach()
        ticks = []
        y = torch.zeros_like(xs_in[0])
        with torch.set_grad_enabled(train):
            for t in range(M + S - 1):
                x_in = self._hop(y)
                idx = min(max(t - s, 0), M - 1)
                x_st = (xs_in[idx] if s == 0 else x_in).detach()
                if train:
                    x_st.requires_grad_()
                y_t = self._stage_fwd(x_st, None if aux3 is None
                                      else aux3[idx])
                ticks.append((idx, x_st, y_t))
                y = y_t.detach()
        loss, outs = None, None
        if s == S - 1:
            outs = [y_t.detach().requires_grad_(train)
                    for _, _, y_t in ticks[S - 1:]]
            h = torch.stack(outs).reshape((M * b,) + tuple(y.shape[1:]))
            with torch.set_grad_enabled(train):
                loss = self.spec.suffix_loss(self.rest, h, batch).float()
        return loss, (xs, ticks, outs)

    def _backward(self, loss, saved) -> None:
        S, M, s = self.num_stages, self.micro_batches, self.stage
        xs, ticks, outs = saved
        cots = [None] * len(ticks)
        if loss is not None:
            loss.backward()
            for k, o in enumerate(outs):
                cots[S - 1 + k] = o.grad
        dxs = torch.zeros_like(xs) if s == 0 else None
        dx = torch.zeros_like(ticks[0][2])
        for t in reversed(range(M + S - 1)):
            got = self._hop(dx, reverse=True)
            idx, x_st, y_t = ticks[t]
            g = cots[t] if s == S - 1 else got
            if g is None:
                g = torch.zeros_like(y_t)
            torch.autograd.backward(y_t, g)
            dx = x_st.grad if x_st.grad is not None \
                else torch.zeros_like(x_st)
            if s == 0:
                dxs[idx] += dx
                dx = torch.zeros_like(dx)
            ticks[t] = None
        if s == 0:
            xs.backward(dxs)

    @torch.no_grad()
    def _reduce_and_step(self) -> None:
        blocks = [t for blk in self.blocks for t in blk.values()]
        rest = list(self.rest.values())
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in blocks + rest]
        for t in blocks + rest:
            t.grad = None
        nb = len(blocks)
        # blocks over dp; the rest's prefix / suffix parts over pp and dp
        for group, part in ((self._dp_group, grads[:nb]),
                            (self._world, grads[nb:])):
            if part and group.size > 1:
                flat = comm.all_reduce(torch.cat(
                    [g.reshape(-1) for g in part]), group=group)
                self.comm_bytes["all_reduce"] += \
                    flat.numel() * flat.element_size()
                torch._foreach_copy_(part, [
                    f.view_as(g) for f, g in
                    zip(flat.split([g.numel() for g in part]), part)])
        if self.dp > 1:
            torch._foreach_div_(grads, float(self.dp))
        sq = torch.stack([g.float().square().sum() for g in grads[:nb]]
                         ).sum()
        comm.all_reduce(sq, group=self._pp_group)
        sq = sq + sum(g.float().square().sum() for g in grads[nb:])
        self._last_grad_norm = gn = sq.sqrt()
        if self._clip > 0:
            factor = self._clip / torch.clamp(gn, min=self._clip)
            torch._foreach_mul_(grads, factor)
        self._tx.step(grads)

    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's global grad norm (before clipping), or None."""
        norm = getattr(self, "_last_grad_norm", None)
        return None if norm is None else float(norm)

    # -------------------------------------------------------------- API
    def train_batch(self, data_iter: Iterator[Any]) -> torch.Tensor:
        """Consume ``micro_batches`` micro-batches and run one pipelined
        optimizer step. Returns the loss (every rank)."""
        mbs = [next(data_iter) for _ in range(self.micro_batches)]
        ids3 = torch.stack([torch.as_tensor(np.asarray(b["input_ids"]))
                            for b in mbs])
        loss, saved = self._forward(ids3, train=True)
        self._backward(loss, saved)
        del saved
        self._reduce_and_step()
        self.step_count += 1
        return self._shared_loss(loss)

    def _shared_loss(self, loss) -> torch.Tensor:
        S = self.num_stages
        out = (loss.detach().clone() if loss is not None else
               torch.zeros((), dtype=torch.float32, device=self.device))
        if self.stage == S - 1 and self.dp > 1:
            comm.all_reduce(out, "avg", group=self._dp_group)
        if S > 1:
            comm.broadcast(out, S - 1, group=self._pp_group)
        return out

    @torch.no_grad()
    def eval_loss(self, ids3) -> torch.Tensor:
        """Pipelined forward + loss only (no update); ids3 [M, mb, T]."""
        return self._shared_loss(self._forward(ids3, train=False)[0])

    @torch.no_grad()
    def params_tree(self) -> Dict[str, torch.Tensor]:
        """Current weights as the plain model's state dict (every rank; the
        blocks gathered over pp), in the caller's original dtypes."""
        out = dict(self.rest)
        key, n = self.spec.blocks_key, self.layers_per_stage
        for j, blk in enumerate(self.blocks):
            for name, t in blk.items():
                every = comm.all_gather(t.contiguous(), group=self._pp_group)
                for s in range(self.num_stages):
                    out[f"{key}.{s * n + j}.{name}"] = every[s]
        return {k: v.detach().to(self._dtypes[k]) for k, v in out.items()}

    # ------------------------------------------------------ checkpointing
    def _ckpt_arrays(self) -> Dict[str, np.ndarray]:
        names = [f"{self.spec.blocks_key}."
                 f"{self.stage * self.layers_per_stage + j}.{n}"
                 for j, blk in enumerate(self.blocks) for n in blk] + \
            list(self.rest)
        out = {"count": np.asarray(self._tx.count)}
        for kind, tensors in (("master", self._leaves()),
                              ("mu", self._tx.mu), ("nu", self._tx.nu)):
            for n, t in zip(names, tensors):
                out[f"{kind}/{n}"] = t.detach().cpu().numpy()
        return out

    def save_checkpoint(self, save_dir: str, tag: str = "pipe") -> str:
        """Each stage's rank at dp 0 writes ``save_dir/tag/
        spmd_pipe_stage{s}.npz`` (its blocks, the rest, their moments and
        the step count); rank 0 writes ``latest``."""
        path = os.path.join(save_dir, tag)
        if self.mesh.coord("dp") == 0:
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, f"spmd_pipe_stage{self.stage}.npz"),
                     **self._ckpt_arrays())
        comm.barrier()
        if comm.get_rank() == 0:
            with open(os.path.join(save_dir, "latest"), "w") as fh:
                fh.write(tag)
            with open(os.path.join(path, "spmd_pipe_meta.json"), "w") as fh:
                json.dump({"num_stages": self.num_stages}, fh)
        comm.barrier()
        return path

    @torch.no_grad()
    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        """Restore this rank's stage (any dp; the same pp)."""
        if tag is None:
            p = os.path.join(load_dir, "latest")
            if not os.path.exists(p):
                raise FileNotFoundError(f"no 'latest' file in {load_dir}")
            with open(p) as fh:
                tag = fh.read().strip()
        path = os.path.join(load_dir, tag)
        with open(os.path.join(path, "spmd_pipe_meta.json")) as fh:
            stages = json.load(fh)["num_stages"]
        if stages != self.num_stages:
            raise ValueError(f"checkpoint of pp={stages}, engine pp="
                             f"{self.num_stages}")
        mine = self._ckpt_arrays()
        with np.load(os.path.join(
                path, f"spmd_pipe_stage{self.stage}.npz")) as f:
            saved = {k: f[k] for k in mine}
        self._tx.count = int(saved["count"])
        names = [k[len("master/"):] for k in mine if k.startswith("master/")]
        for kind, tensors in (("master", self._leaves()),
                              ("mu", self._tx.mu), ("nu", self._tx.nu)):
            for n, t in zip(names, tensors):
                t.copy_(torch.from_numpy(saved[f"{kind}/{n}"]))
        self.step_count = self._tx.count
        return tag
