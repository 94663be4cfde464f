"""Rank functions of the tensor-parallel CPU tests (tests/test_torch_tp.py,
tests/test_torch_tp_serving.py), run by ``torch_dist_helpers.run_ranks``.
They import only torch, numpy and the port. Each takes several cases in
one start of the ranks and returns numpy results by case name."""

import numpy as np

import torch_dist_helpers as helpers


def _reset_mesh():
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.reset_global_mesh()


def _gpt(state, **cfg):
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(dtype=torch.float32, param_dtype=torch.float32,
                          **cfg))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _int8_buffers(module):
    from deepspeed_tpu_torch.ops.quantizer import Int8Linear
    return {f"{n}.{b}": getattr(m, b).numpy().copy()
            for n, m in module.named_modules() if isinstance(m, Int8Linear)
            for b in ("q8", "scale")}


def inference(rank, world, models, ids, bert=None):
    """For each GPT in ``models`` (name -> (config, state)):
    ``InferenceEngine(mp_size=world)`` logits and greedy tokens, the same
    from the rank's shard state dict (``jax_params_to_tp_state_dict`` of
    the numpy tree, given as ``tp_states``) into a model split alike, and
    under ``quantize_bits=8`` the logits and every int8 shard. ``bert``:
    (config, state, ids, types, mask) through ``replace_method="auto"``
    with int8 weights."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt import set_tensor_parallel
    out = {}
    for name, (cfg, state, tp_states) in models.items():
        _reset_mesh()
        ie = InferenceEngine(_gpt(state, **cfg), mp_size=world,
                             dtype=torch.float32, device="cpu")
        res = {"logits": ie.forward(ids).numpy(),
               "tokens": ie.generate(ids, max_new_tokens=6,
                                     temperature=0.0).numpy(),
               "heads": ie.module.blocks[0].attn.local_heads,
               "shapes": {k: tuple(v.shape)
                          for k, v in ie.module.state_dict().items()}}
        split = _gpt(state, **cfg)
        set_tensor_parallel(split, comm.new_group("tp"))
        split.load_state_dict({k: torch.from_numpy(v) for k, v in
                               tp_states[rank].items()})
        with torch.inference_mode():
            res["shard_logits"] = split(torch.from_numpy(ids).long()).numpy()
        _reset_mesh()
        q = InferenceEngine(_gpt(state, **cfg), mp_size=world,
                            dtype=torch.float32, quantize_bits=8,
                            device="cpu")
        res["int8_logits"] = q.forward(ids).numpy()
        res["int8"] = _int8_buffers(q.module)
        out[name] = res
    if bert is not None:
        from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
        cfg, state, bids, types, mask = bert
        model = BertModel(BertConfig(dtype=torch.float32, **cfg))
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        _reset_mesh()
        ie = InferenceEngine(model, mp_size=world, dtype=torch.float32,
                             quantize_bits=8, replace_method="auto",
                             device="cpu")
        seq, pooled = ie.forward(bids, token_type_ids=types,
                                 attention_mask=mask)
        out["bert"] = {"seq": seq.numpy(), "pooled": pooled.numpy(),
                       "int8": _int8_buffers(ie.module),
                       "kinds": {n: m.tp.kind for n, m in
                                 ie.module.named_modules()
                                 if getattr(m, "tp", None) is not None}}
    return out


def overlap_and_ring(rank, world, cfg, state, prompts):
    """Greedy tokens of ``ServingEngine(tp=world)`` over a parallel-residual
    GPT with ``tp_overlap`` off and on (dense and paged), and
    ``ring_allreduce`` against ``all_reduce`` with its row guard."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import tp_overlap
    out = {}
    for overlap in (False, True):
        _reset_mesh()
        ie = InferenceEngine(_gpt(state, tp_overlap=overlap, **cfg),
                             mp_size=world, dtype=torch.float32,
                             device="cpu")
        for paged in (False, True):
            eng = ServingEngine(engine=ie, max_batch=2, decode_chunk=4,
                                megakernel=True, paged=paged, tp=world)
            out[(overlap, paged)] = [
                r.output_ids.tolist()
                for r in eng.run([p.copy() for p in prompts],
                                 max_new_tokens=6)]
    group = comm.new_group("tp")
    x = torch.from_numpy(np.random.default_rng(rank).normal(
        size=(4 * world, 3)).astype(np.float32))
    out["ring"] = tp_overlap.ring_allreduce(x, group).numpy()
    out["all_reduce"] = comm.all_reduce(x.clone(), group=group).numpy()
    try:
        tp_overlap.ring_allreduce(x[:world + 1], group)
        out["guard"] = None
    except ValueError as exc:
        out["guard"] = str(exc)
    y = torch.from_numpy(np.random.default_rng(10 + rank).normal(
        size=(2, 3, 8)).astype(np.float32))
    out["deferred"] = tp_overlap.defer_attn_allreduce(y, group).wait().numpy()
    out["summed"] = comm.all_reduce(y.clone(), group=group).numpy()
    return out


def _saved(engine, batch):
    """The (shape, bytes) of every tensor the autograd graph of one
    forward saves outside a non-reentrant checkpoint (the pack hook sees
    a partitioned checkpoint's rows), and the forward's loss."""
    import torch
    held = []

    def pack(t):
        held.append((tuple(t.shape), t.numel() * t.element_size()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = engine._micro_forward(batch)
    return held, loss


def train(rank, world, cases):
    """Several training runs at this rank (``helpers.zero_ranks`` over a
    GPT config given as ``model``); a run with ``saved`` also measures the
    bytes its first forward's graph keeps; one with ``save_dir`` saves
    after its steps, one with ``load_dir`` loads first; ``refuse``: the
    ``initialize`` error text instead."""
    import torch
    out = {}
    for name, kw in cases.items():
        _reset_mesh()
        kw = dict(kw)
        cfg = kw.pop("model")
        if kw.pop("refuse", False):
            try:
                helpers.port_engine(_gpt(kw["state"], **cfg), kw["config"])
                out[name] = None
            except (NotImplementedError, ValueError) as exc:
                out[name] = f"{type(exc).__name__}: {exc}"
            continue
        engine = helpers.port_engine(_gpt(kw["state"], **cfg), kw["config"])
        res = {}
        if kw.get("load_dir"):
            engine.load_checkpoint(kw["load_dir"])
        micros = kw["micros"]
        if kw.get("saved"):
            res["saved"], loss = _saved(engine, micros[0])
            res["first_loss"] = float(loss)
        gas = engine.gradient_accumulation_steps()
        res["losses"], res["norms"] = helpers.train(engine, micros,
                                                    kw["steps"], gas)
        res["master"], res["opt"] = helpers.engine_state(engine)
        res["dp"], res["tp"] = engine.dp_world_size, engine.mp_world_size
        res["held"] = {n: tuple(p.shape)
                       for n, p in engine.module.named_parameters()}
        if kw.get("save_dir"):
            engine.save_checkpoint(kw["save_dir"])
            more = micros[kw["steps"] * gas:]
            res["after_save"], _ = helpers.train(engine, more, 2, gas)
        out[name] = res
    torch.set_grad_enabled(True)
    return out


def serving(rank, world, cfg, state, prompts, n_new, int8_prompts=None):
    """``ServingEngine(tp=world)`` greedy tokens over the dense and paged
    arenas (and int8 weights), and a mismatched engine's refusal."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    out = {}
    for paged in (False, True):
        _reset_mesh()
        eng = ServingEngine(_gpt(state, **cfg), dtype=torch.float32,
                            device="cpu", max_batch=2, decode_chunk=4,
                            megakernel=True, paged=paged, tp=world)
        out["paged" if paged else "dense"] = [
            r.output_ids.tolist()
            for r in eng.run([p.copy() for p in prompts],
                             max_new_tokens=n_new)]
        out["arena_width"] = int(eng.kv.cache_k.shape[-1])
    _reset_mesh()
    ie = InferenceEngine(_gpt(state, **cfg), mp_size=world,
                         dtype=torch.float32, quantize_bits=8, device="cpu")
    eng = ServingEngine(engine=ie, max_batch=2, decode_chunk=4,
                        megakernel=True, tp=world)
    out["int8"] = [r.output_ids.tolist()
                   for r in eng.run([p.copy() for p in int8_prompts],
                                    max_new_tokens=n_new)]
    out["int8_generate"] = [
        ie.generate(p[None], max_new_tokens=n_new, temperature=0.0)[0]
        .tolist() for p in int8_prompts]
    try:
        ServingEngine(engine=ie, tp=2 * world)
        out["mismatch"] = None
    except ValueError as exc:
        out["mismatch"] = str(exc)
    return out


def cases(rank, world, calls):
    """Several of this module's rank functions in one start of the ranks:
    ``calls`` maps a name to (function name, keyword arguments)."""
    return {name: globals()[fn](rank, world, **kw)
            for name, (fn, kw) in calls.items()}
