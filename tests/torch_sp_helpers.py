"""Rank functions of the sequence-parallel CPU tests
(tests/test_torch_sequence_parallel.py, tests/test_torch_ring_attention.py),
run by ``torch_dist_helpers.run_ranks``. They import only torch, numpy and
the port. Each rank builds the mesh ``{"sp": sp}`` over the world (dp fills
the rest) and takes its chunk of the whole tensors it is given; results come
back as numpy, by case name."""

import numpy as np

import torch_dist_helpers as helpers
from torch_tp_helpers import _gpt, _reset_mesh
from torch_tp_helpers import train  # noqa: F401  (a case of ``cases``)


def _sp_group(world, sp):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    _reset_mesh()
    mesh_lib.ensure_global_mesh(mesh_lib.MeshShape.infer(world, sp=sp))
    return comm.new_group("sp")


def _chunk(x, group):
    """This rank's chunk of the sequence (dim 1) of a whole numpy array, as
    a tensor (a float one takes grads)."""
    import torch
    s = x.shape[1] // group.size
    r = group.rank
    t = torch.from_numpy(np.ascontiguousarray(x[:, r * s:(r + 1) * s]))
    return t.requires_grad_() if t.is_floating_point() else t


def ring(rank, world, q, k, v, dout, causal):
    """``ops.ring_attention.ring_attention`` over sp = world: this rank's
    output chunk, its q / k / v grads under ``sum(out * dout)`` and the
    hops it made."""
    from deepspeed_tpu_torch.ops.ring_attention import (SP_TRAFFIC,
                                                        ring_attention)
    group = _sp_group(world, world)
    qc, kc, vc = (_chunk(t, group) for t in (q, k, v))
    SP_TRAFFIC.clear()
    out = ring_attention(qc, kc, vc, group, causal=causal)
    (out * _chunk(dout, group).detach()).sum().backward()
    return {"out": out.detach().numpy(), "dq": qc.grad.numpy(),
            "dk": kc.grad.numpy(), "dv": vc.grad.numpy(),
            "traffic": dict(SP_TRAFFIC)}


def exchange(rank, world, x, w):
    """The Ulysses exchanges over sp = world on this rank's chunk of ``x``
    [B, S, H, d]: ``seq_to_heads`` of it (and of it stacked with 2x, the
    model's q/k/v call), ``heads_to_seq`` of that, and the grad of
    ``sum(seq_to_heads(x) * w_heads)`` (``w`` [B, S, H, d] whole)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import heads_to_seq, seq_to_heads
    group = _sp_group(world, world)
    xc = _chunk(x, group)
    heads = seq_to_heads(xc, group)
    stacked = seq_to_heads(torch.stack([xc, 2 * xc]), group)
    back = heads_to_seq(heads, group)
    hl = x.shape[2] // group.size
    wh = torch.from_numpy(np.ascontiguousarray(
        w[:, :, group.rank * hl:(group.rank + 1) * hl]))
    (heads * wh).sum().backward()
    return {"heads": heads.detach().numpy(),
            "stacked": stacked.detach().numpy(),
            "back": back.detach().numpy(), "grad": xc.grad.numpy()}


def odd_heads(rank, world, q, k, v, dout):
    """``ulysses_attention`` over sp = world where sp does not divide the
    heads: this rank's output rows and q / k / v grads (plain causal
    attention, the masked einsum), and the warning it logged."""
    import logging
    from deepspeed_tpu_torch.models.gpt import (causal_attention,
                                                ulysses_attention)
    from deepspeed_tpu_torch.utils.logging import logger
    group = _sp_group(world, world)
    qc, kc, vc = (_chunk(t, group) for t in (q, k, v))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    try:
        out = ulysses_attention(qc, kc, vc, group, lambda a, b, c:
                                causal_attention(a, b, c, dtype=a.dtype,
                                                 impl="xla"))
    finally:
        logger.removeHandler(handler)
    (out * _chunk(dout, group).detach()).sum().backward()
    return {"out": out.detach().numpy(), "dq": qc.grad.numpy(),
            "dk": kc.grad.numpy(), "dv": vc.grad.numpy(), "warnings": seen}


def prefill(rank, world, state, model, ids):
    """``GPT.prefill`` of this rank's chunk of ``ids`` over sp = world
    (hidden, keys, values), and the decode step over the sp group, which
    raises (its text)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import set_sequence_parallel
    group = _sp_group(world, world)
    m = set_sequence_parallel(_gpt(state, **model), group)
    with torch.inference_mode():
        hidden, ks, vs = m.prefill(_chunk(ids, group).long())
    cache = torch.zeros(m.cfg.num_layers, ids.shape[0], m.cfg.max_seq_len,
                        m.cfg.d_model)
    try:
        m.decode(torch.zeros(ids.shape[0], 1, dtype=torch.long),
                 torch.zeros(ids.shape[0], 1, dtype=torch.long), cache,
                 cache.clone(), torch.zeros(ids.shape[0], dtype=torch.long))
        refused = None
    except NotImplementedError as exc:
        refused = str(exc)
    return {"hidden": hidden.numpy(), "k": ks.numpy(), "v": vs.numpy(),
            "decode": refused}


def refusals(rank, world, state, model, configs):
    """``initialize`` at each config in ``configs`` (name -> (model config
    overrides, engine config)): None, or the error's type and text; and
    ``set_tensor_parallel`` of a model split over sp."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt import (set_sequence_parallel,
                                                set_tensor_parallel)
    out = {}
    for name, (overrides, config) in configs.items():
        _reset_mesh()
        try:
            helpers.port_engine(_gpt(state, **dict(model, **overrides)),
                                config)
            out[name] = None
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    group = _sp_group(world, world)
    m = set_sequence_parallel(_gpt(state, **model), group)
    try:
        set_tensor_parallel(m, comm.CommGroup(axes=("tp",),
                                              ranks=tuple(range(world))))
        out["split_tp"] = None
    except NotImplementedError as exc:
        out["split_tp"] = f"{type(exc).__name__}: {exc}"
    return out


def cases(rank, world, calls):
    """Several of this module's rank functions in one start of the ranks:
    ``calls`` maps a name to (function name, keyword arguments)."""
    return {name: globals()[fn](rank, world, **kw)
            for name, (fn, kw) in calls.items()}
