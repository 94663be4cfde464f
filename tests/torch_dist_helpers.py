"""Multi-rank runs of the PyTorch port for its CPU tests.

``run_ranks("module:function", world, **kwargs)`` starts ``world`` fresh
Python processes (no JAX, no conftest), each of which joins a gloo group
on a free localhost port through ``deepspeed_tpu_torch.comm`` and calls
``function(rank, world, **kwargs)``; it returns the ranks' return values in
rank order. Arguments and results travel as pickles. A rank that fails, or
a run that outlives ``timeout``, fails the calling test (every process is
killed), so a hung rank cannot stall the suite.

The rank functions the port's tests use live here too: they import only
torch, numpy and the port.
"""

import collections
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# the port's tiny GPT (torch_port_helpers.TINY; restated: no JAX here)
TINY = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=128, d_ff=512)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, timeout: float = 240.0, **kwargs):
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "args.pkl"), "wb") as fh:
            pickle.dump(kwargs, fh)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, str(rank),
             str(world), str(port), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        outs = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                left = max(deadline - time.monotonic(), 0.1)
                outs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{target} at {world} ranks outlived "
                                 f"{timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(r, p.returncode, o) for r, (p, o)
               in enumerate(zip(procs, outs)) if p.returncode != 0]
        assert not bad, "\n".join(f"rank {r} exited {rc}:\n{o[-4000:]}"
                                  for r, rc, o in bad)
        results = []
        for rank in range(world):
            with open(os.path.join(d, f"out{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _child(target, rank, world, port, d):
    import torch
    torch.set_num_threads(1)
    import importlib
    from deepspeed_tpu_torch import comm
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{port}",
                          rank=rank, world_size=world, device="cpu")
    with open(os.path.join(d, "args.pkl"), "rb") as fh:
        kwargs = pickle.load(fh)
    module, name = target.split(":")
    result = getattr(importlib.import_module(module), name)(
        rank, world, **kwargs)
    with open(os.path.join(d, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# The comm façade
# --------------------------------------------------------------------------

def collectives(rank, world, inputs):
    """Each collective of ``comm`` on this rank's row of the stacked
    ``inputs``; returns this rank's results (stack them over the ranks to
    get the TPU package's stacked view)."""
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import coalesced_collectives as cc
    mine = {k: torch.from_numpy(v[rank].copy()) for k, v in inputs.items()}
    x = mine["x"]
    out = {"rank": comm.get_rank(), "world": comm.get_world_size(),
           "group": comm.get_data_parallel_group().size,
           "devices": comm.device_count()}
    for op in ("sum", "avg", "max", "min"):
        out[f"all_reduce_{op}"] = comm.all_reduce(x.clone(), op).numpy()
    out["all_gather"] = comm.all_gather(x).numpy()
    out["all_gather_base"] = comm.all_gather_base(mine["chunk"]).numpy()
    out["allgather_fn"] = comm.allgather_fn(mine["chunk"]).numpy()
    for op in ("sum", "avg"):
        out[f"reduce_scatter_base_{op}"] = comm.reduce_scatter_base(
            mine["flat"], op).numpy()
    out["reduce_scatter_fn"] = comm.reduce_scatter_fn(mine["flat"]).numpy()
    out["all_to_all_single"] = comm.all_to_all_single(mine["a2a"]).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), src=1).numpy()
    out["send"] = comm.send(x, dst=1, src=0).numpy()
    out["recv"] = comm.recv(x, src=world - 1).numpy()
    ring = [(r, (r + 1) % world) for r in range(world)]
    out["ppermute"] = comm.ppermute(x, ring).numpy()
    parts = [mine[k] for k in ("p0", "p1", "p2")]
    out["reduce_scatter_coalesced"] = [
        t.numpy() for t in cc.reduce_scatter_coalesced(parts)]
    out["reduce_scatter_single"] = [
        comm.reduce_scatter_base(torch.nn.functional.pad(
            t.reshape(-1), (0, -(-t.numel() // world) * world - t.numel())))
        .numpy() for t in parts]
    slices = [mine[k] for k in ("s0", "s1")]
    out["all_gather_coalesced"] = [
        t.numpy() for t in cc.all_gather_coalesced(slices)]
    out["all_gather_single"] = [comm.all_gather_base(t).numpy()
                                for t in slices]
    comm.barrier()
    return out


# --------------------------------------------------------------------------
# Engines and runs shared by the tests (in the test process or in a rank)
# --------------------------------------------------------------------------

def ids(seed, rows, seq=32, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def port_model(state=None, seed=0, dtype="float32", **overrides):
    """The port's tiny GPT: ``state`` (numpy state dict) or random weights
    from ``seed``; ``dtype`` is the compute dtype."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(dtype=getattr(torch, dtype), param_dtype=torch.float32,
                    **{"remat": False, **TINY, **overrides})
    model = GPT(cfg)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model


def port_engine(model, config):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=config, device="cpu")
    return engine


def train(engine, micros, steps, gas):
    """``steps`` train_batch calls over consecutive ``gas``-long slices of
    ``micros``; returns (losses, grad norms) as Python floats."""
    losses, norms = [], []
    for step in range(steps):
        batch = micros[gas * step:gas * (step + 1)]
        losses.append(float(engine.train_batch(iter(batch))))
        norms.append(engine.get_global_grad_norm())
    return losses, norms


def engine_state(engine):
    """The engine's whole state as numpy: fp32 masters by name and the
    optimizer's ``count`` and moments by ``<moment>/<name>`` (gathered over
    dp: every rank calls it)."""
    master = engine.consolidated_fp32_state_dict()
    sd = engine.optimizer_state_dict()
    opt = {"count": sd["count"]}
    for m in engine.optimizer.STATE:
        for name, t in zip(engine._names, sd[m]):
            opt[f"{m}/{name}"] = t.detach().float().numpy().copy()
    return master, opt


def close_masters(got, want, lr=1e-3, rtol=1e-4):
    """fp32 masters after a few Adam-family steps on two summation orders:
    within ``rtol`` and ``rtol`` × the largest magnitude for all but 1% of
    the elements, within ``lr`` for every one (Adam moves an element whose
    gradient is f32 summation noise by up to lr a step, either way)."""
    scale = max(np.abs(v).max() for v in want.values())
    loose = total = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=lr,
                                   err_msg=name)
        loose += int((np.abs(got[name] - w) > rtol * (
            scale + np.abs(w))).sum())
        total += w.size
    assert loose <= 0.01 * total, (loose, total)


def train_ranks(rank, world, state, config, micros, steps, dtype="float32"):
    """One run of ``steps`` train_batch calls at this rank; returns losses,
    grad norms, the gathered state and this rank's moment sizes."""
    engine = port_engine(port_model(state, dtype=dtype), config)
    reduces = []                         # LAMB's norm all-reduces
    reduce = getattr(engine.optimizer, "norm_reduce", None)
    if reduce is not None:
        engine.optimizer.norm_reduce = lambda t: (
            reduces.append(tuple(t.shape)), reduce(t))[1]
    gas = engine.gradient_accumulation_steps()
    losses, norms = train(engine, micros, steps, gas)
    master, opt = engine_state(engine)
    sd = engine.optimizer.state_dict()
    held = {m: [int(t.numel()) for t in sd[m]] for m in engine.optimizer.STATE}
    return {"losses": losses, "norms": norms, "master": master, "opt": opt,
            "held": held, "dp": engine.dp_world_size,
            "samples": engine.global_samples, "norm_reduces": reduces}


def held_numels(engine):
    """Per leaf, the elements this rank holds on its device: of the fp32
    grad accumulator (``acc``) and of the compute parameter (``params``:
    a stage-3 unit's slice, or the whole leaf)."""
    held = {i: p.numel() for i, p in engine._dense_params}
    for unit in engine._units:
        for i, _, spec in unit.entries:
            held[i] = spec.numel
    return {"acc": [int(a.numel()) for a in engine.acc],
            "params": [int(held[i]) for i in range(len(engine._names))]}


def zero_ranks(rank, world, config, micros, steps, state=None, remat=False,
               dtype="float32", abstract=False, seed=0):
    """One run of ``steps`` train_batch calls at any ZeRO stage, offload
    or not; returns losses, grad norms, the gathered state, what this rank
    holds (device and host) and its collective bytes. ``abstract``: the
    model is built on the meta device (offload only)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.runtime.zero.partition_params import \
        abstract_init
    if abstract:
        model = abstract_init(GPT, GPTConfig(
            dtype=getattr(torch, dtype), param_dtype=torch.float32,
            remat=remat, **TINY))
    else:
        model = port_model(state, seed=seed, dtype=dtype, remat=remat)
    engine = port_engine(model, config)
    losses, norms = train(engine, micros, steps,
                          engine.gradient_accumulation_steps())
    master, opt = engine_state(engine)
    out = {"losses": losses, "norms": norms, "master": master, "opt": opt,
           "dp": engine.dp_world_size, "comm": dict(engine.comm_bytes),
           **held_numels(engine)}
    if engine.offload_enabled:
        host = engine.host_optimizer
        out["host"] = [leaf.numel for leaf in host.leaves]
        out["host_bytes"] = host.host_bytes()
        out["aio_opens"] = sum((h.opens for h in host.handles()),
                               collections.Counter())
        out["device_bytes"] = engine.device_state_bytes()
        host.close()
    return out


def zero_cases(rank, world, cases):
    """Several :func:`zero_ranks` runs in one start of the ranks."""
    return {name: zero_ranks(rank, world, **kw) for name, kw in cases.items()}


def train_cases(rank, world, cases):
    """Several :func:`train_ranks` runs in one start of the ranks."""
    return {name: train_ranks(rank, world, **kw) for name, kw in cases.items()}


def resume_ranks(rank, world, config, micros, save_dir, dtype="float32",
                 seed=0, load_dir=None):
    """The resume gate at this rank: train 2 steps, save to ``save_dir``,
    train 2 more; then a fresh engine loads and trains the same 2. With
    ``load_dir``, only the second half: a fresh engine loads that
    checkpoint and trains 2 steps."""
    gas = config["gradient_accumulation_steps"]
    out = {}
    if load_dir is None:
        engine = port_engine(port_model(seed=seed, dtype=dtype), config)
        out["first"], _ = train(engine, micros, 2, gas)
        engine.save_checkpoint(save_dir, tag="two")
        out["saved"] = engine_state(engine)
        out["cont"], _ = train(engine, micros[2 * gas:], 2, gas)
        load_dir = save_dir
    fresh = port_engine(port_model(seed=seed + 1, dtype=dtype), config)
    fresh.load_checkpoint(load_dir)
    out["loaded"] = engine_state(fresh)
    out["resumed"], _ = train(fresh, micros[2 * gas:], 2, gas)
    out["steps"] = fresh.global_steps
    return out


def initialize_ranks(rank, world, config, rows):
    """``initialize(dist_init_required=True)`` at this rank and one
    ``train_batch`` of ``rows`` global rows: (dp world size, loss)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    engine, *_ = dst.initialize(model=port_model(), loss_fn=lm_loss_fn,
                                config=config, dist_init_required=True,
                                device="cpu")
    loss = engine.train_batch(iter([{"input_ids": ids(0, rows)}]))
    return engine.dp_world_size, float(loss)


def resume_cases(rank, world, cases, tag_config=None):
    """Several :func:`resume_ranks` runs in one start of the ranks; with
    ``tag_config``, also whether saving under a different tag on each
    rank raises under ``checkpoint_tag_validation: fail`` (on every rank)
    and passes under ``warn``."""
    out = {name: resume_ranks(rank, world, **kw)
           for name, kw in cases.items()}
    if tag_config is not None:
        for mode in ("fail", "warn"):
            engine = port_engine(port_model(), dict(
                tag_config, checkpoint_tag_validation=mode))
            try:
                engine._validate_checkpoint_tag(f"tag{rank}")
                out[f"tags_{mode}"] = "passed"
            except ValueError as e:
                out[f"tags_{mode}"] = str(e)
    return out




def gather_lifetimes(rank, world, config, micros, remats):
    """:func:`gather_lifetime` under each of ``remats``."""
    return {remat: gather_lifetime(config, micros, remat)
            for remat in remats}


def gather_lifetime(config, micros, remat):
    """Stage 3 at this rank: after each block's forward in the first
    micro-step, how many blocks' gathered weights are still referenced by
    anything but this probe (the use count of the storage under every
    parameter a unit's gather hands its block)."""
    import torch
    from deepspeed_tpu_torch.runtime.zero.stage3 import GatheredModule
    engine = port_engine(port_model(remat=remat), config)
    blocks = [m for m in engine.compute_module.modules()
              if isinstance(m, GatheredModule) and hasattr(m.inner, "attn")]
    storages = {id(m.unit): [] for m in blocks}

    def watch(unit):
        gathered = unit.gathered

        def traced():
            out = gathered()
            storages[id(unit)].append(
                [t.untyped_storage() for t in out.values()])
            return out
        unit.gathered = traced

    def held(st):
        return torch._C._storage_Use_Count(st._cdata) > 1

    for m in blocks:
        watch(m.unit)
    live = []

    def count(*_):
        if len(live) < len(blocks):
            live.append(sum(any(held(st) for st in sts)
                            for per in storages.values() for sts in per))
    hooks = [m.register_forward_hook(count) for m in blocks]
    train(engine, micros, 1, engine.gradient_accumulation_steps())
    for h in hooks:
        h.remove()
    return {"live": live, "blocks": len(blocks),
            "gathers": sum(len(per) for per in storages.values())}


def _live_storages():
    """data_ptr -> bytes of every CPU tensor storage the garbage collector
    can reach."""
    import gc
    import torch
    gc.collect()
    out = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
            st = obj.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


def built_bytes(rank, world, configs, dtype="bfloat16"):
    """Per config: the bytes of the tensors that building an engine
    (``dtype`` compute) on the tiny GPT left alive at this rank."""
    out = {}
    for name, config in configs.items():
        before = _live_storages()
        engine = port_engine(port_model(dtype=dtype), config)
        out[name] = sum(n for ptr, n in _live_storages().items()
                        if ptr not in before)
        del engine
    return out


# --------------------------------------------------------------------------
# The layer-streamed tier
# --------------------------------------------------------------------------

def streamed_init(rank, world, config):
    """``initialize`` with ``offload_param.layer_streaming`` at this rank;
    returns the exception's type name and message (None if it built)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    import torch
    model = GPT(GPTConfig(dtype=torch.float32, **TINY))
    try:
        dst.initialize(model=model, loss_fn=lm_loss_fn, config=config,
                       device="cpu")
    except Exception as exc:           # the caller checks which one
        return type(exc).__name__, str(exc)
    return None


# --------------------------------------------------------------------------
# The device mesh
# --------------------------------------------------------------------------

def mesh_groups(rank, world, shape, x):
    """This rank's coordinates and groups on the mesh of ``shape`` and the
    results of collectives over its dp, ep and tp groups on its row of
    ``x``; the rows the data loader gives it of a 4-row batch."""
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    mesh = mesh_lib.ensure_global_mesh(mesh_lib.MeshShape(**shape))
    mine = torch.from_numpy(x[rank].copy())
    out = {"coords": mesh.coords()}
    for name, axes in (("dp", "dp"), ("ep", "ep"), ("tp", "tp"),
                       ("dpep", ("dp", "ep"))):
        g = comm.new_group(axes)
        members = [g.global_rank(i) for i in range(g.size)]
        out[f"{name}_members"] = members
        if name == "dpep":
            continue
        out[f"{name}_sum"] = comm.all_reduce(mine.clone(), group=g).numpy()
        if g.size > 1:
            out[f"{name}_gather"] = comm.all_gather_base(mine,
                                                         group=g).numpy()
            out[f"{name}_bcast"] = comm.broadcast(mine.clone(), src=1,
                                                  group=g).numpy()
            ring = [(i, (i + 1) % g.size) for i in range(g.size)]
            out[f"{name}_ring"] = comm.ppermute(mine, ring, group=g).numpy()
    loader = DeepSpeedDataLoader(list(range(4)), batch_size=4)
    out["loader"] = [int(v) for v in next(iter(loader))]
    comm.barrier()
    return out


# --------------------------------------------------------------------------
# Mixture-of-Experts over the mesh's ep axis
# --------------------------------------------------------------------------

def expert_bytes(module):
    """Bytes of the expert banks' parameters ``module`` holds."""
    from deepspeed_tpu_torch.moe.utils import split_params_into_shared_and_expert
    _, expert = split_params_into_shared_and_expert(module)
    return sum(p.numel() * p.element_size() for p in expert.values())


def moe_train(rank, world, config, micros, steps, model, state=None,
              save_dir=None, load_dir=None):
    """One MoE run at this rank: optionally load ``load_dir``, train
    ``steps`` steps, optionally save to ``save_dir``; returns losses, grad
    norms, the gathered state (whole leaves), the mesh degrees and the
    expert bytes this rank holds."""
    engine = port_engine(port_model(state, **model), config)
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    losses, norms = train(engine, micros, steps,
                          engine.gradient_accumulation_steps())
    master, opt = engine_state(engine)
    if save_dir is not None:
        engine.save_checkpoint(save_dir)
    return {"losses": losses, "norms": norms, "master": master, "opt": opt,
            "dp": engine.dp_world_size, "ep": engine.ep_world_size,
            "expert_bytes": expert_bytes(engine.module)}


def moe_train_cases(rank, world, cases):
    """Several :func:`moe_train` runs in one start of the ranks, in
    order."""
    return {name: moe_train(rank, world, **kw) for name, kw in cases.items()}


def moe_inference(rank, world, state, model, prompts, max_new, ep_sizes):
    """At each of ``ep_sizes``: an ``InferenceEngine(ep_size=...)`` over
    the MoE model ``state``: its forward logits on ``prompts``, its greedy
    tokens, the expert bytes this rank holds and (ep > 1) what building a
    ``ServingEngine`` over it does."""
    from deepspeed_tpu_torch import InferenceEngine
    out = {}
    for ep in ep_sizes:
        eng = InferenceEngine(port_model(state, **model), ep_size=ep,
                              dtype=getattr(__import__("torch"),
                                            model.get("dtype", "float32")),
                              device="cpu")
        out[ep] = {"logits": eng.forward(prompts).float().numpy(),
                   "tokens": eng.generate(prompts, max_new_tokens=max_new,
                                          temperature=0.0).numpy(),
                   "expert_bytes": expert_bytes(eng.module)}
        if ep > 1:
            from deepspeed_tpu_torch import ServingEngine
            try:
                ServingEngine(engine=eng)
                out[ep]["serving"] = "built"
            except NotImplementedError as exc:
                out[ep]["serving"] = f"NotImplementedError: {exc}"
    return out


def moe_refusals(rank, world, state, model):
    """What ``initialize`` does at mesh ep 2 with what the port does not
    take there (ZeRO-3, the offload tiers) and with an ep that does not
    divide the experts: the exception's type and message, or "built"."""
    out = {}
    base = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    cases = {
        "zero3": {"mesh": {"ep": 2}, "zero_optimization": {"stage": 3}},
        "offload": {"mesh": {"ep": 2}, "zero_optimization": {
            "stage": 1, "offload_optimizer": {"device": "cpu"}}},
        "ep_not_dividing": {"mesh": {"ep": 2}},
    }
    for name, extra in cases.items():
        overrides = dict(model, num_experts=3) \
            if name == "ep_not_dividing" else model
        try:
            port_engine(port_model(None if name == "ep_not_dividing"
                                   else state, **overrides),
                        dict(base, **extra))
            out[name] = "built"
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def moe_two_ranks(rank, world, inference, refusals):
    """:func:`moe_inference` then :func:`moe_refusals` in one start of the
    ranks."""
    return {"inference": moe_inference(rank, world, **inference),
            "refusals": moe_refusals(rank, world, **refusals)}


def tiled_zero3(rank, world, state, x, w, splits, lr, gather_tiles):
    """One SGD step of ZeRO-3 over a one-layer ``TiledLinear`` model (the
    loss: the sum of its output weighted by ``w``), the rank's rows of the
    global batch ``x``. Returns the loss, the whole fp32 weights after the
    step, and the kernel's tile gathers (count, bytes, most alive at once,
    in the forward and over the step)."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear
    from torch import nn
    d_in, d_out = state["layer.kernel"].shape[1] * splits[0], \
        state["layer.bias"].shape[0]

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = TiledLinear(d_in, d_out, *splits)
            self.layer.gather_tiles = gather_tiles

        def forward(self, inputs):
            return self.layer(inputs)

    model = Model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    wt = torch.from_numpy(w)
    n = x.shape[0] // world

    def loss_fn(out, batch):
        return (out * wt[rank * n:(rank + 1) * n]).sum()
    engine, *_ = dst.initialize(
        model=model, loss_fn=loss_fn, device="cpu", config={
            "train_micro_batch_size_per_gpu": n,
            "gradient_accumulation_steps": 1,
            "zero_optimization": {"stage": 3,
                                  "stage3_param_persistence_threshold": 0},
            "optimizer": {"type": "SGD", "params": {"lr": lr}}})
    tiles = engine.compute_module.inner.layer.zero3_tiles
    out = {"tiled": tiles is not None}
    if tiles is not None:
        engine.compute_module(torch.from_numpy(x[rank * n:(rank + 1) * n]))
        out["forward"] = (tiles.gathers, tiles.gather_bytes, tiles.max_live)
        tiles.gathers = tiles.gather_bytes = tiles.max_live = 0
    loss = engine.train_batch(iter([{"input_ids": x}]))
    if tiles is not None:
        out["step"] = (tiles.gathers, tiles.gather_bytes, tiles.max_live)
    out["loss"] = float(loss)
    out["state"] = engine.consolidated_fp32_state_dict()
    out["comm_bytes"] = dict(engine.comm_bytes)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    _child(a[0], int(a[1]), int(a[2]), int(a[3]), a[4])
