"""Rank functions of the pipeline tests (``tests/test_torch_pipe*.py``).

Each runs inside a ``torch_dist_helpers.run_ranks`` process (gloo, one
torch thread, no JAX): ``run_ranks("torch_pipe_helpers:cases", n,
calls={name: (function, kwargs)})`` runs every call in order in one start of
the ranks and returns each rank's ``{name: result}``.
"""

import numpy as np
import torch


def _tensors(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def _batches(micros):
    """A fresh iterator over the step's micro-batches ``(ids, ids)``."""
    return iter([(m, m) for m in micros])


def pipe_module(cfg_kw, num_stages, partition_method="uniform"):
    from deepspeed_tpu_torch.models.gpt import GPTConfig
    from deepspeed_tpu_torch.models.gpt_pipe import gpt_pipe_module
    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.pop("dtype", "float32"))
    return gpt_pipe_module(GPTConfig(**kw), num_stages=num_stages,
                           partition_method=partition_method)


def pipe_engine(cfg_kw, num_stages, config, state=None):
    import deepspeed_tpu_torch as dst
    engine, *_ = dst.initialize(
        model=pipe_module(cfg_kw, num_stages), config=config,
        model_parameters=None if state is None else _tensors(state),
        device="cpu")
    return engine


def _numpy(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def pipe_train(rank, world, cfg_kw, num_stages, config, micros, steps,
               state=None, save_dir=None, resume_steps=0):
    """The 1F1B engine trained ``steps`` steps on ``micros`` (every step
    the same M micro-batches). Returns the losses (every rank), the skipped
    steps, the local stages' final masters and, with ``save_dir``, the
    losses of ``resume_steps`` more steps run on, and of a fresh engine
    that loaded the checkpoint saved after ``steps``."""
    engine = pipe_engine(cfg_kw, num_stages, config, state)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(_batches(micros))))
        norms.append(engine.get_global_grad_norm())
    out = {"losses": losses, "norms": norms,
           "skipped": engine.skipped_steps,
           "stage": engine.stage_id, "local": engine.local_stages,
           "dp": engine.dp_world_size, "ep": engine.ep_world_size}
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag="t")
    out["master"] = _numpy(engine.state_dict())
    out["eval"] = float(engine.eval_batch((micros[0], micros[0])))
    if save_dir is not None:
        out["cont"] = [float(engine.train_batch(_batches(micros)))
                       for _ in range(resume_steps)]
        fresh = pipe_engine(cfg_kw, num_stages, config, None)
        tag, _ = fresh.load_checkpoint(save_dir)
        out["resumed_tag"] = tag
        out["resumed_steps"] = fresh.global_steps
        out["resumed"] = [float(fresh.train_batch(_batches(micros)))
                          for _ in range(resume_steps)]
    return out


def pipe_refusals(rank, world, cfg_kw, num_stages, config, meshes):
    """What ``initialize`` does with each mesh of ``meshes`` (its
    exception's type and message, or "built")."""
    out = {}
    for name, mesh in meshes.items():
        try:
            pipe_engine(cfg_kw, num_stages, dict(config, mesh=mesh))
            out[name] = "built"
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def gpipe_train(rank, world, cfg_kw, state, micros, steps, num_stages, dp,
                lr=1e-3, clip=0.0, remat=False, save_dir=None,
                resume_steps=0):
    """``GPipeSpmdEngine`` over the plain GPT state dict ``state``: losses,
    the eval loss of the first step's batch and the final weights
    (``params_tree``); with ``save_dir`` the continued and the resumed
    losses."""
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.runtime.pipe import (GPipeSpmdEngine,
                                                  gpt_pipe_spec)
    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.pop("dtype", "float32"))
    model = GPT(GPTConfig(**kw), device="meta")

    def build():
        return GPipeSpmdEngine(gpt_pipe_spec(model), _tensors(state),
                               num_stages=num_stages,
                               micro_batches=len(micros), dp=dp, lr=lr,
                               gradient_clipping=clip, remat=remat,
                               device="cpu")
    engine = build()

    def batches():
        return iter([{"input_ids": m} for m in micros])
    ids3 = np.stack(micros)
    out = {"eval0": float(engine.eval_loss(ids3)), "losses": [],
           "norms": []}
    for _ in range(steps):
        out["losses"].append(float(engine.train_batch(batches())))
        out["norms"].append(engine.get_global_grad_norm())
    out["params"] = _numpy(engine.params_tree())
    out["blocks"] = len(engine.blocks)
    if save_dir is not None:
        engine.save_checkpoint(save_dir)
        out["cont"] = [float(engine.train_batch(batches()))
                       for _ in range(resume_steps)]
        fresh = build()
        fresh.load_checkpoint(save_dir)
        out["resumed_step"] = fresh.step_count
        out["resumed"] = [float(fresh.train_batch(batches()))
                          for _ in range(resume_steps)]
    return out


def cases(rank, world, calls):
    """Every ``(function, kwargs)`` of ``calls`` in order."""
    return {name: globals()[fn](rank, world, **kw)
            for name, (fn, kw) in calls.items()}
