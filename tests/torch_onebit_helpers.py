"""Rank functions of the port's compressed-communication and 1-bit
optimizer tests (tests/test_torch_compressed.py, tests/test_torch_onebit.py).

They run in ``torch_dist_helpers.run_ranks`` processes (gloo ranks on the
CPU) and import only torch, numpy and the port;
``run_ranks("torch_onebit_helpers:cases", world, calls={name: (function,
kwargs)})`` runs several in one start of the ranks.
"""

import collections

import torch_dist_helpers as helpers


def _np(t):
    return t.detach().cpu().numpy().copy()


def cases(rank, world, calls):
    """Several of this module's rank functions in one start of the ranks:
    ``calls`` maps a name to (function name, keyword arguments)."""
    return {name: globals()[fn](rank, world, **kw)
            for name, (fn, kw) in calls.items()}


# --------------------------------------------------------------------------
# comm/compressed.py
# --------------------------------------------------------------------------

def compressed_chain(rank, world, bufs):
    """``compressed_allreduce`` of this rank's row of each ``bufs[c]``
    (``[calls, world, n]``) in a row, carrying the error buffers. Per
    call: the phase-1 sign bytes (of buf + worker error), the result, the
    new error buffers, the server's sign bytes (those of the result) and
    the bytes this rank moved."""
    import torch
    from deepspeed_tpu_torch.comm import compressed as cp
    n = bufs.shape[-1]
    we = torch.zeros(n)
    se = torch.zeros(n // world)
    out = []
    for buf in bufs:
        b = torch.from_numpy(buf[rank].copy())
        signs = cp.pack_signs((b + we) >= 0)
        before = collections.Counter(cp.WIRE)
        res, we, se = cp.compressed_allreduce(b, we, se)
        out.append({"signs": _np(signs), "result": _np(res),
                    "worker_error": _np(we), "server_error": _np(se),
                    "server_signs": _np(cp.pack_signs(res >= 0)),
                    "wire": dict(cp.WIRE - before)})
    return out


def error_feedback(rank, world, buf, calls):
    """The compressed backend (unpadded n) called ``calls`` times on this
    rank's constant row of ``buf``: the running mean of its results."""
    import torch
    from deepspeed_tpu_torch.comm.compressed import CompressedBackend
    backend = CompressedBackend()
    we_shape, se_shape = backend.error_shapes(buf.shape[1])
    we, se = torch.zeros(we_shape), torch.zeros(se_shape)
    mine = torch.from_numpy(buf[rank].copy())
    acc = torch.zeros(buf.shape[1], dtype=torch.float64)
    for _ in range(calls):
        out, we, se = backend.compressed_allreduce(mine, we, se)
        acc += out.double()
    return _np(acc / calls)


# --------------------------------------------------------------------------
# The optimizers' per-rank steps
# --------------------------------------------------------------------------

def step_chain(rank, world, kind, kwargs, n, leaf_slices, p0, grads, modes,
               lrs, reinit=()):
    """``kind``'s ``step`` on this rank: mode ``modes[k]`` with this rank's
    row of ``grads[k]`` (``[steps, world, npad]``), count k + 1, lr
    ``lrs[k]``, from zero state and ``p0``; before each step k in
    ``reinit`` the error buffers are zeroed (0/1 Adam's entry to the
    local regime, done by the runner). Returns each step's input and
    output params and state."""
    import torch
    from deepspeed_tpu_torch.runtime.fp16.onebit import ONEBIT_OPTIMIZERS
    opt = ONEBIT_OPTIMIZERS[kind](n, world, leaf_slices, **kwargs)
    st, p = opt.init_state(), torch.from_numpy(p0.copy())
    out = []
    for k, mode in enumerate(modes):
        g = torch.from_numpy(grads[k][rank].copy())
        if k in reinit:
            for key in ("worker_error", "server_error"):
                st[key] = torch.zeros_like(st[key])
        rec = {"p_in": _np(p), "st_in": {a: _np(v) for a, v in st.items()}}
        p, st = opt.step(mode, g, st, p, lrs[k], k + 1, None)
        rec.update(p=_np(p), st={a: _np(v) for a, v in st.items()})
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

def _engine(state, config, dtype="float32", seed=0):
    return helpers.port_engine(helpers.port_model(state, seed=seed,
                                                  dtype=dtype), config)


def _runner_state(engine):
    return {k: _np(v) for k, v in engine._onebit.state.items()}


def _master(engine):
    return _np(engine._onebit.master)


def engine_runs(rank, world, state, runs, micros):
    """Each run of ``runs`` (name -> (config, steps)) from ``state``:
    losses, grad norms, modes, the master and this rank's 1-bit state
    after every step, the wire accounting; a dense run gives its losses and
    consolidated masters."""
    out = {}
    for name, (config, steps) in runs.items():
        engine = _engine(state, config)
        gas = engine.gradient_accumulation_steps()
        rec = collections.defaultdict(list)
        for s in range(steps):
            loss = engine.train_batch(iter(micros[gas * s:gas * (s + 1)]))
            rec["losses"].append(float(loss))
            rec["norms"].append(engine.get_global_grad_norm())
            if engine._onebit is not None:
                rec["masters"].append(_master(engine))
                rec["states"].append(_runner_state(engine))
        if engine._onebit is not None:
            run = engine._onebit
            rec.update(comm_bytes=dict(run.comm_bytes), n=run.n,
                       npad=run.opt.npad, ratio=run.compression_ratio(),
                       master=engine.consolidated_fp32_state_dict())
        else:
            rec["master"] = engine.consolidated_fp32_state_dict()
        out[name] = dict(rec)
    return out


def resume(rank, world, state, config, micros, first, then, save_dir):
    """``first`` steps, save, ``then`` more; a fresh engine (other random
    weights) loads the save and takes the same ``then`` steps. Returns both
    runs' losses, masters and 1-bit state, and the loaded engine's
    counters."""
    engine = _engine(state, config)
    gas = engine.gradient_accumulation_steps()

    def steps(eng, lo, hi):
        return [float(eng.train_batch(iter(micros[gas * s:gas * (s + 1)])))
                for s in range(lo, hi)]
    out = {"first": steps(engine, 0, first)}
    engine.save_checkpoint(save_dir, tag="mid")
    out["saved_state"] = _runner_state(engine)
    out["cont"] = steps(engine, first, first + then)
    out["cont_master"], out["cont_state"] = (_master(engine),
                                             _runner_state(engine))
    fresh = _engine(None, config, seed=7)
    fresh.load_checkpoint(save_dir)
    out["loaded_state"] = _runner_state(fresh)
    out["loaded_counts"] = (fresh._onebit.step, fresh._onebit.skipped,
                            fresh.global_steps)
    policy = getattr(fresh.optimizer, "policy", None)
    if policy is not None:
        out["policy"] = (policy.step, policy.frozen, policy.local_interval,
                         policy._errors_reinit)
    out["resumed"] = steps(fresh, first, first + then)
    out["resumed_master"], out["resumed_state"] = (_master(fresh),
                                                   _runner_state(fresh))
    return out


def resumes(rank, world, cases):
    return {name: resume(rank, world, **kw) for name, kw in cases.items()}


def fp16_skip(rank, world, state, config, micros, before, overflow_rank):
    """fp16 at a static scale: ``before`` steps, then one step whose loss
    scale is raised past fp16's range on ``overflow_rank`` only, then one
    more at the configured scale. Returns the master and state around the
    overflow step, its loss, and the skip counters."""
    engine = _engine(state, config, dtype="float16")
    gas = engine.gradient_accumulation_steps()

    def step(s):
        return float(engine.train_batch(
            iter(micros[gas * s:gas * (s + 1)])))
    losses = [step(s) for s in range(before)]
    out = {"master_before": _master(engine),
           "state_before": _runner_state(engine)}
    scale = engine._scale
    if rank == overflow_rank:
        engine._scale = scale._replace(cur_scale=2.0 ** 40)
    losses.append(step(before))
    engine._scale = scale
    out.update(master_after=_master(engine), state_after=_runner_state(engine),
               skipped=(engine._onebit.skipped, engine.skipped_steps),
               count=engine._onebit.count)
    losses.append(step(before + 1))
    out.update(losses=losses, master_next=_master(engine),
               next_mode=engine._onebit.last_mode)
    return out


def fp16_skips(rank, world, cases):
    return {name: fp16_skip(rank, world, **kw) for name, kw in cases.items()}


def refusals(rank, world, state, configs):
    """``initialize`` with each config (name -> config): the exception's
    type and message, or None when it builds."""
    out = {}
    for name, config in configs.items():
        try:
            _engine(state, config)
            out[name] = None
        except Exception as e:                      # noqa: BLE001
            out[name] = (type(e).__name__, str(e))
    return out
