"""The TPU package's engine with a 1-bit optimizer over a two-device CPU
mesh, in a child process, for the port's engine parity test
(tests/test_torch_onebit.py).

The 1-bit exchange depends on the number of dp ranks, and the pytest
process holds an 8-device CPU mesh, so the JAX runs happen here, with
``XLA_FLAGS`` giving the child as many devices as the port has ranks:

    python torch_onebit_jax.py <in.pkl> <out.pkl>

``in.pkl`` holds the model config keywords, the f32 params tree (numpy
leaves), the runs (name -> (engine config, steps)) and the global
micro-batches; ``out.pkl`` gets each run's losses and grad norms, and the
master tree after it.
"""

import pickle
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main(src: str, dst: str) -> None:
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import GPT, GPTConfig, lm_loss_fn
    with open(src, "rb") as fh:
        job = pickle.load(fh)
    cfg = GPTConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                    **job["model"])
    micros = job["micros"]
    out = {}
    for name, (config, steps) in job["runs"].items():
        engine, *_ = ds.initialize(
            model=GPT(cfg), loss_fn=lm_loss_fn, config=config,
            model_parameters=jax.tree.map(jnp.asarray, job["params"]))
        assert engine.dp_world_size == len(jax.devices())
        gas = config["gradient_accumulation_steps"]
        losses, norms = [], []
        for s in range(steps):
            batch = [{k: jnp.asarray(v) for k, v in m.items()}
                     for m in micros[gas * s:gas * (s + 1)]]
            losses.append(float(jax.device_get(
                engine.train_batch(iter(batch)))))
            norms.append(float(engine.get_global_grad_norm()))
        out[name] = {"losses": losses, "norms": norms,
                     "master": jax.tree.map(np.asarray,
                                            engine.state["master"])}
    with open(dst, "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
