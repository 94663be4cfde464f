"""The TPU package's layer-streamed engine in a one-device child process,
for the port's streamed-engine parity test (tests/test_torch_layer_stream.py).

The streamed tier is single-chip, and the pytest process holds an 8-device
CPU mesh, so the JAX run happens here, as tests/layer_stream_worker.py runs
it for the JAX package's own tests:

    python torch_layer_stream_jax.py <in.pkl> <out.pkl>

``in.pkl`` holds the model config keywords, the f32 params tree (numpy
leaves), the engine config and the micro-batches; ``out.pkl`` gets the
losses, grad norms and the host master tree after the steps.
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
                    scan_layers=True, **job["model"])
    params = jax.tree.map(jnp.asarray, job["params"])
    engine, *_ = ds.initialize(model=GPT(cfg), model_parameters=params,
                               loss_fn=lm_loss_fn, config=job["config"])
    assert engine._layer_streamer is not None
    gas = job["config"]["gradient_accumulation_steps"]
    micros = job["micros"]
    losses, norms = [], []
    for step in range(len(micros) // gas):
        batch = [{k: jnp.asarray(v) for k, v in m.items()}
                 for m in micros[gas * step:gas * (step + 1)]]
        losses.append(float(jax.device_get(engine.train_batch(iter(batch)))))
        norms.append(float(engine.get_global_grad_norm()))
    master = jax.tree.map(np.asarray, engine.host_optimizer.master_tree())
    with open(dst, "wb") as fh:
        pickle.dump({"losses": losses, "norms": norms, "master": master}, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
