"""The PyTorch port's pipeline over gloo ranks (one stage a rank), against
the JAX package's engines in this process.

One start of two ranks (mesh ``{"pp": 2}``) and one of four run every
case (``tests/torch_pipe_helpers.py``):

  * 1F1B at pp 2, and at pp 2 x dp 2 under ZeRO 0, 1 and 2: losses within
    rtol 2e-4 of the JAX engine at pp 2 (the JAX package's own bound for a
    dp change, ``tests/test_pipe_engine.py:194``), equal on every rank;
    the final masters of each stage within 3e-4 (see
    ``test_torch_pipe.py``); the tied replicas on the two stage ranks
    equal; SGD tied-weight values; fp16 dynamic scaling: the same skipped
    steps on every rank as the JAX engine; a checkpoint resumed by fresh
    engines equal to the continuation;
  * pp 2 x ep 2 (GPT-MoE, 4 experts): losses within rtol 2e-4 of the
    port's pp 1 x dp 2 x ep 2 on the same global batches (the JAX
    package's ``test_pipeline_moe_pp2_matches_pp1``) and of the JAX
    engine's (neither engine draws gate noise: the TPU engine passes its
    layers no rng);
  * ``GPipeSpmdEngine`` at pp 2 and pp 2 x dp 2: losses within rtol 1e-5
    of JAX's ``GPipeSpmdEngine`` on the same GPT params, the first equal to
    the dense loss, the eval loss, ``params_tree`` close to JAX's,
    global-norm clipping on, and a checkpoint resumed equal to the
    continuation;
  * 3D parallelism against the JAX engine at the same mesh
    (``tests/test_pipe_engine.py:452-508``; f32, losses within rtol 2e-4,
    whole masters within 3e-4): pp 2 x tp 2 (each stage's qkv, MLP and
    vocab leaves held as tp shards), pp 1 x tp 2 (every stage in each of
    two processes over one tp group), pp 2 x sp 2 with Ulysses and with the
    ring; a pp 2 x tp 2 checkpoint resumed by fresh engines equal to the
    continuation, and loaded whole by a pp 1 engine at tp 1;
  * what stays refused: an MoE model at tp, a model without
    ``sequence_parallel`` at sp, a block-sparse layout under Ulysses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import torch_dist_helpers as helpers
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_pipe as jpipe
from deepspeed_tpu.runtime.pipe.spmd import GPipeSpmdEngine as JGPipe
from deepspeed_tpu.runtime.pipe.spmd import gpt_pipe_spec as jspec
from torch_pipe_helpers import pipe_module
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu_torch.convert import (jax_params_to_state_dict,
                                         pipe_params_to_state_dict)
from deepspeed_tpu_torch.models import gpt as pgpt
from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig

TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
            d_model=32, d_ff=64)
MOE = dict(TINY, moe=True, num_experts=4, moe_top_k=1,
           moe_capacity_factor=2.0)
# the JAX package's pp x tp and pp x sp tests' GPTs
TP = dict(TINY, num_heads=4, attention_impl="xla")
SP = dict(TINY, attention_impl="xla", sequence_parallel=True)
GPIPE = dict(num_layers=4, num_heads=2, d_model=32, d_ff=64,
             vocab_size=128, max_seq_len=16)
CONFIG = {"train_micro_batch_size_per_gpu": 4,
          "gradient_accumulation_steps": 4,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
SGD = dict(CONFIG, gradient_accumulation_steps=2,
           optimizer={"type": "SGD", "params": {"lr": 1e-2}})
FP16 = dict(CONFIG, fp16={"enabled": True, "loss_scale": 0,
                          "initial_scale_power": 40, "hysteresis": 1,
                          "loss_scale_window": 4})
STEPS = 3


def _tokens(seed=0, n=4, bs=4, vocab=64, seq=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (bs, seq)).astype(np.int32)
            for _ in range(n)]


def _batches(micros):
    return iter([(m, m) for m in micros])


def _jax_pipe(cfg_kw, config, steps, micros, mesh=None):
    """The JAX 1F1B engine at pp 2 (shared mode, or ``mesh``'s stage
    sub-meshes): its converted initial state, its losses, its final masters
    and skipped steps."""
    if mesh is not None:
        from deepspeed_tpu.parallel import mesh as jmesh
        jmesh.reset_global_mesh()
    jcfg = jgpt.GPTConfig(**cfg_kw, dtype=jnp.float32,
                          param_dtype=jnp.float32, scan_layers=False,
                          remat=False)
    je, *_ = ds.initialize(
        model=jpipe.gpt_pipe_module(jcfg, 2, partition_method="uniform"),
        config=dict(config, mesh=mesh or {"dp": 1}))
    je.eval_batch(_batches(micros[:1]))
    pm = pipe_module(cfg_kw, 2)

    def state():
        return {k: v.numpy() for k, v in pipe_params_to_state_dict(
            jax.tree.map(np.asarray, jax.device_get(je.stage_params)),
            pm).items()}
    init = state()
    losses = [float(je.train_batch(_batches(micros))) for _ in range(steps)]
    return {"init": init, "losses": losses, "final": state(),
            "skipped": je.skipped_steps}


def _jax_gpipe(dp, clip, micros, steps):
    jcfg = jgpt.GPTConfig(**GPIPE, dtype=jnp.float32,
                          param_dtype=jnp.float32, remat=False)
    model = jgpt.GPT(jcfg)
    ids = np.concatenate(micros)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]))[
        "params"]
    eng = JGPipe(jspec(jcfg), params, num_stages=2, micro_batches=len(micros),
                 dp=dp, lr=1e-3, remat=False, gradient_clipping=clip)
    ids3 = np.stack(micros)
    out = {"eval0": float(eng.eval_loss(ids3))}
    out["losses"] = [float(eng.train_batch(iter(
        [{"input_ids": m} for m in micros]))) for _ in range(steps)]
    pcfg = pgpt.GPTConfig(**GPIPE, dtype=torch.float32)
    out["init"] = {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), pcfg).items()}
    out["final"] = {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(eng.params_tree())),
        pcfg).items()}
    out["dense0"] = float(jgpt.lm_loss_fn(
        model.apply({"params": params}, jnp.asarray(ids)),
        {"input_ids": jnp.asarray(ids)}))
    return out


@pytest.fixture(scope="module")
def refs():
    micros = _tokens()
    gp = _tokens(3, n=2, bs=4, vocab=128)
    return {
        "micros": micros, "gpipe_micros": gp,
        "adam": _jax_pipe(TINY, CONFIG, STEPS, micros),
        "sgd": _jax_pipe(TINY, SGD, 5, micros[:2]),
        "fp16": _jax_pipe(TINY, FP16, 6, micros),
        "moe": _jax_pipe(MOE, CONFIG, STEPS, micros),
        "gpipe": _jax_gpipe(1, 0.0, gp, STEPS),
        "gpipe_clip": _jax_gpipe(1, 0.05, gp, STEPS),
        "gpipe_dp2": _jax_gpipe(2, 0.0, gp, STEPS),
        # the JAX package's own 3D meshes (dp 2: micro 2 a dp rank)
        "tp": _jax_pipe(TP, dict(CONFIG, train_micro_batch_size_per_gpu=2),
                        STEPS, micros, mesh={"dp": 2, "pp": 2, "tp": 2}),
        **{f"sp_{impl}": _jax_pipe(
            dict(SP, cp_impl=impl),
            dict(CONFIG, train_micro_batch_size_per_gpu=2), STEPS, micros,
            mesh={"dp": 2, "pp": 2, "sp": 2})
           for impl in ("ulysses", "ring")},
    }


def _pipe(config, micros, state, steps=STEPS, cfg_kw=TINY, **kw):
    return ("pipe_train", dict(cfg_kw=cfg_kw, num_stages=2, config=config,
                               micros=micros, steps=steps, state=state,
                               **kw))


def _gpipe(ref, micros, dp, clip=0.0, **kw):
    return ("gpipe_train", dict(cfg_kw=GPIPE, state=ref["init"],
                                micros=micros, steps=STEPS, num_stages=2,
                                dp=dp, clip=clip, **kw))


@pytest.fixture(scope="module")
def two(refs, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe2")
    m, gp = refs["micros"], refs["gpipe_micros"]
    pp2 = dict(CONFIG, mesh={"pp": 2})
    calls = {
        "adam": _pipe(pp2, m, refs["adam"]["init"], save_dir=str(d / "p"),
                      resume_steps=2),
        "sgd": _pipe(dict(SGD, mesh={"pp": 2}), m[:2], refs["sgd"]["init"],
                     steps=5),
        "fp16": _pipe(dict(FP16, mesh={"pp": 2}), m, refs["fp16"]["init"],
                      steps=6),
        "tp_pp1": _pipe(dict(CONFIG, mesh={"pp": 1, "tp": 2}), m,
                        refs["tp"]["init"], cfg_kw=TP),
        # the same models at tp 1 / sp 1, for the global grad norms
        "tp_1": _pipe(pp2, m, refs["tp"]["init"], cfg_kw=TP),
        **{f"sp_{impl}_1": _pipe(pp2, m, refs[f"sp_{impl}"]["init"],
                                 cfg_kw=dict(SP, cp_impl=impl))
           for impl in ("ulysses", "ring")},
        "refusals": ("pipe_refusals", dict(
            cfg_kw=MOE, num_stages=2, config=CONFIG,
            meshes={"moe_tp": {"pp": 1, "tp": 2}})),
        "refusals_sp": ("pipe_refusals", dict(
            cfg_kw=TINY, num_stages=2, config=CONFIG,
            meshes={"sp": {"pp": 1, "sp": 2}})),
        "refusals_sparse": ("pipe_refusals", dict(
            cfg_kw=dict(SP, attention_impl="sparse",
                        sparse_attention=BigBirdSparsityConfig(
                            num_heads=2, block=8)),
            num_stages=2, config=CONFIG, meshes={"sparse": {"pp": 1,
                                                            "sp": 2}})),
        "gpipe": _gpipe(refs["gpipe"], gp, 1, remat=True,
                        save_dir=str(d / "g"), resume_steps=2),
        "gpipe_clip": _gpipe(refs["gpipe_clip"], gp, 1, clip=0.05),
    }
    return helpers.run_ranks("torch_pipe_helpers:cases", 2, timeout=300.0,
                             calls=calls)


@pytest.fixture(scope="module")
def tp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


@pytest.fixture(scope="module")
def four(refs, tp_dir):
    m, gp = refs["micros"], refs["gpipe_micros"]
    calls = {f"zero{z}": _pipe(dict(CONFIG, train_micro_batch_size_per_gpu=2,
                                    zero_optimization={"stage": z},
                                    mesh={"pp": 2, "dp": 2}),
                               m, refs["adam"]["init"])
             for z in (0, 1, 2)}
    moe = dict(CONFIG, train_micro_batch_size_per_gpu=4)
    calls["moe_pp2"] = _pipe(dict(moe, mesh={"pp": 2, "ep": 2}), m,
                             refs["moe"]["init"], cfg_kw=MOE)
    calls["moe_pp1"] = _pipe(dict(moe, train_micro_batch_size_per_gpu=2,
                                  mesh={"pp": 1, "dp": 2, "ep": 2}), m,
                             refs["moe"]["init"], cfg_kw=MOE)
    calls["gpipe_dp2"] = _gpipe(refs["gpipe_dp2"], gp, 2)
    calls["tp"] = _pipe(dict(CONFIG, mesh={"pp": 2, "tp": 2}), m,
                        refs["tp"]["init"], cfg_kw=TP,
                        save_dir=str(tp_dir),
                        resume_steps=2)
    for impl in ("ulysses", "ring"):
        calls[f"sp_{impl}"] = _pipe(dict(CONFIG, mesh={"pp": 2, "sp": 2}), m,
                                    refs[f"sp_{impl}"]["init"],
                                    cfg_kw=dict(SP, cp_impl=impl))
    return helpers.run_ranks("torch_pipe_helpers:cases", 4, timeout=300.0,
                             calls=calls)


def _masters_close(ranks, want, name, atol=3e-4):
    got = {}
    for r in ranks:
        got.update(r[name]["master"])
    assert set(got) == set(want)
    d = TINY["d_model"]      # the d_model of every config here
    for k, v in want.items():
        g, w = got[k].copy(), v.copy()
        if k.endswith("attn.qkv.bias"):
            g[d:2 * d] = w[d:2 * d] = 0       # exact grad 0: Adam on noise
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def _same_on_every_rank(ranks, name, key="losses"):
    first = ranks[0][name][key]
    assert all(r[name][key] == first for r in ranks), name
    return first


def test_pp2_matches_jax(refs, two):
    assert [r["adam"]["stage"] for r in two] == [0, 1]
    assert [r["adam"]["local"] for r in two] == [[0], [1]]
    losses = _same_on_every_rank(two, "adam")
    np.testing.assert_allclose(losses, refs["adam"]["losses"], rtol=2e-4)
    _masters_close(two, refs["adam"]["final"], "adam")
    # the tied replicas on the two stages' ranks stay equal
    np.testing.assert_array_equal(two[0]["adam"]["master"]["0.wte.weight"],
                                  two[1]["adam"]["master"]["4.wte.weight"])
    assert two[0]["adam"]["eval"] == two[1]["adam"]["eval"]


def test_pp2_sgd_tied_values(refs, two):
    np.testing.assert_allclose(
        two[0]["sgd"]["master"]["0.wte.weight"],
        refs["sgd"]["final"]["0.wte.weight"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        two[1]["sgd"]["master"]["4.wte.weight"],
        refs["sgd"]["final"]["4.wte.weight"], rtol=1e-5, atol=1e-7)


def test_pp2_fp16_skips_agree(refs, two):
    skipped = [r["fp16"]["skipped"] for r in two]
    assert skipped == [refs["fp16"]["skipped"]] * 2 and skipped[0] >= 1
    losses = _same_on_every_rank(two, "fp16")
    np.testing.assert_allclose(losses, refs["fp16"]["losses"], rtol=2e-3)


def test_pp2_checkpoint_resume(two):
    for r in two:
        assert r["adam"]["resumed_tag"] == "t"
        assert r["adam"]["resumed_steps"] == STEPS
        assert r["adam"]["resumed"] == r["adam"]["cont"]


def test_pp_tp_and_pp_sp_refused(two):
    """tp and sp inside a stage are ported; what the dense model refuses
    stays refused: an MoE model at tp, and at sp a model without
    ``sequence_parallel`` or with a block-sparse layout under Ulysses."""
    got = two[0]["refusals"]["moe_tp"]
    assert got.startswith("NotImplementedError") and \
        "MoE model at tp" in got and "ROADMAP A9" in got, got
    got = two[0]["refusals_sp"]["sp"]
    assert got.startswith("ValueError") and "sequence_parallel=True" in got
    got = two[0]["refusals_sparse"]["sparse"]
    assert got.startswith("NotImplementedError") and \
        "block-sparse attention over an sp group" in got and \
        "ROADMAP A9" in got, got


@pytest.mark.parametrize("case,world", [("tp", 4), ("tp_pp1", 2),
                                        ("sp_ulysses", 4), ("sp_ring", 4)])
def test_3d_matches_jax(refs, two, four, case, world):
    """pp 2 x tp 2, pp 1 x tp 2 and pp 2 x sp 2 (both cp_impls) against
    the JAX engine at its 3D mesh: losses equal on every rank and within
    rtol 2e-4, whole masters within 3e-4, every rank at its degrees; the
    global grad norms (each tp shard and each replicated leaf once) within
    rtol 2e-4 of the same model's at pp 2 alone."""
    ranks = four if world == 4 else two
    ref = refs[case.replace("_pp1", "")]
    axis = case[:2]
    assert [r[case][axis] for r in ranks] == [2] * world
    if case == "tp_pp1":
        assert [r[case]["local"] for r in ranks] == [[0, 1]] * 2
    else:
        assert [r[case]["stage"] for r in ranks] == [0, 0, 1, 1]
    losses = _same_on_every_rank(ranks, case)
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-4)
    _masters_close(ranks, ref["final"], case)
    assert losses[-1] < losses[0]
    alone = case.replace("_pp1", "") + "_1"
    np.testing.assert_allclose(_same_on_every_rank(ranks, case, "norms"),
                               _same_on_every_rank(two, alone, "norms"),
                               rtol=2e-4)


def test_pp2_tp2_holds_tp_shards(refs, four):
    """Each rank holds its tp shard of every block's qkv (a third of each
    of q, k and v: 3 x d/2 rows), MLP (up by rows, down by columns) and of
    the tied table (vocab rows); LayerNorms and row biases stay whole; the
    gathered masters are whole. Uniform parts: [embed, 2 blocks] and
    [final norm, head]."""
    d, ff, v = TP["d_model"], TP["d_ff"], TP["vocab_size"]
    assert [r["tp"]["stage"] for r in four] == [0, 0, 1, 1]
    for r in four:
        shapes = r["tp"]["shapes"]
        tied = "0" if r["tp"]["stage"] == 0 else "4"
        assert shapes[f"{tied}.wte.weight"] == (v // 2, d)
        assert r["tp"]["master"][f"{tied}.wte.weight"].shape == (v, d)
        blocks = sorted({k.partition(".")[0] for k in shapes
                         if ".attn." in k})
        assert blocks == (["1", "2"] if tied == "0" else [])
        for blk in blocks:
            assert shapes[f"{blk}.attn.qkv.weight"] == (3 * d // 2, d)
            assert shapes[f"{blk}.attn.qkv.bias"] == (3 * d // 2,)
            assert shapes[f"{blk}.attn.out_proj.weight"] == (d, d // 2)
            assert shapes[f"{blk}.attn.out_proj.bias"] == (d,)
            assert shapes[f"{blk}.mlp.up_proj.weight"] == (ff // 2, d)
            assert shapes[f"{blk}.mlp.down_proj.weight"] == (d, ff // 2)
            assert shapes[f"{blk}.ln_1.weight"] == (d,)
            assert r["tp"]["master"][f"{blk}.attn.qkv.weight"].shape == \
                (3 * d, d)


def test_pp2_tp2_checkpoint_resume(four):
    for r in four:
        assert r["tp"]["resumed_tag"] == "t"
        assert r["tp"]["resumed"] == r["tp"]["cont"]


def test_pp2_tp2_checkpoint_loads_at_tp1(four, tp_dir):
    """The pp 2 x tp 2 checkpoint holds whole leaves: an engine at pp 1 x
    tp 1 in this process loads it and holds the saved masters."""
    from torch_pipe_helpers import pipe_engine
    engine = pipe_engine(TP, 2, dict(CONFIG, mesh={"pp": 1}))
    assert engine.mp_world_size == 1
    tag, _ = engine.load_checkpoint(str(tp_dir))
    assert tag == "t"
    want = {}
    for r in four:
        want.update(r["tp"]["master"])
    got = {k: v.numpy() for k, v in engine.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("zero", [0, 1, 2])
def test_pp2_dp2_zero_matches_jax(refs, two, four, zero):
    name = f"zero{zero}"
    assert [r[name]["dp"] for r in four] == [2] * 4
    losses = _same_on_every_rank(four, name)
    np.testing.assert_allclose(losses, refs["adam"]["losses"], rtol=2e-4)
    _masters_close(four, refs["adam"]["final"], name)
    # the global grad norm: every leaf once, tied once, slices over dp
    np.testing.assert_allclose(_same_on_every_rank(four, name, "norms"),
                               _same_on_every_rank(two, "adam", "norms"),
                               rtol=2e-4)


def test_pp2_ep2_matches_pp1_and_jax(refs, four):
    assert [r["moe_pp2"]["ep"] for r in four] == [2] * 4
    pp2 = _same_on_every_rank(four, "moe_pp2")
    pp1 = _same_on_every_rank(four, "moe_pp1")
    np.testing.assert_allclose(pp2, pp1, rtol=2e-4)
    np.testing.assert_allclose(pp2, refs["moe"]["losses"], rtol=2e-4)
    np.testing.assert_allclose(_same_on_every_rank(four, "moe_pp2", "norms"),
                               _same_on_every_rank(four, "moe_pp1", "norms"),
                               rtol=2e-4)
    assert pp2[-1] < pp2[0]


@pytest.mark.parametrize("case", ["gpipe", "gpipe_clip"])
def test_gpipe_pp2_matches_jax(refs, two, case):
    ref = refs[case]
    losses = _same_on_every_rank(two, case)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(losses[0], ref["dense0"], rtol=1e-5)
    np.testing.assert_allclose(two[0][case]["eval0"], ref["eval0"],
                               rtol=1e-5)
    assert [r[case]["blocks"] for r in two] == [2, 2]
    _params_close(two[0][case]["params"], ref["final"])


def _params_close(got, want):
    d = GPIPE["d_model"]
    assert set(got) == set(want)
    for k, v in want.items():
        g, w = got[k].copy(), v.copy()
        if k.endswith("attn.qkv.bias"):
            g[d:2 * d] = w[d:2 * d] = 0       # exact grad 0: Adam on noise
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=k)


def test_gpipe_grad_norm_is_the_dense_one(refs, two):
    """The first step's global grad norm (blocks over pp once, the rest
    once) equals the dense engine's on the same weights and batches."""
    import deepspeed_tpu_torch as dst
    cfg = pgpt.GPTConfig(**GPIPE, dtype=torch.float32)
    model = pgpt.GPT(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in refs["gpipe"]["init"].items()})
    micros = refs["gpipe_micros"]
    eng, *_ = dst.initialize(model=model, loss_fn=pgpt.lm_loss_fn,
                             device="cpu", config={
                                 "train_micro_batch_size_per_gpu": 4,
                                 "gradient_accumulation_steps": len(micros),
                                 "optimizer": {"type": "AdamW",
                                               "params": {"lr": 1e-3}}})
    eng.train_batch(iter([{"input_ids": m} for m in micros]))
    norms = _same_on_every_rank(two, "gpipe", "norms")
    np.testing.assert_allclose(norms[0], eng.get_global_grad_norm(),
                               rtol=1e-5)


def test_gpipe_resume(two):
    for r in two:
        assert r["gpipe"]["resumed_step"] == STEPS
        assert r["gpipe"]["resumed"] == r["gpipe"]["cont"]


def test_gpipe_pp2_dp2_matches_jax(refs, four):
    ref = refs["gpipe_dp2"]
    losses = _same_on_every_rank(four, "gpipe_dp2")
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(losses[0], ref["dense0"], rtol=1e-5)
    _params_close(four[0]["gpipe_dp2"]["params"], ref["final"])
