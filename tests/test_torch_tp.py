"""Tensor parallelism in the port against the TPU package, on the CPU, f32,
tiny GPT-2 / GPT-NeoX / BERT configs. The port's ranks are gloo processes
(``torch_dist_helpers.run_ranks``: two, and four for dp 2 x tp 2); the TPU
package runs on its 8 virtual CPU devices.

  * ``tp_spec`` / ``kv_spec`` / ``classify`` / ``infer_tp_specs`` /
    ``quantize_shardings`` equal the TPU package's on every leaf of a
    GPT-2, a NeoX and a BERT tree; the port's split of each ``state_dict``
    leaf is the TPU spec's dim (through ``convert.gpt_flax_leaves``); the
    fused q|k|v splits by heads, a third at a time;
  * ``InferenceEngine(mp_size=2)`` logits within 1e-4 of the TPU
    ``init_inference(mp_size=2)``'s, greedy tokens equal, for GPT-2 and
    NeoX; ``jax_params_to_tp_state_dict`` loads into a split model and
    gives the same logits; with int8 weights each rank's codes and scales
    are bitwise the slice of the TPU ``quantize_tree``;
  * BERT through ``replace_method="auto"`` at tp 2 with int8 weights within
    1e-4 of the TPU engine's;
  * ``tp_overlap`` serves the tokens it serves off; ``ring_allreduce`` and
    the deferred reduce equal ``all_reduce``; the ring's row guard;
    ``decode_step_overlap_model`` equals the TPU one;
  * training at mesh tp 2 (ZeRO 0, 1, 2) and dp 2 x tp 2 (ZeRO 1, 2):
    losses and grad norms within rtol 2e-4 of the TPU engine at mesh
    {"tp": 2} on the same global batches; ``partition_activations`` keeps
    half of each block input and trains as off;
  * a checkpoint saved at tp 2 resumes at tp 2; one saved at dp 2 x tp 2
    (host-sharded files) loads at tp 1 and trains on as the saving run
    does, and ``zero_to_fp32.py`` rebuilds its whole weights;
  * the refusals left: ZeRO-3 and the offload tiers at tp 2, an MoE model
    at tp 2, ep x tp, heads tp does not divide, tp x sp.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, _state_dict_np
from torch_port_helpers import TINY, model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu_torch.comm.comm import CommGroup
from deepspeed_tpu_torch.convert import (gpt_flax_leaves,
                                         jax_params_to_state_dict,
                                         jax_params_to_tp_state_dict)
from deepspeed_tpu_torch.models.gpt import (GPT, GPTConfig,
                                            set_sequence_parallel,
                                            set_tensor_parallel)
from deepspeed_tpu_torch.module_inject import auto_tp as pauto
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.runtime import sharding as psh

NEOX = dict(num_heads=4, rotary=True, parallel_residual=True,
            tie_embeddings=False)
MODELS = {"gpt2": {}, "neox": NEOX}
# grads summed in another grouping over tp and dp: f32 summation noise, as
# the ep tests hold (tests/test_torch_moe_ep.py)
TP_RTOL = 2e-4
GLOBAL_MICRO, STEPS, GAS = 8, 3, ENGINE_CONFIG["gradient_accumulation_steps"]


@functools.lru_cache(None)
def _pair(name):
    jmodel, params, pmodel = model_pair(seed=41, **MODELS[name])
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, pmodel.cfg, state


def _model_kw(name, **extra):
    return dict(TINY, remat=False, **MODELS[name], **extra)


def _tree_np(params):
    return jax.tree.map(np.asarray, params)


# --------------------------------------------------------------------------
# The rules, leaf by leaf (no ranks)
# --------------------------------------------------------------------------

def _bert_params():
    from deepspeed_tpu.models.bert import BertConfig, BertModel
    cfg = BertConfig(vocab_size=128, max_seq_len=64, num_layers=2,
                     num_heads=2, d_model=64, d_ff=128, dtype=jnp.float32,
                     param_dtype=jnp.float32)
    return BertModel(cfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _trees():
    return {"gpt2": _pair("gpt2")[1], "neox": _pair("neox")[1],
            "bert": _bert_params()}


@pytest.mark.parametrize("tree", ["gpt2", "neox", "bert"])
def test_specs_equal_jax_on_every_leaf(tree):
    from deepspeed_tpu.module_inject import auto_tp as jauto
    from deepspeed_tpu.runtime import sharding as jsh
    params = _trees()[tree]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        p = jsh.path_str(path)
        assert psh.tp_spec(p, leaf.ndim) == tuple(jsh.tp_spec(p, leaf.ndim)), p
        key = jax.tree_util.keystr(path)
        assert pauto.classify(key, leaf.shape) == jauto.classify(
            key, leaf.shape), key
    want = jax.tree_util.tree_flatten_with_path(
        jauto.infer_tp_specs(params),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    got = pauto.infer_tp_specs(_tree_np(params))
    assert {jax.tree_util.keystr(k): tuple(v) for k, v in want} == got
    # the serving cache's leaves, flat and 4-D, at tp 1, 2 and 4
    for tp in (1, 2, 4):
        for path, shape, hd in (("cache/cached_key", (2, 4, 16, 128), 64),
                                ("cache/cached_value", (2, 4, 16, 2, 64), 64),
                                ("cache/cached_key", (2, 4, 16, 96), None),
                                ("cache/cache_index", (4,), 64),
                                ("cache/k_scale", (2, 4, 16), 64)):
            assert psh.kv_spec(path, shape, tp, hd) == tuple(
                jsh.kv_spec(path, shape, tp, hd)), (path, shape, tp)


@pytest.mark.parametrize("name", ["gpt2", "neox"])
def test_port_split_is_the_jax_spec_dim(name):
    """Each port leaf splits the dim the TPU spec splits in its flax leaf
    (the torch weight is the kernel transposed)."""
    from deepspeed_tpu.runtime import sharding as jsh
    _, params, cfg, state = _pair(name)
    leaves = gpt_flax_leaves(cfg)
    for pname, arr in state.items():
        leaf = leaves[pname]
        spec = jsh.tp_spec(leaf.path, len(leaf.shape))
        # the flax leaf's split dim, past its stacked layer dim
        dims = [i for i, a in enumerate(spec) if a == "tp"]
        split = psh.tp_split(pname, arr.shape, 2)
        if not dims:
            assert split is None, pname
            continue
        off = 1 if leaf.layer is not None else 0
        fdim = dims[0] - off
        if leaf.transposed:
            fdim = arr.ndim - 1 - fdim
        assert split is not None and split.dim == fdim, pname
        assert split.blocks == (3 if ".qkv." in pname else 1), pname


def test_qkv_splits_by_heads():
    _, params, cfg, state = _pair("neox")
    w = torch.from_numpy(state["blocks.0.attn.qkv.weight"])   # [3D, D]
    b = torch.from_numpy(state["blocks.0.attn.qkv.bias"])
    d, D = cfg.head_dim, cfg.d_model
    split = psh.tp_split("blocks.0.attn.qkv.weight", w.shape, 2)
    q, k, v = w.split(D)
    shards = []
    for r in range(2):
        heads = slice(r * D // 2, (r + 1) * D // 2)       # heads 2r, 2r+1
        want = torch.cat([q[heads], k[heads], v[heads]])
        got = split.take(w, r)
        assert torch.equal(got, want)
        assert torch.equal(psh.tp_split("blocks.0.attn.qkv.bias", b.shape,
                                        2).take(b, r),
                           torch.cat([t[heads] for t in b.split(D)]))
        shards.append(got)
    assert torch.equal(split.merge(shards), w)
    # the TPU spec cuts the columns contiguously: rank 0 would hold all of
    # q and half of k
    assert not torch.equal(w[:3 * D // 2], shards[0])
    # a one-rank group keeps the model whole
    model = GPT(GPTConfig(dtype=torch.float32, **_model_kw("neox")))
    assert set_tensor_parallel(model, None) is model
    assert model.tp_size == 1 and model.blocks[0].attn.local_heads == 4
    assert d * 4 == D


def test_quantize_shardings_equal_jax():
    from jax.sharding import NamedSharding
    from deepspeed_tpu.ops.quantizer import quantize_shardings, quantize_tree
    from deepspeed_tpu.parallel import mesh as mesh_lib
    from deepspeed_tpu.runtime import sharding as jsh
    params = _pair("neox")[1]
    qtree = quantize_tree(params)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshShape.infer(8, tp=2))
    fp = jax.tree_util.tree_map_with_path(
        lambda p, x: NamedSharding(mesh, jsh.tp_spec(jsh.path_str(p),
                                                     x.ndim)), params)
    want = quantize_shardings(qtree, fp, mesh)
    fp_specs = jax.tree_util.tree_map_with_path(
        lambda p, x: psh.tp_spec(jsh.path_str(p), x.ndim), params)
    got = pq.quantize_shardings(jax.tree.map(np.asarray, qtree), fp_specs)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))[0])
    assert len(flat_w) == len(flat_g)
    for path, sh in flat_w:
        spec = tuple(sh.spec) + (None,) * (len(flat_g[path]) - len(sh.spec))
        assert flat_g[path] == spec, jax.tree_util.keystr(path)


def test_decode_step_overlap_model_equals_jax():
    from deepspeed_tpu.ops.tp_overlap import decode_step_overlap_model as j
    from deepspeed_tpu_torch.ops.tp_overlap import \
        decode_step_overlap_model as p
    for args in ((1.0, 2.0, 3.0), (0.5, 4.0, 1.0), (0.0, 0.0, 0.0)):
        assert p(*args) == j(*args)


def test_refusals_without_ranks():
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    from deepspeed_tpu_torch import InferenceEngine
    with pytest.raises(ValueError, match="parallel_residual"):
        JaxConfig(tp_overlap=True)
    with pytest.raises(ValueError, match="parallel_residual"):
        GPTConfig(tp_overlap=True)
    GPTConfig(tp_overlap=True, parallel_residual=True)
    with pytest.raises(ValueError, match="cp_impl"):
        GPTConfig(sequence_parallel=True, cp_impl="zigzag")
    two = CommGroup(axes=("tp",), ranks=(0, 1))
    # sequence_parallel builds (tests/test_torch_sequence_parallel.py); a
    # model split over sp and then tp is what raises
    sp = set_sequence_parallel(
        GPT(GPTConfig(dtype=torch.float32, sequence_parallel=True,
                      **_model_kw("gpt2"))),
        CommGroup(axes=("sp",), ranks=(0, 1)))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        set_tensor_parallel(sp, two)
    moe = GPT(GPTConfig(dtype=torch.float32, moe=True, num_experts=2,
                        **_model_kw("gpt2")))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        set_tensor_parallel(moe, two)
    odd = GPT(GPTConfig(dtype=torch.float32, **dict(_model_kw("gpt2"),
                                                    num_heads=1)))
    with pytest.raises(ValueError, match="num_heads"):
        set_tensor_parallel(odd, two)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        InferenceEngine(odd, mp_size=2, ep_size=2, device="cpu")


# --------------------------------------------------------------------------
# Two ranks: inference, overlap, training, checkpoints, refusals
# --------------------------------------------------------------------------

def _ids(seed=3, rows=2, seq=12):
    return np.random.default_rng(seed).integers(
        1, TINY["vocab_size"], (rows, seq)).astype(np.int32)


def _bert():
    from test_torch_bert import BASE, _batch, bert_pair
    jmodel, params, pmodel = bert_pair(seed=4)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    cfg = {k: v for k, v in BASE.items()}
    return jmodel, params, cfg, state, _batch(5)


def _micros(seed=60):
    return [{"input_ids": helpers.ids(seed + i, GLOBAL_MICRO)}
            for i in range(STEPS * GAS + 2 * GAS)]


def _config(tp, dp, stage=1, **extra):
    return {**ENGINE_CONFIG, "train_micro_batch_size_per_gpu":
            GLOBAL_MICRO // dp, "zero_optimization": {"stage": stage},
            "mesh": {"tp": tp} if tp > 1 else {}, **extra}


@pytest.fixture(scope="module")
def tmp_dirs(tmp_path_factory):
    return {k: str(tmp_path_factory.mktemp(f"tp_{k}"))
            for k in ("tp2", "dp2tp2")}


@pytest.fixture(scope="module")
def two(tmp_dirs):
    models = {}
    for name in MODELS:
        _, params, cfg, state = _pair(name)
        tree = _tree_np(params)
        models[name] = (_model_kw(name), state,
                        [{k: v.numpy() for k, v in
                          jax_params_to_tp_state_dict(tree, cfg, 2, r)
                          .items()} for r in range(2)])
    _, _, bcfg, bstate, (bids, btypes, bmask) = _bert()
    state = _pair("neox")[3]
    micros = _micros()
    run = dict(state=state, micros=micros, steps=STEPS)
    neox = _model_kw("neox")
    train = {
        "tp2": dict(model=neox, config=_config(2, 1), **run),
        "tp2_stage0": dict(model=neox, config=_config(2, 1, 0), **run),
        "tp2_stage2": dict(model=neox, config=_config(2, 1, 2), **run),
        "tp1_dp2": dict(model=neox, config=_config(1, 2), **run),
        "pa_off": dict(model=dict(neox, remat=True, remat_policy="nothing"),
                       config=_config(2, 1), saved=True, **run),
        "pa_on": dict(model=dict(neox, remat=True, remat_policy="nothing"),
                      config=_config(2, 1, activation_checkpointing={
                          "partition_activations": True}), saved=True,
                      **run),
        # a sequence tp does not divide (31 rows): warned, kept whole
        "pa_odd": dict(model=dict(neox, remat=True),
                       config=_config(2, 1, activation_checkpointing={
                           "partition_activations": True}),
                       state=state, steps=1,
                       micros=[{"input_ids": m["input_ids"][:, :31]}
                               for m in micros[:GAS]]),
        "save": dict(model=neox, config=_config(2, 1),
                     save_dir=tmp_dirs["tp2"], **run),
        "cont": dict(model=neox, config=_config(2, 1), state=state,
                     micros=micros[STEPS * GAS:], steps=2,
                     load_dir=tmp_dirs["tp2"]),
        "zero3": dict(model=neox, config=_config(2, 1, 3), refuse=True,
                      state=state),
        "offload": dict(model=neox, config=_config(2, 1, 2,
                                                   zero_optimization={
                                                       "stage": 2,
                                                       "offload_optimizer":
                                                       {"device": "cpu"}}),
                        refuse=True, state=state),
        "pipeline": dict(model=neox, config=dict(_config(1, 2),
                                                 mesh={"pp": 2}),
                         refuse=True, state=state),
    }
    calls = {
        "inference": ("inference", dict(
            models=models, ids=_ids(),
            bert=(bcfg, bstate, bids, btypes, bmask))),
        "overlap": ("overlap_and_ring", dict(
            cfg=_model_kw("neox"), state=state,
            prompts=[_ids(7, 1, n)[0] for n in (5, 9, 13)])),
        "train": ("train", dict(cases=train)),
    }
    return helpers.run_ranks("torch_tp_helpers:cases", 2, timeout=420.0,
                             calls=calls)


@pytest.fixture(scope="module")
def four(tmp_dirs):
    state = _pair("neox")[3]
    micros = _micros()
    run = dict(state=state, micros=micros, steps=STEPS)
    neox = _model_kw("neox")
    cases = {
        "dp2tp2": dict(model=neox, config=_config(2, 2), **run),
        "dp2tp2_stage2": dict(model=neox, config=_config(2, 2, 2), **run),
        "save": dict(model=neox, config=_config(2, 2,
                                                sharded_checkpoint=True),
                     save_dir=tmp_dirs["dp2tp2"], **run),
    }
    return helpers.run_ranks("torch_tp_helpers:cases", 4, timeout=420.0,
                             calls={"train": ("train", dict(cases=cases))})


@functools.lru_cache(None)
def _jax_inference(name):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.parallel import mesh as mesh_lib
    jmodel, params, _, _ = _pair(name)
    try:
        eng = JaxEngine(jmodel, mp_size=2, dtype=jnp.float32,
                        model_parameters=params)
        assert eng.mesh.shape["tp"] == 2
        ids = _ids()
        return (np.asarray(eng.forward(ids)),
                np.asarray(eng.generate(ids, max_new_tokens=6,
                                        temperature=0.0)))
    finally:
        mesh_lib.reset_global_mesh()


@pytest.mark.parametrize("name", ["gpt2", "neox"])
def test_mp_size_2_matches_jax(two, name):
    logits, tokens = _jax_inference(name)
    _, _, cfg, state = _pair(name)
    for r, got in enumerate(two):
        res = got["inference"][name]
        np.testing.assert_allclose(res["logits"], logits, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(res["tokens"], tokens)
        np.testing.assert_allclose(res["shard_logits"], res["logits"],
                                   atol=1e-5, rtol=0)
        assert res["heads"] == cfg.num_heads // 2
        # every split leaf holds half of its split dim
        for k, shape in res["shapes"].items():
            split = psh.tp_split(k, state[k].shape, 2)
            want = list(state[k].shape)
            if split is not None:
                want[split.dim] //= 2
            assert tuple(shape) == tuple(want), k
    assert np.array_equal(two[0]["inference"][name]["logits"],
                          two[1]["inference"][name]["logits"])


@pytest.mark.parametrize("name", ["gpt2", "neox"])
def test_int8_shards_are_slices_of_jax_quantize_tree(two, name):
    from deepspeed_tpu.ops.quantizer import quantize_tree
    jmodel, params, cfg, _ = _pair(name)
    qtree = quantize_tree(params)
    codes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            qtree, is_leaf=lambda x: isinstance(x, dict) and "q8" in x)[0]:
        if isinstance(leaf, dict) and "q8" in leaf:
            codes[jax.tree_util.keystr(path)] = leaf
    leaves = gpt_flax_leaves(cfg)
    n = 0
    for r, got in enumerate(two):
        for key, arr in got["inference"][name]["int8"].items():
            mod, buf = key.rsplit(".", 1)
            leaf = leaves[f"{mod}.weight"]
            q = codes["".join(f"['{p}']" for p in leaf.path.split("/"))]
            whole = np.asarray(q[buf])
            if buf == "q8" and leaf.layer is not None:
                whole = whole[:, leaf.layer]            # [out, L, in]
            split = psh.tp_split(key, whole.shape, 2)
            want = whole if split is None else \
                split.take(torch.from_numpy(whole.copy()), r).numpy()
            np.testing.assert_array_equal(arr, want, key)
            n += 1
    assert n
    # and the int8 model's logits are the TPU engine's over the
    # dequantized tree
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.parallel import mesh as mesh_lib
    try:
        ref = np.asarray(JaxEngine(jmodel, mp_size=2, dtype=jnp.float32,
                                   model_parameters=params,
                                   quantize_bits=8).forward(_ids()))
    finally:
        mesh_lib.reset_global_mesh()
    for got in two:
        np.testing.assert_allclose(got["inference"][name]["int8_logits"],
                                   ref, atol=1e-4, rtol=0)


def test_bert_auto_tp_int8_matches_jax(two):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.parallel import mesh as mesh_lib
    jmodel, params, _, _, (ids, types, mask) = _bert()
    try:
        eng = JaxEngine(jmodel, mp_size=2, dtype=jnp.float32,
                        model_parameters=params, quantize_bits=8,
                        replace_method="auto")
        seq, pooled = eng.forward(jnp.asarray(ids),
                                  token_type_ids=jnp.asarray(types),
                                  attention_mask=jnp.asarray(mask))
    finally:
        mesh_lib.reset_global_mesh()
    live = mask.astype(bool)
    for got in two:
        b = got["inference"]["bert"]
        np.testing.assert_allclose(b["seq"][live], np.asarray(seq)[live],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(b["pooled"], np.asarray(pooled),
                                   atol=1e-4, rtol=0)
        kinds = b["kinds"]
        assert kinds["blocks.0.attn.qkv"] == "column"
        assert kinds["blocks.0.attn.out_proj"] == "row"
        assert kinds["blocks.0.up_proj"] == "column"
        assert kinds["blocks.0.down_proj"] == "row"
        assert kinds["wte"] == kinds["wtt"] == "feature"
        assert "pooler" not in kinds
        assert b["int8"]["blocks.0.attn.qkv.q8"].shape[0] == 3 * 64 // 2


def test_tp_overlap_and_ring_allreduce(two):
    for got in two:
        o = got["overlap"]
        for paged in (False, True):
            assert o[(True, paged)] == o[(False, paged)]
        assert o[(False, True)] == o[(False, False)]
        np.testing.assert_array_equal(o["ring"], o["all_reduce"])
        np.testing.assert_array_equal(o["deferred"], o["summed"])
        assert "rows % ring == 0" in o["guard"]
    for key in ((False, False), (False, True), (True, False), (True, True)):
        assert two[0]["overlap"][key] == two[1]["overlap"][key]


@functools.lru_cache(None)
def _jax_train():
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    from deepspeed_tpu.parallel import mesh as mesh_lib
    jmodel, params, cfg, _ = _pair("neox")
    eng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=2,
                    mesh={"tp": 2}))
    try:
        assert (eng.dp_world_size, eng.mesh.shape["tp"]) == (4, 2)
        micros = _micros()
        losses, norms = [], []
        for step in range(STEPS):
            batch = [{k: jnp.asarray(v) for k, v in m.items()}
                     for m in micros[GAS * step:GAS * (step + 1)]]
            losses.append(float(eng.train_batch(iter(batch))))
            norms.append(float(eng.get_global_grad_norm()))
        master = _state_dict_np(eng.state["master"], cfg)
    finally:
        mesh_lib.reset_global_mesh()
    return {"losses": losses, "norms": norms, "master": master}


@pytest.mark.parametrize("case", ["tp2", "tp2_stage0", "tp2_stage2",
                                  "dp2tp2", "dp2tp2_stage2"])
def test_training_at_tp_matches_jax(two, four, case):
    want = _jax_train()
    ranks = four if case.startswith("dp2") else two
    for got in ranks:
        run = got["train"][case]
        assert (run["tp"], run["dp"]) == (2, 2 if case.startswith("dp2")
                                          else 1)
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=TP_RTOL)
        np.testing.assert_allclose(run["norms"], want["norms"],
                                   rtol=TP_RTOL)
        helpers.close_masters(run["master"], want["master"])
        # each rank holds its shard of the split leaves
        assert run["held"]["blocks.0.mlp.up_proj.weight"][0] == \
            TINY["d_ff"] // 2
        assert run["held"]["lm_head.weight"][0] == TINY["vocab_size"] // 2
    base = two[0]["train"]["tp1_dp2"]
    np.testing.assert_allclose(ranks[0]["train"][case]["losses"],
                               base["losses"], rtol=TP_RTOL)


def test_partition_activations_halves_the_saved_input(two):
    B, S, D = GLOBAL_MICRO, 32, TINY["d_model"]
    L = TINY["num_layers"]
    for got in two:
        on, off = got["train"]["pa_on"], got["train"]["pa_off"]
        rows = [b for shape, b in on["saved"] if shape == (B, S // 2, D)]
        assert len(rows) == L
        # a rank keeps half the bytes a whole block input takes
        assert sum(rows) * 2 == L * B * S * D * 4
        assert not [s for s, _ in off["saved"] if s == (B, S // 2, D)]
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-6)
        np.testing.assert_allclose(on["norms"], off["norms"], rtol=1e-5)
        assert on["first_loss"] == pytest.approx(off["first_loss"], rel=1e-6)
        assert np.isfinite(got["train"]["pa_odd"]["losses"]).all()


def test_checkpoint_saved_at_tp2_resumes_at_tp2_and_tp1(two, four, tmp_dirs,
                                                        tmp_path):
    for got in two:
        np.testing.assert_allclose(got["train"]["cont"]["losses"],
                                   got["train"]["save"]["after_save"],
                                   rtol=1e-6)
    # dp 2 x tp 2's host-sharded files load at tp 1 on one rank
    model = GPT(GPTConfig(dtype=torch.float32, **_model_kw("neox")))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _pair("neox")[3].items()})
    engine = helpers.port_engine(model, _config(1, 1))
    engine.load_checkpoint(tmp_dirs["dp2tp2"])
    micros = _micros()[STEPS * GAS:]
    losses, _ = helpers.train(engine, micros, 2, GAS)
    np.testing.assert_allclose(losses, four[0]["train"]["save"]["after_save"],
                               rtol=TP_RTOL)
    # zero_to_fp32 merges the dp slices of the whole (tp-merged) leaves
    tag = sorted(d for d in os.listdir(tmp_dirs["dp2tp2"])
                 if d.startswith("global_step"))[0]
    out = str(tmp_path / "fp32.npz")
    subprocess.run([sys.executable, os.path.join(
        tmp_dirs["dp2tp2"], tag, "zero_to_fp32.py"), tmp_dirs["dp2tp2"],
        out], check=True, capture_output=True)
    merged = dict(np.load(out))
    master = four[0]["train"]["save"]["master"]
    for k, v in master.items():
        np.testing.assert_array_equal(merged[k], v, k)


def test_refusals_left_at_tp2(two):
    train = two[0]["train"]
    assert "ZeRO-3 with mesh tp=2" in train["zero3"]
    assert "ROADMAP A9" in train["zero3"]
    assert "offload_optimizer with mesh tp=2" in train["offload"]
    assert "a pp mesh" in train["pipeline"]
