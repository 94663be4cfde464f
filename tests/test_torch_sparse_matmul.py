"""The port's block-sparse ``MatMul``, the rest of ``SparseAttentionUtils``
and ``ops/op_builder.py`` against the JAX package on the CPU.

``MatMul`` (``deepspeed_tpu_torch/ops/sparse_attention/matmul.py``) in the
modes sdd, dsd and dds with every transpose flag the dense side takes, over
a random multi-head layout, against the JAX ``MatMul`` on the same numpy
operands (f32, rtol 1e-5 / atol 1e-5: one product of 16-32 terms a block,
summed over at most 4 blocks a row, in XLA's and torch's orders); ``pack``
and ``unpack`` bitwise (pure data movement); a one-head operand broadcast
over the layout's heads; the refusals. ``extend_position_embedding``
bitwise, ``sparse_gpt_config`` field by field against the JAX config
(its sparsity config by the layout it makes).
``available_builders()`` has exactly the JAX map's names; the host builders
load the port's native library, the device builders raise without a card
(never a plain version), and ``quantizer`` loads the port's module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_test_threads import one_torch_thread  # noqa: F401

BLOCK = 8
H, MB, KB, NB, BATCH = 3, 4, 2, 5, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _layout(seed, shape):
    rng = np.random.default_rng(seed)
    layout = (rng.random(shape) < 0.5).astype(np.int64)
    layout[0, 0, 0] = 1                   # never empty
    return layout


def _pair(mode, trans_a=False, trans_b=False, seed=0):
    from deepspeed_tpu.ops.sparse_attention import MatMul as JMatMul
    from deepspeed_tpu_torch.ops.sparse_attention import MatMul
    shape = (H, MB, NB) if mode == "sdd" else (
        (H, MB, KB) if mode == "dsd" else (H, KB, NB))
    layout = _layout(seed, shape)
    return (JMatMul(layout, BLOCK, mode, trans_a, trans_b),
            MatMul(layout, BLOCK, mode, trans_a, trans_b))


def _both(jop, op, a, b):
    want = np.asarray(jop(jnp.asarray(a), jnp.asarray(b)))
    got = op(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return got, want


def _dense(rng, shape, trans):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.ascontiguousarray(np.swapaxes(x, -1, -2)) if trans else x


@pytest.mark.parametrize("heads", [H, 1])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_sdd_matches_jax(trans_a, trans_b, heads):
    jop, op = _pair("sdd", trans_a, trans_b, seed=1)
    rng = np.random.default_rng(2)
    k = 16
    a = _dense(rng, (BATCH, heads, MB * BLOCK, k), trans_a)
    b = _dense(rng, (BATCH, heads, k, NB * BLOCK), trans_b)
    got, want = _both(jop, op, a, b)
    assert got.shape == (BATCH, op.nnz, BLOCK, BLOCK)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [H, 1])
@pytest.mark.parametrize("trans_b", [False, True])
def test_dsd_matches_jax(trans_b, heads):
    jop, op = _pair("dsd", trans_b=trans_b, seed=3)
    rng = np.random.default_rng(4)
    n = 12
    a = rng.standard_normal((BATCH, op.nnz, BLOCK, BLOCK)).astype(np.float32)
    b = _dense(rng, (BATCH, heads, KB * BLOCK, n), trans_b)
    got, want = _both(jop, op, a, b)
    assert got.shape == (BATCH, H, MB * BLOCK, n)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [H, 1])
@pytest.mark.parametrize("trans_a", [False, True])
def test_dds_matches_jax(trans_a, heads):
    jop, op = _pair("dds", trans_a=trans_a, seed=5)
    rng = np.random.default_rng(6)
    m = 10
    a = _dense(rng, (BATCH, heads, m, KB * BLOCK), trans_a)
    b = rng.standard_normal((BATCH, op.nnz, BLOCK, BLOCK)).astype(np.float32)
    got, want = _both(jop, op, a, b)
    assert got.shape == (BATCH, H, m, NB * BLOCK)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [H, 1])
def test_pack_unpack_match_jax(heads):
    jop, op = _pair("sdd", seed=7)
    rng = np.random.default_rng(8)
    dense = rng.standard_normal((BATCH, heads, MB * BLOCK, NB * BLOCK)
                                ).astype(np.float32)
    packed = op.pack(torch.from_numpy(dense))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jop.pack(jnp.asarray(dense))))
    back = op.unpack(packed)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jop.unpack(jnp.asarray(
                                      packed.numpy()))))
    # unpack zeros the empty blocks and keeps the live ones
    mask = np.kron(op.layout, np.ones((BLOCK, BLOCK), bool))[None]
    full = np.broadcast_to(dense, back.shape)
    np.testing.assert_array_equal(back.numpy(), np.where(mask, full, 0))
    assert op.unpack(packed, torch.float64).dtype == torch.float64


def test_sdd_dsd_compose_to_the_masked_dense_product():
    """sdd then dsd is the dense product through the layout's mask: the
    block-sparse attention pattern A = mask(Q K^T), A V."""
    from deepspeed_tpu_torch.ops.sparse_attention import MatMul
    layout = _layout(9, (H, MB, MB))
    sdd = MatMul(layout, BLOCK, "sdd", trans_b=True)
    dsd = MatMul(layout, BLOCK, "dsd")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(BATCH, H, MB * BLOCK, 16, generator=g,
                           dtype=torch.float64) for _ in range(3))
    mask = torch.from_numpy(np.kron(layout, np.ones((BLOCK, BLOCK))))
    want = ((q @ k.transpose(-1, -2)) * mask) @ v
    torch.testing.assert_close(dsd(sdd(q, k), v), want, rtol=1e-12,
                               atol=1e-12)


def test_refusals_match_jax():
    from deepspeed_tpu.ops.sparse_attention import MatMul as JMatMul
    from deepspeed_tpu_torch.ops.sparse_attention import MatMul
    layout = _layout(0, (H, MB, KB))
    for cls in (JMatMul, MatMul):
        with pytest.raises(NotImplementedError, match="PACKED"):
            cls(layout, BLOCK, "dsd", trans_a=True)
        with pytest.raises(NotImplementedError, match="PACKED"):
            cls(layout, BLOCK, "dds", trans_b=True)
        with pytest.raises(ValueError, match="mode"):
            cls(layout, BLOCK, "ddd")
        with pytest.raises(ValueError, match="no nonzero"):
            cls(np.zeros((1, 2, 2)), BLOCK, "sdd")
        with pytest.raises(ValueError, match="must be"):
            cls(np.ones((2, 2)), BLOCK, "sdd")
    op = MatMul(layout, BLOCK, "dsd")
    with pytest.raises(ValueError, match="blocks"):
        op(torch.zeros(1, op.nnz + 1, BLOCK, BLOCK),
           torch.zeros(1, H, KB * BLOCK, 4))
    with pytest.raises(ValueError, match="does not match"):
        op(torch.zeros(1, op.nnz, BLOCK, BLOCK),
           torch.zeros(1, H, KB * BLOCK + 1, 4))
    with pytest.raises(ValueError, match="heads"):
        op(torch.zeros(1, op.nnz, BLOCK, BLOCK),
           torch.zeros(1, 2, KB * BLOCK, 4))


@pytest.mark.parametrize("max_position", [5, 16, 40, 47])
def test_extend_position_embedding_matches_jax(max_position):
    from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
        SparseAttentionUtils as J
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
    wpe = np.random.default_rng(max_position).standard_normal(
        (16, 6)).astype(np.float32)
    got = SparseAttentionUtils.extend_position_embedding(
        torch.from_numpy(wpe), max_position)
    want = np.asarray(J.extend_position_embedding(jnp.asarray(wpe),
                                                  max_position))
    assert got.shape == (max_position, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_gpt_config_matches_jax():
    from deepspeed_tpu.models.gpt import GPTConfig as JConfig
    from deepspeed_tpu.ops.sparse_attention import \
        BigBirdSparsityConfig as JBigBird
    from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
        SparseAttentionUtils as J
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseAttentionUtils)
    kw = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
              d_model=32, d_ff=64)
    jcfg = J.sparse_gpt_config(JConfig(**kw), JBigBird(num_heads=2,
                                                       block=16))
    cfg = SparseAttentionUtils.sparse_gpt_config(
        GPTConfig(**kw), BigBirdSparsityConfig(num_heads=2, block=16))
    assert isinstance(cfg, GPTConfig)
    assert cfg.attention_impl == jcfg.attention_impl == "sparse"
    np.testing.assert_array_equal(
        cfg.sparse_attention.make_layout(64),
        np.asarray(jcfg.sparse_attention.make_layout(64)))
    for f in kw:
        assert getattr(cfg, f) == getattr(jcfg, f)
    ids = torch.randint(0, 64, (1, 64), generator=torch.Generator()
                        .manual_seed(0))
    assert GPT(cfg)(ids).shape == (1, 64, 64)


def test_available_builders_match_jax():
    from deepspeed_tpu.ops import op_builder as jb
    from deepspeed_tpu_torch.ops import op_builder as pb
    builders = pb.available_builders()
    assert sorted(builders) == sorted(jb.available_builders())
    assert pb.is_compatible()
    for name in ("cpu_adam", "cpu_adagrad", "async_io"):
        assert builders[name].is_compatible(), name
        lib = builders[name].load()
        assert all(hasattr(lib, s) for s in builders[name].symbols)
    from deepspeed_tpu_torch.ops import quantizer
    assert builders["quantizer"].is_compatible()
    assert builders["quantizer"].load() is quantizer
    report = pb.build_report()
    assert "native ops" in report and "cuda kernels" in report
    if torch.cuda.is_available():
        return
    assert "UNAVAILABLE" in report.splitlines()[1]
    for name in ("flash_attn", "fused_layer_norm", "fused_softmax",
                 "fused_gelu", "sparse_attn"):
        assert not builders[name].is_compatible(), name
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builders[name].load()
