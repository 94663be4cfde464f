"""The port's block-sparse attention on the CPU against the TPU package's,
f32, inputs from numpy seeds:

  * layouts: every SparsityConfig class of the port builds the JAX
    package's layout bit for bit (seq lens, per-head layouts, both attention
    modes), and refuses what the JAX class refuses with the same message;
  * the layout compiler: LUT counts and masks against the fine layout,
    block sizes 8 to 128, S not a multiple of the 64-row tile;
  * forward: the plain version (through ``sparse_attention``) against the
    JAX ``sparse_attention`` (Pallas in interpret mode) and its lse, for
    Fixed, BigBird, BSLongformer and Variable layouts, one and several
    tiles, causal forced on a bidirectional layout (atol/rtol 2e-4, as in
    tests/test_sparse_attention.py);
  * key padding with dead query rows and a key tile no query reaches;
  * grads of the ``SparseAttention`` autograd function against
    ``jax.grad`` (1e-3), dv exactly 0 at masked keys;
  * CPU tensors never reach the kernels; the 16-bit forward and dq get
    the same work list.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention.sparsity_config as jsc
import deepspeed_tpu_torch.ops.sparse_attention.sparsity_config as psc
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jax_sparse
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import sparse_attention as psa
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    DKV_CHUNK, compiled_layout)
from torch_test_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-4
GRAD_TOL = 1e-3

# --------------------------------------------------------------- layouts

LAYOUT_CLASSES = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", dict(num_local_blocks=4,
                                          num_global_blocks=1)),
    "fixed_patterns": ("FixedSparsityConfig", dict(
        num_local_blocks=4, num_global_blocks=2,
        num_different_global_patterns=2)),
    "fixed_horizontal": ("FixedSparsityConfig", dict(
        num_local_blocks=3, horizontal_global_attention=True)),
    "variable": ("VariableSparsityConfig", dict(
        num_random_blocks=2, local_window_blocks=[2, 3],
        global_block_indices=[0, 5])),
    "variable_ranges": ("VariableSparsityConfig", dict(
        num_random_blocks=1, global_block_indices=[1, 6],
        global_block_end_indices=[3, 8], horizontal_global_attention=True)),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=3)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(
        num_sliding_window_blocks=5, global_block_indices=[0, 7])),
    "bslongformer_ranges": ("BSLongformerSparsityConfig", dict(
        global_block_indices=[2], global_block_end_indices=[4])),
}


def _both(name, **extra):
    cls, kw = LAYOUT_CLASSES[name]
    kw = dict(kw, **extra)
    return getattr(jsc, cls), getattr(psc, cls), kw


@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUT_CLASSES))
def test_layouts_equal_jax_bit_for_bit(name, per_head, attention):
    jcls, pcls, kw = _both(name, num_heads=4, block=16,
                           different_layout_per_head=per_head)
    if name != "dense":
        kw["attention"] = attention
    try:
        jcfg = jcls(**kw)
    except ValueError as err:
        with pytest.raises(ValueError) as perr:
            pcls(**kw)
        assert str(perr.value) == str(err)
        return
    pcfg = pcls(**kw)
    for seq in (16 * 9, 16 * 16, 16 * 37):
        want = jcfg.make_layout(seq)
        got = pcfg.make_layout(seq)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError) as jerr:
        jcfg.make_layout(16 * 9 + 1)
    with pytest.raises(ValueError) as perr:
        pcfg.make_layout(16 * 9 + 1)
    assert str(perr.value) == str(jerr.value)


def test_bench_layout_equals_jax_at_seq_32k():
    """bench.py's long-context layout (BigBird, block 64, 3 random blocks)
    at S = 32768: equal, and compiled to the expected tile LUTs."""
    kw = dict(num_heads=12, block=64, different_layout_per_head=False,
              num_random_blocks=3, num_sliding_window_blocks=3,
              num_global_blocks=1)
    want = jsc.BigBirdSparsityConfig(**kw).make_layout(32768)
    pcfg = psc.BigBirdSparsityConfig(**kw)
    np.testing.assert_array_equal(pcfg.make_layout(32768), want)
    lay = compiled_layout(pcfg, 32768, causal=True)
    causal = np.tril(want[0]).astype(bool)
    np.testing.assert_array_equal(lay.cnt_k[0], causal.sum(1))
    np.testing.assert_array_equal(lay.cnt_q[0], causal.sum(0))
    assert lay.cnt_q[0, 0] == 512            # the global column
    live = np.arange(lay.lut_k.shape[-1]) < lay.cnt_k[..., None]
    assert (lay.bits_k[live] == 1).all()     # block 64: one bit per tile
    # the dk/dv kernel's items cover every column-LUT entry once; only the
    # global key tile of each head is split (over 512 / DKV_CHUNK items of
    # DKV_CHUNK entries), each split item with a workspace partial of its own
    split = 512 // DKV_CHUNK
    covered = np.zeros_like(lay.cnt_q)
    partials = []
    for h, kt, t0, t1, first, rank, n in lay.dkv_items:
        covered[h, kt] += t1 - t0
        assert (first >= 0) == (kt == 0) and n == (split if kt == 0 else 1)
        assert 0 <= rank < n and t0 == DKV_CHUNK * rank
        if first >= 0:
            assert first % split == 0
            partials.append(first + rank)
    np.testing.assert_array_equal(covered, lay.cnt_q)
    assert sorted(partials) == list(range(12 * split))
    assert lay.dkv_parts == 12 * split and (
        lay.dkv_items[:, 3] - lay.dkv_items[:, 2]).max() == DKV_CHUNK


@pytest.mark.parametrize("block,seq,causal", [
    (8, 96, False), (16, 112, True), (32, 192, False), (64, 256, True),
    (128, 512, True), (128, 384, False)])
def test_compiled_luts_cover_the_fine_layout(block, seq, causal):
    """Expanding each LUT entry's mask back to cells gives the fine layout
    (tril-ified when causal) cell for cell, for the row and column LUTs."""
    cfg = psc.BigBirdSparsityConfig(num_heads=2, block=block,
                                    different_layout_per_head=True,
                                    num_random_blocks=1)
    fine = cfg.make_layout(seq).astype(bool)
    if causal:
        fine &= np.tril(np.ones(fine.shape[1:], bool))
    cells = fine.repeat(block, 1).repeat(block, 2)
    lay = compiled_layout(cfg, seq, causal)
    nt = -(-seq // 64)
    sh = lay.shift
    r = np.arange(64)
    bit = (r[:, None] >> sh) * (64 >> sh) + (r[None, :] >> sh)
    for lut, cnt, bits, rows_are_q in ((lay.lut_k, lay.cnt_k, lay.bits_k,
                                        True),
                                       (lay.lut_q, lay.cnt_q, lay.bits_q,
                                        False)):
        got = np.zeros((2, nt * 64, nt * 64), bool)
        for h in range(2):
            for i in range(nt):
                for t in range(cnt[h, i]):
                    j = lut[h, i, t]
                    m = (bits[h, i, t].astype(np.uint64)
                         >> bit.astype(np.uint64)) & np.uint64(1)
                    qi, kj = (i, j) if rows_are_q else (j, i)
                    got[h, qi * 64:qi * 64 + 64, kj * 64:kj * 64 + 64] |= \
                        m.astype(bool)
        keep = got[:, :seq, :seq]
        if causal:       # the kernels mask above the diagonal elementwise
            tri = np.tril(np.ones((seq, seq), bool))
            keep, want = keep & tri, cells & tri
        else:
            want = cells
        np.testing.assert_array_equal(keep, want)


# the backward kernels' host schedule: the bench layout at S = 32768 and
# small layouts (blocks 16, 64, 128; causal and not; S a whole number of
# 64-row tiles or not) whose global blocks give column (and, bidirectional,
# row) LUTs longer than DKV_CHUNK
SCHEDULE_CASES = {
    "bench_32k": dict(block=64, seq=32768, causal=True, heads=12,
                      num_random_blocks=3, num_sliding_window_blocks=3,
                      num_global_blocks=1, different_layout_per_head=False),
    "b16_causal_ragged": dict(block=16, seq=16 * 161, causal=True),
    "b16_bidirectional": dict(block=16, seq=16 * 160, causal=False),
    "b64_causal": dict(block=64, seq=64 * 40, causal=True),
    "b64_bidirectional_ragged": dict(block=64, seq=64 * 39, causal=False),
    "b128_causal": dict(block=128, seq=128 * 20, causal=True),
    "b128_bidirectional": dict(block=128, seq=128 * 21, causal=False),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_backward_work_lists_cover_the_luts_longest_first(case):
    """The dq kernel's work list and the dk/dv kernel's items: every live
    row-LUT and column-LUT entry visited exactly once, the longest items
    first, and a split key tile's items with contiguous ranks over
    contiguous runs of its LUT row and workspace slots of their own."""
    kw = dict(SCHEDULE_CASES[case])
    block, seq, causal = kw.pop("block"), kw.pop("seq"), kw.pop("causal")
    kw.setdefault("num_random_blocks", 1)
    kw.setdefault("different_layout_per_head", True)
    cfg = psc.BigBirdSparsityConfig(num_heads=kw.pop("heads", 2),
                                    block=block, **kw)
    lay = compiled_layout(cfg, seq, causal)
    h, nt = lay.cnt_k.shape
    # dq: each (head, query tile) once (an item walks its whole row LUT),
    # row lengths non-increasing, ties in (head, tile) order
    dq = lay.dq_items
    assert dq.dtype == np.int32 and dq.shape == (h * nt, 2)
    assert sorted(map(tuple, dq.tolist())) == [(i, j) for i in range(h)
                                               for j in range(nt)]
    lengths = lay.cnt_k[dq[:, 0], dq[:, 1]]
    assert (np.diff(lengths) <= 0).all()
    flat = dq[:, 0] * nt + dq[:, 1]
    for n in np.unique(lengths):
        assert (np.diff(flat[lengths == n]) > 0).all()
    # dk/dv: runs [t0, t1) of each column-LUT row, disjoint and covering it
    items = lay.dkv_items
    assert items.dtype == np.int32 and items.shape[1] == 7
    runs = np.asarray(items[:, 3] - items[:, 2])
    assert (np.diff(runs) <= 0).all() and runs.max() <= DKV_CHUNK
    seen = {}
    for hh, kt, t0, t1, first, rank, n in items.tolist():
        seen.setdefault((hh, kt), []).append((rank, t0, t1, first, n))
    assert sorted(seen) == [(i, j) for i in range(h) for j in range(nt)]
    slots = []
    for (hh, kt), parts in seen.items():
        parts.sort()
        count = int(lay.cnt_q[hh, kt])
        n = parts[0][4]
        assert [p[0] for p in parts] == list(range(n))         # ranks
        assert all(p[4] == n for p in parts)
        assert [p[1] for p in parts] == [r * DKV_CHUNK for r in range(n)]
        assert [p[2] for p in parts] == [min(count, (r + 1) * DKV_CHUNK)
                                         for r in range(n)]
        assert n == max(1, -(-count // DKV_CHUNK))
        firsts = {p[3] for p in parts}
        assert len(firsts) == 1
        if n == 1:
            assert firsts == {-1}
        else:
            slots += [parts[0][3] + r for r in range(n)]
    assert sorted(slots) == list(range(lay.dkv_parts))
    if case == "bench_32k":
        assert lay.dkv_parts == 12 * (512 // DKV_CHUNK)
    else:
        assert lay.dkv_parts > 0         # some column LUT is split


class _Pointer:
    """Stands in for the work list on the card: its address and shape."""

    def __init__(self, items):
        self.shape = items.shape

    def data_ptr(self):
        return 0xD0D0


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_forward_walks_the_dq_work_list(case, monkeypatch):
    """The 16-bit forward walks the dq kernel's work list: the wrappers hand
    both C entries the same row LUT and ``dq_items`` (its address and
    length), each call as long as its ctypes signature. Recorded through a
    stand-in library on meta tensors, so no kernel runs."""
    kw = dict(SCHEDULE_CASES[case])
    block, seq, causal = kw.pop("block"), kw.pop("seq"), kw.pop("causal")
    kw.setdefault("num_random_blocks", 1)
    kw.setdefault("different_layout_per_head", True)
    heads = kw.pop("heads", 2)
    cfg = psc.BigBirdSparsityConfig(num_heads=heads, block=block, **kw)
    lay = compiled_layout(cfg, seq, causal)
    layout = lay.on("meta")
    layout = layout._replace(dq_items=_Pointer(layout.dq_items))
    calls = {}

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls[name] = args
                return 0
            return record

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    q, k, v, do = (torch.empty(1, seq, heads, 64, dtype=torch.bfloat16,
                               device="meta") for _ in range(4))
    out, lse = psa.sparse_attention_forward(q, k, v, layout, 0.125)
    psa.sparse_attention_backward(q, k, v, out, lse, do, layout, 0.125)
    fwd, dq = calls["dstorch_sparse_fwd"], calls["dstorch_sparse_bwd_dq"]
    for name in ("dstorch_sparse_fwd", "dstorch_sparse_bwd_dq",
                 "dstorch_sparse_bwd_dkv"):
        assert len(calls[name]) == len(_build._SIGNATURES[name])
    # lut_idx, lut_cnt, lut_bits, lut_len, shift, items, n_items
    assert fwd[6:13] == dq[8:15]
    assert fwd[9:13] == (lay.lut_k.shape[-1], lay.shift, 0xD0D0,
                         lay.dq_items.shape[0])


def test_layout_block_the_kernels_lack_raises():
    cfg = psc.DenseSparsityConfig(num_heads=1, block=24)
    with pytest.raises(ValueError, match="power of two"):
        sparse_attention(*(torch.zeros(1, 48, 1, 32) for _ in range(3)), cfg)


# --------------------------------------------------------------- kernels

def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]                  # q, k, v, cotangent


FWD_CASES = {
    "fixed_bidirectional": (("fixed", dict(num_heads=2, block=16)),
                            (1, 128, 2, 16), None),
    "fixed_unidirectional": (("fixed", dict(num_heads=2, block=16,
                                            attention="unidirectional")),
                             (1, 128, 2, 16), None),
    "bigbird": (("bigbird", dict(num_heads=2, block=16,
                                 num_random_blocks=1)), (2, 128, 2, 16),
                None),
    "bigbird_forced_causal": (("bigbird", dict(num_heads=2, block=16)),
                              (1, 128, 2, 32), True),
    "bigbird_per_head_block32": (("bigbird", dict(
        num_heads=3, block=32, different_layout_per_head=True,
        num_random_blocks=1)), (1, 192, 3, 32), None),
    "bslongformer": (("bslongformer", dict(num_heads=2, block=16)),
                     (1, 128, 2, 16), None),
    "bslongformer_block128_causal": (("bslongformer", dict(
        num_heads=2, block=128, num_sliding_window_blocks=1)),
        (1, 256, 2, 32), True),
    "multi_tile_s256": (("fixed", dict(num_heads=2, block=16)),
                        (1, 256, 2, 32), None),
    "variable_block8": (("variable", dict(num_heads=2, block=8)),
                        (1, 96, 2, 16), None),
}


def _jax_fwd(jcfg, q, k, v, causal, kvm=None):
    """The JAX forward's out and lse through its own residuals."""
    from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as j
    out = jax_sparse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                     causal=causal, key_padding_mask=kvm)
    c = (jcfg.attention == "unidirectional") if causal is None else causal
    layout = jcfg._layout_cache[(q.shape[1], bool(c))]
    _, (_, _, _, _, lse) = j._sparse_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout, bool(c),
        1.0 / np.sqrt(q.shape[-1]),
        None if kvm is None else jnp.asarray(kvm))
    return np.asarray(out), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_jax(case):
    (name, kw), shape, causal = FWD_CASES[case]
    jcls, pcls, kw = _both(name, **kw)
    q, k, v, _ = _qkv(*shape, seed=len(case))
    want, want_lse = _jax_fwd(jcls(**kw), q, k, v, causal)
    pcfg = pcls(**kw)
    got = sparse_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), pcfg, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    c = (pcfg.attention == "unidirectional") if causal is None else causal
    _, lse = psa.sparse_attention_forward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        compiled_layout(pcfg, shape[1], c).on("cpu"), 1 / np.sqrt(shape[3]))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FWD_TOL,
                               atol=FWD_TOL)


class _FixedLayout:
    """A duck-typed SparsityConfig returning a given layout (both packages
    read only ``make_layout``, ``block`` and ``attention``)."""

    def __init__(self, layout, block, attention="bidirectional"):
        self.layout, self.block, self.attention = layout, block, attention

    def make_layout(self, seq_len):
        return self.layout.copy()


def _holey_layout(h=2, nb=8):
    """Local windows of 2 blocks, no global block, and key blocks 4-7 seen
    by no query (block 16: key tile 1 has an empty column LUT)."""
    lay = np.zeros((h, nb, nb), np.int64)
    for i in range(nb):
        lay[:, i, (i // 2) * 2:(i // 2) * 2 + 2] = 1
    lay[:, :, 4:] = 0
    lay[:, :4, 0] = 1
    return lay


MASK_CASES = {
    # the shape of tests/test_bert_sparse.py::test_sparse_masked_grads_match_dense
    "dense_real33": (("dense", dict(num_heads=2, block=16)), 64),
    # local windows, no global: query blocks 4-5 see only masked keys
    "windows_dead_rows": (("variable", dict(
        num_heads=2, block=16, local_window_blocks=[2],
        global_block_indices=[], num_random_blocks=0)), 128),
    "empty_key_tile": (None, 128),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masked_forward_and_grads_match_jax(case):
    spec, s = MASK_CASES[case]
    b, h, d, real = 2, 2, 16, 33
    q, k, v, g = _qkv(b, s, h, d, seed=s + len(case))
    mask = np.ones((b, s), np.float32)
    mask[0, real:] = 0.0                      # row 1 is unpadded
    if spec is None:
        jcfg = _FixedLayout(_holey_layout(), 16)
        pcfg = _FixedLayout(_holey_layout(), 16)
    else:
        jcls, pcls, kw = _both(spec[0], **spec[1])
        jcfg, pcfg = jcls(**kw), pcls(**kw)
    scale = 1 / np.sqrt(d)

    def jloss(q, k, v):
        out = jax_sparse(q, k, v, jcfg, sm_scale=scale, causal=False,
                         key_padding_mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = sparse_attention(tq, tk, tv, pcfg, sm_scale=scale, causal=False,
                           key_padding_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        assert torch.isfinite(got).all(), f"d{name} not finite"
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    assert float(tv.grad[0, real:].abs().max()) == 0.0
    assert float(tk.grad[0, real:].abs().max()) == 0.0
    if case == "windows_dead_rows":           # dead rows: zeros out
        assert float(out.detach()[0, 64:96].abs().max()) == 0.0
    if case == "empty_key_tile":              # no query reaches keys 64..
        assert float(tv.grad[:, 64:].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["bigbird", "bslongformer_block128_causal",
                                  "multi_tile_s256", "variable_block8"])
def test_grads_match_jax(case):
    (name, kw), shape, causal = FWD_CASES[case]
    jcls, pcls, kw = _both(name, **kw)
    q, k, v, g = _qkv(*shape, seed=len(case) + 1)
    jcfg, pcfg = jcls(**kw), pcls(**kw)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jax_sparse(q, k, v, jcfg, causal=causal) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (sparse_attention(tq, tk, tv, pcfg, causal=causal)
     * torch.from_numpy(g)).sum().backward()
    for got, w, n in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{n}")


def test_qkv_views_and_head_mismatch():
    """q/k/v as views of one fused projection give the same result as
    contiguous copies; a layout with other heads than the tensors raises."""
    cfg = psc.BigBirdSparsityConfig(num_heads=2, block=16)
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3 * 2 * 32))
                           .astype(np.float32))
    q, k, v = (t.view(2, 64, 2, 32) for t in qkv.split(64, -1))
    a = sparse_attention(q, k, v, cfg, causal=True)
    b = sparse_attention(q.contiguous(), k.contiguous(), v.contiguous(), cfg,
                         causal=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="heads"):
        sparse_attention(*(torch.zeros(1, 64, 3, 32) for _ in range(3)), cfg)
    with pytest.raises(ValueError, match="key_padding_mask"):
        sparse_attention(q, k, v, cfg, key_padding_mask=torch.ones(2, 63))


def test_cpu_tensors_never_reach_the_kernels():
    _build.reset_launch_counts()
    cfg = psc.FixedSparsityConfig(num_heads=2, block=16)
    q = torch.randn(1, 128, 2, 32, requires_grad=True)
    sparse_attention(q, q, q, cfg, key_padding_mask=torch.ones(1, 128)
                     ).sum().backward()
    assert not any(_build.LAUNCHES[n] for n in
                   ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"))
    lay = compiled_layout(cfg, 128, False)
    assert lay.on("cpu") is lay.on(torch.device("cpu"))     # cached
