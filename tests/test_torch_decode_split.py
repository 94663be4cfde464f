"""The split-KV algebra of the decode kernels (B2, B3), on the CPU.

``csrc/decode_attention.cuh`` cuts each row's live key tiles into contiguous
ranges of whole tiles, one per block of a cluster, keeps an f32 partial
state (m, l, acc) per rank and merges the states in rank order. The plain
model of that algebra, ``decode_attention_split_reference``, is held here
against the TPU package's ``decode_attention`` (the Pallas kernel in
interpret mode) and against the port's plain version, over splits of 1, 2,
3 and 8 ranks (ranks with no tile, and ranks whose tiles a query cannot
see, included), s_q 1, 4 and 8, fills 0, 1, s_q - 1, a tile boundary and
one past it, S and the sentinel S + s_q, dense and paged (a permuted block
table, gathered by ``paged_gather_kv``) and int8. Tolerance: f32 on both
sides, atol 1e-5 (summation order differs). Where no key is seen the
output must be exactly zero, and nowhere NaN; the TPU kernels leave such a
query undefined, so they are compared where a query sees a key.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import quantizer as pqz
from deepspeed_tpu_torch.ops.cuda import decode_attention as pda
from torch_test_threads import one_torch_thread  # noqa: F401

B_ROWS, S, H, D = 7, 64, 2, 64
BS = 8                                    # paged block size
ATOL = 1e-5
SCALE = 0.125


def _fills(s_q, tile):
    return np.array([0, 1, max(s_q - 1, 0), tile, tile + 1, S, S + s_q],
                    np.int32)


@functools.lru_cache(maxsize=None)
def _inputs(s_q, tile):
    rng = np.random.default_rng(100 * s_q + tile)
    q = rng.standard_normal((B_ROWS, s_q, H, D)).astype(np.float32)
    k = rng.standard_normal((B_ROWS, S, H * D)).astype(np.float32)
    v = rng.standard_normal((B_ROWS, S, H * D)).astype(np.float32)
    return q, k, v, _fills(s_q, tile)


@functools.lru_cache(maxsize=None)
def _jax_dense(s_q, tile):
    q, k, v, fills = _inputs(s_q, tile)
    assert jda.pallas_decode_supported(B_ROWS, S, H, D, jnp.float32, s_q)
    return np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(fills),
        scale=SCALE))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _seen(fills, s_q):
    """[b, s_q] bool: whether query i of each row sees at least one key.
    The TPU kernels leave a query that sees none undefined (the serving
    engine discards it), so they are compared only where it sees one."""
    lim = np.minimum(fills, S)[:, None] - (s_q - 1) + np.arange(s_q)
    return lim > 0


def _close_where_seen(out, want, fills, s_q):
    seen = _seen(fills, s_q)
    np.testing.assert_allclose(out[seen], want[seen], rtol=0, atol=ATOL)


def _check_zeros_and_finite(out, fills, s_q):
    """Exact zeros for every query that sees no key, no NaN anywhere."""
    assert not np.isnan(out).any()
    seen = _seen(fills, s_q)
    assert np.all(out[~seen] == 0)
    assert np.all(np.any(out[seen] != 0, axis=(-2, -1)))


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("s_q", [1, 4, 8])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
def test_split_reference_matches_pallas_and_plain(n_split, s_q, tile):
    q, k, v, fills = _inputs(s_q, tile)
    out = pda.decode_attention_split_reference(
        _t(q), _t(k), _t(v), _t(fills), SCALE, n_split, tile).numpy()
    assert out.shape == (B_ROWS, s_q, H, D)
    _check_zeros_and_finite(out, fills, s_q)
    _close_where_seen(out, _jax_dense(s_q, tile), fills, s_q)
    plain = pda.decode_attention_reference(_t(q), _t(k), _t(v), _t(fills),
                                           SCALE).numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s_q", [1, 4, 8])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
def test_split_reference_over_a_permuted_paged_table(n_split, s_q):
    """The paged form: a pool whose blocks sit in a random order, read
    through the table by ``paged_gather_kv``; the TPU package's paged
    Pallas kernel (interpret mode) on the pool is the reference."""
    q, k, v, fills = _inputs(s_q, 32)
    T = S // BS
    rng = np.random.default_rng(7 + s_q)
    nb = B_ROWS * T + 3
    perm = rng.permutation(nb)[:B_ROWS * T].reshape(B_ROWS, T)
    kp = rng.standard_normal((nb, BS, H * D)).astype(np.float32)
    vp = rng.standard_normal((nb, BS, H * D)).astype(np.float32)
    kp[perm.reshape(-1)] = k.reshape(B_ROWS * T, BS, H * D)
    vp[perm.reshape(-1)] = v.reshape(B_ROWS * T, BS, H * D)
    tables = perm.astype(np.int32)
    kg = pda.paged_gather_kv(_t(kp), _t(tables))
    vg = pda.paged_gather_kv(_t(vp), _t(tables))
    assert torch.equal(kg, _t(k)) and torch.equal(vg, _t(v))
    out = pda.decode_attention_split_reference(
        _t(q), kg, vg, _t(fills), SCALE, n_split).numpy()
    _check_zeros_and_finite(out, fills, s_q)
    assert jda.paged_decode_supported(B_ROWS, BS, H, D, jnp.float32, s_q)
    want = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(fills), scale=SCALE,
        impl="pallas"))
    _close_where_seen(out, want, fills, s_q)


@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("n_split", [2, 8])
def test_split_reference_int8(n_split, s_q):
    """An int8 cache: keys and values times their position's f32 scale,
    against the TPU package's int8 Pallas kernel and the port's plain
    version (which dequantizes to q's dtype, here f32: the same values)."""
    q, k, v, fills = _inputs(s_q, 32)
    (kq, ks), (vq, vs) = (pqz.quantize_kv(_t(x)) for x in (k, v))
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    out = pda.decode_attention_split_reference(
        _t(q), kq, vq, _t(fills), SCALE, n_split, k_scale=ks,
        v_scale=vs).numpy()
    _check_zeros_and_finite(out, fills, s_q)
    plain = pda.decode_attention_reference(_t(q), kq, vq, _t(fills), SCALE,
                                           ks, vs).numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=ATOL)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(fills), scale=SCALE, k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy())))
    _close_where_seen(out, want, fills, s_q)


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
def test_split_plan_covers_the_fill_once_in_whole_tiles(n_split, tile):
    for fill in range(S + 1):
        ranges = pda.split_ranges(fill, n_split, tile)
        assert len(ranges) == n_split
        covered = []
        prev_stop = 0
        for start, stop in ranges:
            assert start == prev_stop and start <= stop   # contiguous
            assert start % tile == 0                      # whole tiles
            assert stop % tile == 0 or stop == fill
            covered.extend(range(start, stop))
            prev_stop = stop
        assert covered == list(range(fill))               # exactly once


def test_split_count_is_chosen_from_S_only():
    assert pda.SPLIT_TILE == 32 and pda.MAX_SPLIT == 8
    for S_, want in ((1, 1), (32, 1), (33, 2), (77, 3), (256, 8),
                     (1000, 8), (1024, 8), (32768, 8)):
        assert pda.split_count(S_) == want
