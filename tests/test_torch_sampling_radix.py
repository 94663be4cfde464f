"""The sampling kernel's radix descent (csrc/sampling.cu), modelled in numpy,
against the bisections of its plain version (ops/cuda/sampling.py, the TPU
kernel's 33-step searches): the same k-th key and the same top-p cut.

The model does what each cluster does, on one row: four rounds of 8-bit
digits of the unsigned order key, most significant first; a 256-bin
histogram of the live candidates (counts for top-k, probability mass for
top-p); the highest digit whose running total from the top reaches the
target. Top-p's mass is f64 here and in the bisection, so the comparison is
exact (the kernel sums fixed-point integers, exact too). Rows: seeded
normals, ties at the cut, negative logits and -0.0, k = 1 and k = V - 1,
all the mass on one token, and top-p after top-k."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import sampling as sp
from torch_test_threads import one_torch_thread  # noqa: F401

NEG_CAP = -1e10


def _unsigned(key):
    """The kernel's radix key: the signed order key with its sign bit
    flipped, as an unsigned 32-bit integer (same order)."""
    return (np.asarray(key, np.int64) + 2 ** 31).astype(np.uint64)


def _descend(u, weight, need):
    """The highest value t (built digit by digit) with total weight of the
    live keys >= t reaching ``need``: t is a present key."""
    prefix, mask, above = 0, 0, 0
    for r in range(4):
        shift = 24 - 8 * r
        live = (u & np.uint64(mask)) == np.uint64(prefix)
        digits = ((u[live] >> np.uint64(shift)) & np.uint64(0xff)).astype(
            np.int64)
        hist = np.bincount(digits, weights=weight[live], minlength=256)
        run = above
        for d in range(255, -1, -1):        # from the top bin down
            if run + hist[d] >= need:
                break
            run += hist[d]
        else:
            raise AssertionError("no bin reached the target")
        above = run
        prefix |= d << shift
        mask |= 0xff << shift
    return prefix


def radix_kth_key(key, k):
    """The k-th largest signed order key of a row: count histograms."""
    u = _unsigned(key)
    t = _descend(u, np.ones(len(u)), k)
    return t - 2 ** 31


def radix_top_p_key(key, e, pz):
    """The largest present key K with mass(key >= K) >= pz, over the
    entries that carry mass (e > 0), f64 mass histograms."""
    live = e > 0
    u = _unsigned(key)[live]
    t = _descend(u, e[live], pz)
    return t - 2 ** 31


def _rows(seed, v=4096):
    rng = np.random.default_rng(seed)
    rows = {}
    rows["normal"] = rng.standard_normal(v) * 3
    x = rng.standard_normal(v) * 2
    x[rng.choice(v, 40, replace=False)] = np.sort(x)[-25]   # ties at a cut
    rows["ties"] = x
    x = -np.abs(rng.standard_normal(v)) * 4                  # all negative
    x[::7] = -0.0
    x[5] = 0.0
    rows["negative_zero"] = x
    x = rng.standard_normal(v) - 200.0
    x[17] = 5.0                                              # one token
    rows["one_token"] = x
    x = np.round(rng.standard_normal(v), 1)                  # many ties
    rows["coarse"] = x
    return {n: r.astype(np.float32) for n, r in rows.items()}


ROWS = _rows(0)


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("k", [1, 2, 25, 50, 1000, 4095])
def test_radix_kth_key_equals_bisection(name, k):
    x = torch.from_numpy(ROWS[name])[None]
    key = sp.order_key(x)
    ref = int(sp._bisect_kth_key(key, k)[0])
    assert radix_kth_key(key[0].numpy(), k) == ref


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("top_k,top_p", [(None, 0.9), (None, 0.5),
                                         (None, 0.99), (50, 0.9),
                                         (1, 0.9), (1000, 0.7),
                                         (4095, 0.95)])
def test_radix_top_p_cut_equals_bisection(name, top_k, top_p):
    x = torch.from_numpy(ROWS[name])[None]
    if top_k is not None:
        x = sp.filter_rows_reference(x, top_k, None)   # top-p after top-k
    key = sp.order_key(x)
    xd = x.double()
    e = torch.exp(xd - xd.max(dim=-1, keepdim=True).values)
    pz = top_p * e.sum(dim=-1)
    ref = int(sp._bisect_top_p_key(key, e, pz)[0])
    got = radix_top_p_key(key[0].numpy(), e[0].numpy(), float(pz[0]))
    assert got == ref


@pytest.mark.parametrize("name", sorted(ROWS))
def test_model_filter_equals_plain_top_k(name):
    """The filtered row built from the radix cut is bitwise the plain
    version's (ties at the cut kept), for k = 1, 50 and V - 1."""
    x = torch.from_numpy(ROWS[name])[None]
    key = sp.order_key(x)[0].numpy()
    for k in (1, 50, x.shape[-1] - 1):
        kth = radix_kth_key(key, k)
        got = np.where(key >= kth, ROWS[name], np.float32(NEG_CAP))
        ref = sp.filter_rows_reference(x, k, None)[0].numpy()
        np.testing.assert_array_equal(got, ref)
