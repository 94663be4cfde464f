"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips on a host without an NVIDIA GPU.
This file imports no JAX, so it runs on the card's machine without the
repo's JAX test setup:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 / fp16 inputs: the plain version rounds its probabilities to the
# input type, the kernel keeps them in f32; f32 inputs differ only in
# summation order
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DECODE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("s_q", [1, 3, 8])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_decode_attention_kernel_matches_plain(dev, dtype, s_q, d):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator(device=dev).manual_seed(s_q * 1000 + d)
    b, S, h = 5, 320, 4
    q = torch.randn(b, s_q, h, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    fills = torch.tensor([1, s_q, 33, S, S + 1], dtype=torch.int32,
                         device=dev)
    before = _build.LAUNCHES["decode_attention"]
    out = da.decode_attention(q, k, v, fills, scale=0.1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 1
    ref = da.decode_attention_reference(q, k, v, fills, 0.1)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[dtype])


def _pools(dev, dtype, b, T, bs, hd, g, extra=3):
    """A pool of b*T + extra blocks in a random order: (k_pool, v_pool,
    tables [b, T] int32 naming distinct blocks)."""
    nb = b * T + extra
    k = torch.randn(nb, bs, hd, device=dev, generator=g).to(dtype)
    v = torch.randn(nb, bs, hd, device=dev, generator=g).to(dtype)
    perm = torch.randperm(nb, device=dev, generator=g)[:b * T]
    return k, v, perm.view(b, T).int().contiguous()


def _quantized(t):
    from deepspeed_tpu_torch.ops.quantizer import quantize_kv
    q, s = quantize_kv(t)
    return q, s[..., 0].contiguous()


# paged kernel (B3) and the int8 branches of B2 and B3 vs their plain
# versions: f32, bf16 and fp16 x d x block size x s_q, permuted tables with
# sentinel entries past each row's fill, a row with fill 0 (zeros), and the
# retired-lane sentinel fill past S. B3 within B2's bound; int8 in bf16 or
# fp16 adds a relative term: the plain versions round the dequantized cache
# to the compute type (bf16: 2^-9 relative per element) before the einsum,
# the kernels keep it f32
INT8_RTOL = {torch.float32: 0.0, torch.bfloat16: 2e-2, torch.float16: 2e-2}
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("s_q", list(range(1, 9)))
def test_paged_and_int8_decode_kernels_match_plain(dev, dtype, bs, d, s_q):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator(device=dev).manual_seed(s_q * 1000 + d * 10 + bs)
    b, h, S = 5, 4, 320
    T = S // bs
    kp, vp, tables = _pools(dev, dtype, b, T, bs, h * d, g)
    nb = kp.shape[0]
    fills = torch.tensor([0, s_q, 33, S, S + 1], dtype=torch.int32,
                         device=dev)
    live_blocks = (fills.clamp(max=S) + bs - 1) // bs
    past = torch.arange(T, device=dev)[None, :] >= live_blocks[:, None]
    tables = torch.where(past, nb, tables).int().contiguous()  # sentinels
    q = torch.randn(b, s_q, h, d, device=dev, generator=g).to(dtype)
    before = dict(_build.LAUNCHES)
    out = da.paged_decode_attention(q, kp, vp, tables, fills, scale=0.1)
    (kq, ks), (vq, vs) = _quantized(kp), _quantized(vp)
    out8 = da.paged_decode_attention(q, kq, vq, tables, fills, scale=0.1,
                                     k_scale=ks, v_scale=vs)
    dense_k = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    dense_v = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    (dkq, dks), (dvq, dvs) = _quantized(dense_k), _quantized(dense_v)
    dense8 = da.decode_attention(q, dkq, dvq, fills, scale=0.1, k_scale=dks,
                                 v_scale=dvs)
    torch.cuda.synchronize()
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "decode_attention_int8"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    refs = (da.paged_decode_attention_reference(q, kp, vp, tables, fills,
                                                0.1),
            da.paged_decode_attention_reference(q, kq, vq, tables, fills,
                                                0.1, ks, vs),
            da.decode_attention_reference(q, dkq, dvq, fills, 0.1, dks, dvs))
    for name, got, ref, rtol in (
            ("B3", out, refs[0], 0.0),
            ("B3-int8", out8, refs[1], INT8_RTOL[dtype]),
            ("B2-int8", dense8, refs[2], INT8_RTOL[dtype])):
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=ATOL[dtype], msg=lambda m: name + m)
        assert not got[0].any()                  # fill 0: no key, zeros


# B2, B3 and their int8 branches at the fused-prefill widths (s_q 9-16 run
# the kSQ 16 instance; 24 runs as pieces of 16 and 8, two launches a call)
# at every head dim, and at d 80 at the decode and verify widths (s_q 1 and
# 5); tolerances as above
WIDE_D80_CASES = [(s_q, d) for s_q in (9, 16, 24) for d in (32, 64, 80, 96,
                                                            128)] \
    + [(1, 80), (5, 80)]


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("s_q,d", WIDE_D80_CASES)
def test_decode_kernels_at_prefill_widths_and_d80_match_plain(dev, dtype,
                                                              s_q, d):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator(device=dev).manual_seed(s_q * 1000 + d)
    b, h, S, bs = 5, 4, 320, 16
    T = S // bs
    launches = len(da.query_pieces(s_q))
    kp, vp, tables = _pools(dev, dtype, b, T, bs, h * d, g)
    nb = kp.shape[0]
    fills = torch.tensor([1, s_q, 33, S, S + 1], dtype=torch.int32,
                         device=dev)
    live_blocks = (fills.clamp(max=S) + bs - 1) // bs
    past = torch.arange(T, device=dev)[None, :] >= live_blocks[:, None]
    tables = torch.where(past, nb, tables).int().contiguous()
    q = torch.randn(b, s_q, h, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    (pkq, pks), (pvq, pvs) = _quantized(kp), _quantized(vp)
    before = dict(_build.LAUNCHES)
    got = {"B2": da.decode_attention(q, k, v, fills, scale=0.1),
           "B3": da.paged_decode_attention(q, kp, vp, tables, fills,
                                           scale=0.1),
           "B2-int8": da.decode_attention(q, kq, vq, fills, scale=0.1,
                                          k_scale=ks, v_scale=vs),
           "B3-int8": da.paged_decode_attention(q, pkq, pvq, tables, fills,
                                                scale=0.1, k_scale=pks,
                                                v_scale=pvs)}
    torch.cuda.synchronize()
    for name in ("decode_attention", "paged_decode_attention",
                 "decode_attention_int8", "paged_decode_attention_int8"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + launches
    refs = {"B2": da.decode_attention_reference(q, k, v, fills, 0.1),
            "B3": da.paged_decode_attention_reference(q, kp, vp, tables,
                                                      fills, 0.1),
            "B2-int8": da.decode_attention_reference(q, kq, vq, fills, 0.1,
                                                     ks, vs),
            "B3-int8": da.paged_decode_attention_reference(
                q, pkq, pvq, tables, fills, 0.1, pks, pvs)}
    for name, out in got.items():
        rtol = INT8_RTOL[dtype] if name.endswith("int8") else 0.0
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), refs[name].float(),
                                   rtol=rtol, atol=ATOL[dtype],
                                   msg=lambda m: name + m)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("s_q", [1, 4])
def test_paged_kernel_over_a_dense_layout_is_bitwise_dense(dev, int8, dtype,
                                                           s_q):
    """The paged kernel shares every line of arithmetic with the dense one:
    over tables that lay a dense cache out (in order, or permuted with the
    blocks moved to match), its output is bitwise the dense kernel's."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator(device=dev).manual_seed(7 + s_q)
    b, h, d, S, bs = 4, 12, 64, 1024, 16
    T = S // bs
    k = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, S, h * d, device=dev, generator=g).to(dtype)
    ks = vs = kps = vps = None
    if int8:
        (k, ks), (v, vs) = _quantized(k), _quantized(v)
    q = torch.randn(b, s_q, h, d, device=dev, generator=g).to(dtype)
    fills = torch.tensor([1, 500, S, S + s_q], dtype=torch.int32, device=dev)
    dense = da.decode_attention(q, k, v, fills, k_scale=ks, v_scale=vs)
    in_order = torch.arange(b * T, device=dev, dtype=torch.int32).view(b, T)
    perm = torch.randperm(b * T, device=dev, generator=g).int().view(b, T)
    for tables in (in_order, perm):
        kp = torch.empty(b * T, bs, h * d, device=dev, dtype=k.dtype)
        vp = torch.empty_like(kp)
        kp[tables.flatten().long()] = k.view(b * T, bs, h * d)
        vp[tables.flatten().long()] = v.view(b * T, bs, h * d)
        if int8:
            kps = torch.empty(b * T, bs, device=dev)
            vps = torch.empty_like(kps)
            kps[tables.flatten().long()] = ks.view(b * T, bs)
            vps[tables.flatten().long()] = vs.view(b * T, bs)
        paged = da.paged_decode_attention(q, kp, vp, tables.contiguous(),
                                          fills, k_scale=kps, v_scale=vps)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)


# Split-KV cases of the decode kernels (a cluster of split_count(S) blocks
# a (row, head), each owning a contiguous range of the row's 32-key tiles):
# (S, s_q, fills). Full rows; fills on and one past each rank boundary of a
# full row's 8-way split (128 r); S not a multiple of the tile; s_q = 8 with
# fills under 8 (ranks, and whole rows, in which a query sees nothing).
SPLIT_CASES = {
    "uniform_full": (1024, 1, [1024] * 4),
    "split_boundaries": (1024, 1, [f for r in range(1, 8)
                                   for f in (128 * r, 128 * r + 1)]),
    "split_boundaries_sq4": (1024, 4, [f for r in range(1, 8)
                                       for f in (128 * r, 128 * r + 1)]),
    "S1000": (1000, 4, [1000, 999, 968, 969, 33, 500]),
    "S77": (77, 2, [77, 64, 65, 32, 33, 1]),
    "sq8_short": (256, 8, [0, 1, 3, 7, 8, 9]),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_kv_decode_cases(dev, case, dtype, int8):
    """B2 against its plain version; B3 over an in-order table bitwise B2
    (a dense S that is no whole number of blocks is padded to one, which
    keeps the split count: it depends on S only through ceil(S / 32));
    a second call of each bitwise the first; exact zeros for a query that
    sees no key."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    S, s_q, fill_list = SPLIT_CASES[case]
    b, h, d, bs = len(fill_list), 4, 64, 8
    g = torch.Generator(device=dev).manual_seed(len(case) * 10 + s_q)
    T = -(-S // bs)
    assert da.split_count(S) == da.split_count(T * bs)
    q = torch.randn(b, s_q, h, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, T * bs, h * d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, T * bs, h * d, device=dev, generator=g).to(dtype)
    fills = torch.tensor(fill_list, dtype=torch.int32, device=dev)
    ks = vs = kps = vps = None
    if int8:
        (k, ks), (v, vs) = _quantized(k), _quantized(v)
        kps, vps = ks.view(b * T, bs), vs.view(b * T, bs)
    kd, vd = k[:, :S].contiguous(), v[:, :S].contiguous()
    ksd = None if ks is None else ks[:, :S].contiguous()
    vsd = None if vs is None else vs[:, :S].contiguous()
    tables = torch.arange(b * T, dtype=torch.int32, device=dev).view(b, T)
    kp, vp = k.view(b * T, bs, h * d), v.view(b * T, bs, h * d)
    dense = [da.decode_attention(q, kd, vd, fills, scale=0.1, k_scale=ksd,
                                 v_scale=vsd) for _ in range(2)]
    paged = [da.paged_decode_attention(q, kp, vp, tables, fills, scale=0.1,
                                       k_scale=kps, v_scale=vps)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dense[0], dense[1])
    assert torch.equal(paged[0], paged[1])
    assert torch.equal(paged[0], dense[0])
    ref = da.decode_attention_reference(q, kd, vd, fills, 0.1, ksd, vsd)
    rtol = INT8_RTOL[dtype] if int8 else 0.0
    torch.testing.assert_close(dense[0].float(), ref.float(), rtol=rtol,
                               atol=ATOL[dtype])
    assert torch.isfinite(dense[0]).all()
    seen = (fills.clamp(max=S)[:, None] - (s_q - 1)
            + torch.arange(s_q, device=dev)) > 0
    assert not dense[0][~seen].any()


def test_paged_and_int8_kernels_raise_on_what_they_lack(dev):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    kp = torch.randn(8, 16, 128, device=dev)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    q = torch.randn(2, 1, 2, 64, device=dev)
    before = dict(_build.LAUNCHES)
    for bad in (dict(q=torch.randn(2, 1, 4, 32, device=dev).double()),
                dict(q=torch.randn(2, 1, 8, 16, device=dev)),
                dict(pool=torch.randn(8, 12, 128, device=dev))):
        pool = bad.get("pool", kp)
        with pytest.raises(ValueError, match="decode kernel takes"):
            da.paged_decode_attention(bad.get("q", q), pool, pool, tables, 3)
    k8 = torch.zeros(8, 16, 128, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="k_scale must be f32"):
        da.paged_decode_attention(q, k8, k8, tables, 3,
                                  k_scale=torch.ones(8, 8, device=dev),
                                  v_scale=torch.ones(8, 8, device=dev))
    with pytest.raises(ValueError, match="cache dtypes"):
        da.paged_decode_attention(q, k8, k8, tables, 3)
    with pytest.raises(ValueError, match="cache dtypes"):
        da.decode_attention(q, kp.view(2, 64, 128), kp.view(2, 64, 128), 3,
                            k_scale=torch.ones(2, 64, device=dev),
                            v_scale=torch.ones(2, 64, device=dev))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("kw", [dict(paged=True),
                                dict(kv_dtype="int8"),
                                dict(paged=True, kv_dtype="int8")])
def test_paged_and_int8_engines_launch_their_kernels(dev, kw):
    """The serving engine on the card goes through the paged / int8 kernels
    (and no other decode kernel), and its greedy tokens equal the same
    engine's on the CPU for the first tokens of each request (f32)."""
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = GPTConfig(vocab_size=512, max_seq_len=128, num_layers=2,
                    num_heads=2, d_model=128, d_ff=256, dtype=torch.float32)
    model = GPT(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ps = [rng.integers(1, 512, int(n)).astype(np.int32)
          for n in (5, 20, 9, 20)]
    ps[3] = ps[1].copy()                           # a prefix-cache hit
    args = dict(max_batch=2, decode_chunk=4, max_prompt_len=32,
                megakernel=True, kv_block_size=16, **kw)
    cpu = ServingEngine(engine=InferenceEngine(
        GPT(cfg), dtype=torch.float32, device="cpu",
        model_parameters=model.state_dict()), **args).run(
        [p.copy() for p in ps], max_new_tokens=8)
    _build.reset_launch_counts()
    card = ServingEngine(engine=InferenceEngine(
        model, dtype=torch.float32, device=dev), **args).run(
        [p.copy() for p in ps], max_new_tokens=8)
    name = ("paged_decode_attention" if kw.get("paged")
            else "decode_attention")
    if kw.get("kv_dtype") == "int8":
        name += "_int8"
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert set(launched) == {name, "sampling"}, launched
    assert all(r.status == "done" and len(r.tokens) == 8 for r in card)
    assert [r.tokens[:2] for r in card] == [r.tokens[:2] for r in cpu]
    if kw.get("paged"):
        assert card[3].tokens == card[1].tokens


# top-p: the kernel sums e = expf(y - max) (f32, y the top-k output)
# exactly, as 64-bit fixed point of 2^-44 a unit, and cuts where the mass
# strictly above a token reaches top_p * Z. The test holds its kept set
# against that cut taken with f64 mass from the same f32 differences: a token
# may flip only where its f64 mass above sits at top_p within the kernel's
# rounding of e. CUDA's expf is within 2 ulp (2.4e-7 relative) of exp, which
# moves the mass above and Z by at most that share each; the truncation to
# fixed point adds at most V * 2^-44 (1.5e-8 at V 262144, Z >= 1). Twice
# that sum, rounded up.
TOP_P_EXACT_TOL = 1e-6


def _mass_above(key, e):
    """Per entry, the sum of e over the entries of its row with a strictly
    larger order key (f64, exact up to the f64 sums)."""
    keys, order = key.sort(dim=-1, descending=True)
    es = e.gather(-1, order)
    excl = es.cumsum(-1) - es
    first = torch.searchsorted((-keys).contiguous(), (-key).contiguous())
    return excl.gather(-1, first)


def _top_p_agrees(kept, y, top_k, top_p):
    """Assert the kernel's top-p kept set (after top-k) is the exact cut's
    up to TOP_P_EXACT_TOL; return the largest gap of a differing token."""
    from deepspeed_tpu_torch.ops.cuda.sampling import (filter_rows_reference,
                                                       order_key)
    yk = filter_rows_reference(y, top_k, None)
    e = torch.exp((yk - yk.max(-1, keepdim=True).values).double())
    above = _mass_above(order_key(yk), e) / e.sum(-1, keepdim=True)
    p32 = float(np.float32(top_p))          # the kernel's top_p
    gap = (above - p32).abs()[kept != (above < p32)]
    worst = gap.max().item() if gap.numel() else 0.0
    assert worst <= TOP_P_EXACT_TOL, (top_k, top_p, gap.numel(), worst)
    return worst


def _slice_ends(V):
    """The first entry of rank 1 for each cluster size the sampling kernel
    may split a row over (csrc/sampling.cu: ceil(V / C) rounded up to a
    multiple of 4)."""
    return [(-(-V // C) + 3) // 4 * 4 for C in (16, 8, 4, 2)]


# every row split the way serving (b 8), a wide batch (64), a batch that
# fills the card (256) and one row (1) split it, at GPT-2's vocabulary, at
# 128K and at the largest row the kernel takes (_MAX_VOCAB); ties at the
# top (greedy takes the first) and at the top-k cut (all kept), straddling
# the first two blocks of a cluster
@pytest.mark.parametrize("V", [50304, 131072, 262144])
@pytest.mark.parametrize("b", [1, 8, 64, 256])
def test_sampling_kernel_matches_plain(dev, b, V):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    g = torch.Generator(device=dev).manual_seed(b * 7 + V)
    assert sp.sampling_supported(b, V)
    x = torch.randn(b, V, device=dev, generator=g) * 4
    x[0, 11] = x[0, 13] = x[0].max() + 1          # tie at the top
    ends = _slice_ends(V)
    for r in range(b):
        s = ends[r % len(ends)]
        if r % 2 == 1:                             # a top tie across ranks
            x[r, s - 1] = x[r, s] = x[r].max() + 1
        else:                                      # a tie at the top-k cut
            x[r, s - 1] = x[r, s] = -100.0
            x[r, s - 1] = x[r, s] = x[r].sort(descending=True).values[49]
    gum = -torch.log(-torch.log(torch.rand(b, V, device=dev, generator=g)
                                .clamp_min(1e-30)))
    before = _build.LAUNCHES["sampling"]
    greedy = sp.fused_sample(x, None, 0.0, None)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sampling"] == before + 1
    assert torch.equal(greedy, sp.fused_sample_reference(x, None, None,
                                                         None))
    assert int(greedy[0]) == 11
    for r in range(1, b, 2):
        assert int(greedy[r]) == ends[r % len(ends)] - 1
    # the kernel's candidate path (top-k, then top-p on the candidates),
    # its general path (top-p alone; k = 2000 gathers more than 1024
    # candidates) and, on integer logits, ties past the candidate budget
    coarse = (x / 4).round()
    for xx, top_k, top_p in ((x, 50, None), (x, 1, None), (x, None, 0.9),
                             (x, 40, 0.7), (x, 2000, None), (x, 2000, 0.95),
                             (coarse, 50, None), (coarse, 50, 0.9)):
        kern = sp.threshold_filter_logits(xx, 1.3, top_k, top_p)
        ref = sp.filter_rows_reference(xx / 1.3, top_k, top_p)
        if top_p is None:
            assert torch.equal(kern, ref)
        else:
            worst = _top_p_agrees(kern > -1e9, xx / 1.3, top_k, top_p)
            print(f"sampling b={b} V={V} top_k={top_k} top_p={top_p}: "
                  f"largest top-p gap to the exact cut {worst}")
        drawn = sp.fused_sample(xx, gum, 1.3, top_k, top_p).long()
        assert (kern[torch.arange(b, device=dev), drawn] > -1e9).all()
        # rows whose kept sets agree draw the plain version's token
        same = ((kern > -1e9) == (ref > -1e9)).all(-1)
        drawn_ref = sp.fused_sample_reference(xx / 1.3, gum, top_k, top_p)
        assert torch.equal(drawn[same], drawn_ref.long()[same])
    kept = (sp.threshold_filter_logits(x, 1.0, 50) > -1e9).sum(-1)
    assert (kept[0::2] == 52).all() and (kept[1::2] >= 50).all()


# the inputs this test held the kernel to before the redesign (b 6, seed 0):
# there the top-p kept sets equal the f32 plain version's exactly
@pytest.mark.parametrize("V", [50304, 131072])
def test_sampling_top_p_equals_plain_on_seed_inputs(dev, V):
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(6, V, device=dev, generator=g) * 4
    x[0, 11] = x[0, 13] = x[0].max() + 1
    for top_k, top_p in ((None, 0.9), (40, 0.7)):
        kern = sp.threshold_filter_logits(x, 1.3, top_k, top_p)
        ref = sp.filter_rows_reference(x / 1.3, top_k, top_p)
        assert torch.equal(kern > -1e9, ref > -1e9)


def test_megakernel_engine_launches_both_kernels(dev):
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = GPTConfig(vocab_size=512, max_seq_len=128, num_layers=2,
                    num_heads=2, d_model=128, d_ff=256)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    ps = [rng.integers(1, 512, int(n)).astype(np.int32) for n in (5, 20, 9)]
    _build.reset_launch_counts()
    mega = ServingEngine(model, max_batch=2, decode_chunk=4,
                         max_prompt_len=32, megakernel=True).run(
        ps, max_new_tokens=8)
    assert _build.LAUNCHES["decode_attention"] > 0
    assert _build.LAUNCHES["sampling"] > 0
    assert all(r.status == "done" and len(r.tokens) == 8 for r in mega)


def test_megakernel_raises_on_a_head_dim_the_kernel_lacks(dev):
    """megakernel=True on the card never serves through the plain einsum."""
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=512, max_seq_len=64, num_layers=1,
                    num_heads=2, d_model=96, d_ff=192)        # d = 48
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(model, max_batch=2, decode_chunk=2,
                        max_prompt_len=16, megakernel=True)
    with pytest.raises(ValueError, match="decode kernel takes"):
        eng.run([np.arange(1, 6, dtype=np.int32)], max_new_tokens=4)


# flash kernels vs plain versions: f32 differs only in summation order (the
# f32 kernels use CUDA-core FMAs); the bf16 / fp16 kernels round p and ds to
# the input type for the tensor-core products and both sides round their
# outputs to it (1 bf16 ulp is 2^-8 relative, fp16 2^-11), so the bound is
# relative plus a floor
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
             torch.float16: dict(rtol=2e-2, atol=2e-2)}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _qkv_views(dev, B, S, H, d, dtype, seed):
    """q, k, v as strided views of one fused [B, S, 3*H*d] tensor (the
    model's qkv projection), and a random dO."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * d, device=dev, generator=g).to(dtype)
    q, k, v = (t.view(B, S, H, d) for t in qkv.split(H * d, -1))
    do = torch.randn(B, S, H, d, device=dev, generator=g).to(dtype)
    return q, k, v, do


def _flash_check(q, k, v, do, causal):
    """The three kernels once each against the plain versions."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    dtype, scale = q.dtype, 1 / q.shape[-1] ** 0.5
    before = dict(_build.LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, causal, scale)
    ref_out, ref_lse = fa.flash_attention_forward_reference(q, k, v, causal,
                                                            scale)
    grads = fa.flash_attention_backward(q, k, v, ref_out, ref_lse, do,
                                        causal, scale)
    refs = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse,
                                                 do, causal, scale)
    torch.cuda.synchronize()
    for name in FLASH_KERNELS:
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref_out.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype and got.shape == q.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("S", [1024, 1000, 77, 1])
def test_flash_kernels_match_plain(dev, dtype, causal, d, S):
    B, H = 2, 3
    _flash_check(*_qkv_views(dev, B, S, H, d, dtype, S + d), causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernels_at_the_layer_shape(dev, dtype):
    """DeepSpeedTransformerLayer's unmasked shape at BERT-large width:
    B=8, S=512, H=16, D=64, not causal."""
    _flash_check(*_qkv_views(dev, 8, 512, 16, 64, dtype, 7), False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 80, 96])
def test_flash_backward_is_bitwise_reproducible(dev, dtype, d):
    """No atomics: two backward calls give bitwise the same dq, dk, dv."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = _qkv_views(dev, 2, 1000, 4, d, dtype, 11)
    out, lse = fa.flash_attention_forward(q, k, v, True, 0.125)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, True, 0.125)
    again = fa.flash_attention_backward(q, k, v, out, lse, do, True, 0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_raises_on_a_head_dim_the_kernels_lack(dev):
    """attention_impl="auto" on the card never gives way to the einsum: a
    head dim the kernels lack (48, 256) raises in every dtype; fp16 at a
    head dim they take runs."""
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    for d in (48, 256):
        q = torch.randn(1, 16, 2, d, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            with pytest.raises(ValueError, match="flash kernels take"):
                fa.flash_attention(q.to(dtype), q.to(dtype), q.to(dtype))
    q = torch.randn(1, 16, 2, 64, device=dev).half()
    assert fa.flash_attention(q, q, q).dtype == torch.float16
    cfg = GPTConfig(vocab_size=128, max_seq_len=32, num_layers=1,
                    num_heads=2, d_model=96, d_ff=192,
                    dtype=torch.float32)                 # d = 48
    model = GPT(cfg, device=dev)
    with pytest.raises(ValueError, match="flash kernels take"):
        model(torch.zeros(1, 8, dtype=torch.long, device=dev))


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_flash_under_checkpoint_matches_plain(dev, policy):
    """A remat GPT through the kernels (FlashAttention under non-reentrant
    torch.utils.checkpoint with the policy) against the same weights through
    the masked einsum without remat: loss and every grad, f32. The forward
    kernel runs twice per layer (forward, then the recompute)."""
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    kw = dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=2,
              d_model=128, d_ff=256, dtype=torch.float32)
    flash = GPT(GPTConfig(remat=True, remat_policy=policy, **kw), device=dev)
    flash.init_weights(torch.Generator(device=dev).manual_seed(0))
    plain = GPT(GPTConfig(remat=False, attention_impl="xla", **kw),
                device=dev)
    plain.load_state_dict(flash.state_dict())
    ids = torch.randint(0, 256, (2, 100), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    _build.reset_launch_counts()
    loss = lm_loss_fn(flash(ids), {"input_ids": ids})
    loss.backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_fwd"] == 2 * 2
    assert _build.LAUNCHES["flash_bwd_dq"] == 2
    assert _build.LAUNCHES["flash_bwd_dkv"] == 2
    ref = lm_loss_fn(plain(ids), {"input_ids": ids})
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)
    for (name, p), r in zip(flash.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, r.grad, rtol=1e-4, atol=1e-5,
                                   msg=name)


# block-sparse kernels vs plain versions over chip_smoke.py's parity grid:
# f32, bf16 and fp16, layout blocks 16-128, causal and not, with and
# without a key-padding mask, S a multiple of the 64-row tile or not, q/k/v
# as views of a fused qkv. Tolerances as for flash (the same rounding)
SPARSE = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")


def _sparse_check(dev, cfg, q, k, v, do, causal, kvm, dtype):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    B, S, H, d = q.shape
    layout = compiled_layout(cfg, S, causal).on(dev)
    scale = 1 / d ** 0.5
    before = dict(_build.LAUNCHES)
    out, lse = sa.sparse_attention_forward(q, k, v, layout, scale, kvm)
    ref_out, ref_lse = sa.sparse_attention_forward_reference(q, k, v, layout,
                                                             scale, kvm)
    grads = sa.sparse_attention_backward(q, k, v, ref_out, ref_lse, do,
                                         layout, scale, kvm)
    refs = sa.sparse_attention_backward_reference(q, k, v, ref_out, ref_lse,
                                                  do, layout, scale, kvm)
    torch.cuda.synchronize()
    for name in SPARSE:
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    torch.testing.assert_close(out.float(), ref_out.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype and got.shape == q.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[dtype])
    return out, lse, grads


SPARSE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S", [(16, 480), (32, 512), (64, 512),
                                     (128, 512)])
def test_sparse_kernels_match_plain(dev, dtype, causal, masked, block, S):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    B, H, d = 2, 3, 64
    cfg = BigBirdSparsityConfig(num_heads=H, block=block,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, do = _qkv_views(dev, B, S, H, d, dtype, S + block)
    kvm = None
    if masked:
        kvm = torch.ones(B, S, device=dev)
        kvm[0, 300:] = 0
    _, _, (dq, dk, dv) = _sparse_check(dev, cfg, q, k, v, do, causal, kvm,
                                       dtype)
    if masked:                      # masked keys: exactly zero dk, dv
        assert not dk[0, 300:].any() and not dv[0, 300:].any()


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S", [(32, 2560), (64, 4096)])
def test_sparse_dkv_split_rows_match_plain(dev, dtype, causal, block, S):
    """Global key tiles seen by more query tiles than DKV_CHUNK: the dk/dv
    kernel splits their column-LUT rows over several items, each writing a
    workspace partial, summed in a fixed order, so repeated calls give
    bitwise the same dq, dk and dv."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    cfg = BigBirdSparsityConfig(num_heads=2, block=block)
    assert compiled_layout(cfg, S, causal).dkv_parts > 0
    q, k, v, do = _qkv_views(dev, 2, S, 2, 64, dtype, S)
    kvm = torch.ones(2, S, device=dev)
    kvm[1, S // 3:] = 0
    for mask in (None, kvm):
        _sparse_repeats(dev, cfg, q, k, v, do, causal, mask, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_sparse_dkv_split_into_three_items(dev, causal):
    """A global key tile split over three items: the 16-bit kernel's combine
    tree pairs ranks 0 and 1 and carries rank 2 up alone. fp16: in bf16
    the sums of 5120 rounded terms of this input leave one small element of
    dk just over the elementwise bound, as they did before the combine
    tree (the kernels round p and dS to the input type, the plain version
    does not)."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    S = 5120
    cfg = BigBirdSparsityConfig(num_heads=2, block=16)
    lay = compiled_layout(cfg, S, causal)
    assert set(lay.dkv_items[lay.dkv_items[:, 4] >= 0, 6]) == {3}
    q, k, v, do = _qkv_views(dev, 2, S, 2, 64, torch.float16, S)
    kvm = torch.ones(2, S, device=dev)
    kvm[1, S // 3:] = 0
    for mask in (None, kvm):
        _sparse_repeats(dev, cfg, q, k, v, do, causal, mask, torch.float16)


def _sparse_repeats(dev, cfg, q, k, v, do, causal, kvm, dtype):
    """The kernels against the plain versions, then four backwards that
    must give bitwise the same dq, dk and dv."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    out, lse, grads = _sparse_check(dev, cfg, q, k, v, do, causal, kvm,
                                    dtype)
    layout = compiled_layout(cfg, q.shape[1], causal).on(dev)
    runs = [sa.sparse_attention_backward(q, k, v, out, lse, do, layout,
                                         q.shape[-1] ** -0.5, kvm)
            for _ in range(4)]
    for again in runs[1:]:
        for name, a, g in zip(("dq", "dk", "dv"), again, runs[0]):
            assert torch.equal(a, g), name
    return out, lse, grads


# the 16-bit backward's persistent schedule: more work items than two
# pipelines on every SM (B=2, H=4, S=4096: 512 of each kernel), fewer than
# one block's two pipelines (one item), and a ragged S whose global column
# LUT is split
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,S,block", [(2, 4, 4096, 64), (1, 1, 64, 16),
                                         (1, 2, 4000, 16)])
def test_sparse_backward_schedules_match_plain(dev, dtype, B, H, S, block):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    cfg = BigBirdSparsityConfig(num_heads=H, block=block,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    lay = compiled_layout(cfg, S, True)
    items = lay.dq_items.shape[0] * B
    if S == 4096:
        assert items > 2 * 132 and lay.dkv_items.shape[0] * B > 2 * 132
    elif S == 64:
        assert items == 1
    else:
        assert lay.dkv_parts > 0
    q, k, v, do = _qkv_views(dev, B, S, H, 64, dtype, S)
    _sparse_repeats(dev, cfg, q, k, v, do, True, None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_key_padding_inside_a_tile(dev, dtype, causal):
    """Block 64 (one bit a tile pair) with key-padding masks that cut inside
    a live tile: the dq kernel takes the masked body on off-diagonal pairs,
    the dk/dv kernel zeroes the dropped keys' rows at the store."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    B, S, H = 2, 512, 3
    cfg = BigBirdSparsityConfig(num_heads=H, block=64,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, do = _qkv_views(dev, B, S, H, 64, dtype, 7)
    kvm = torch.ones(B, S, device=dev)
    kvm[0, 100:] = 0
    kvm[1, 190:] = 0
    kvm[1, 30:40] = 0
    _, _, (dq, dk, dv) = _sparse_repeats(dev, cfg, q, k, v, do, causal, kvm,
                                         dtype)
    gone = kvm == 0
    assert not dk[gone].any() and not dv[gone].any()
    assert dk[~gone].abs().sum() > 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_kernels_at_d128_fp16_match_plain(dev, causal, masked):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    B, H, S = 2, 3, 2560
    cfg = BigBirdSparsityConfig(num_heads=H, block=64,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, do = _qkv_views(dev, B, S, H, 128, torch.float16, 128)
    kvm = None
    if masked:
        kvm = torch.ones(B, S, device=dev)
        kvm[1, 1000:] = 0
    _, _, (dq, dk, dv) = _sparse_repeats(dev, cfg, q, k, v, do, causal, kvm,
                                         torch.float16)
    if masked:
        assert not dk[1, 1000:].any() and not dv[1, 1000:].any()


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_kernels_at_d96_match_plain(dev, dtype, causal, masked):
    """gpt_neox_20b's head dim (6144 / 64 = 96): BigBird, per-head
    layouts, S not a multiple of the 64-row tile."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    B, H, d, S = 2, 3, 96, 480
    cfg = BigBirdSparsityConfig(num_heads=H, block=32,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, do = _qkv_views(dev, B, S, H, d, dtype, 96)
    kvm = None
    if masked:
        kvm = torch.ones(B, S, device=dev)
        kvm[1, 200:] = 0
    _, _, (dq, dk, dv) = _sparse_check(dev, cfg, q, k, v, do, causal, kvm,
                                       dtype)
    if masked:
        assert not dk[1, 200:].any() and not dv[1, 200:].any()


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_kernels_at_d80_match_plain(dev, dtype, causal, masked):
    """GPT 2.7B's head dim (2560 / 32 = 80): the 16-bit kernels run their
    d 96 instances over columns 80-95 that TMA fills with zeros, and store
    80; f32 splits a row of 80 over 4 threads. BigBird, per-head layouts, S
    not a multiple of the 64-row tile, and long column-LUT rows (S 2560,
    block 32) whose dk/dv split into workspace partials."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    for B, H, S, block in ((2, 3, 480, 32), (1, 2, 2560, 32)):
        cfg = BigBirdSparsityConfig(num_heads=H, block=block,
                                    different_layout_per_head=True,
                                    num_random_blocks=2)
        q, k, v, do = _qkv_views(dev, B, S, H, 80, dtype, 80)
        kvm = None
        if masked:
            kvm = torch.ones(B, S, device=dev)
            kvm[-1, S // 2:] = 0
        out, _, (dq, dk, dv) = _sparse_check(dev, cfg, q, k, v, do, causal,
                                             kvm, dtype)
        assert out.shape == (B, S, H, 80)
        if masked:
            assert not dk[-1, S // 2:].any() and not dv[-1, S // 2:].any()


class _HoleyLayout:
    """Local windows of 2 blocks without global blocks; key blocks 8-15 are
    seen by no query (their key tiles' column LUTs are empty) and query
    blocks 8-15 see nothing (dead rows)."""
    block, attention = 16, "bidirectional"

    def make_layout(self, seq_len):
        nb = seq_len // 16
        lay = np.zeros((2, nb, nb), np.int64)
        for i in range(nb):
            lay[:, i, (i // 2) * 2:(i // 2) * 2 + 2] = 1
        lay[:, :, 8:] = 0
        return lay


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
@pytest.mark.parametrize("d", [32, 96, 128])
def test_sparse_dead_rows_and_empty_key_tiles(dev, dtype, d):
    B, S, H = 2, 256, 2
    q, k, v, do = _qkv_views(dev, B, S, H, d, dtype, d)
    kvm = torch.ones(B, S, device=dev)
    kvm[1, 40:] = 0                  # row 1: query blocks 4-7 see only padding
    out, lse, (dq, dk, dv) = _sparse_check(dev, _HoleyLayout(), q, k, v, do,
                                           False, kvm, dtype)
    assert not out[:, 128:].any() and (lse[:, :, 128:] == -1e30).all()
    assert not out[1, 64:].any() and (lse[1, :, 64:] == -1e30).all()
    assert out[1, :64].abs().sum() > 0
    assert not dk[:, 128:].any() and not dv[:, 128:].any()
    assert not dq[:, 128:].any()


def test_sparse_raises_on_what_the_kernels_lack(dev):
    """On the card a head dim, dtype or layout block the kernels lack
    raises; nothing gives way to the plain version."""
    from deepspeed_tpu_torch.ops.sparse_attention import (DenseSparsityConfig,
                                                          sparse_attention)
    cfg = DenseSparsityConfig(num_heads=2, block=16)
    for d in (48, 256):
        q = torch.randn(1, 64, 2, d, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            with pytest.raises(ValueError, match="sparse kernels take"):
                sparse_attention(q.to(dtype), q.to(dtype), q.to(dtype), cfg)
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="power of two"):
        sparse_attention(q[:, :48], q[:, :48], q[:, :48],
                         DenseSparsityConfig(num_heads=2, block=24))


def test_sparse_gpt_under_checkpoint_matches_plain(dev):
    """A remat sparse GPT (BigBird layout) through the kernels against the
    same weights through the plain versions on the CPU: loss and every
    grad, f32; the forward kernel runs twice per layer (remat)."""
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    kw = dict(vocab_size=256, max_seq_len=512, num_layers=2, num_heads=2,
              d_model=128, d_ff=256, dtype=torch.float32, remat=True,
              attention_impl="sparse")
    sp = lambda: BigBirdSparsityConfig(num_heads=2, block=32)  # noqa: E731
    model = GPT(GPTConfig(sparse_attention=sp(), **kw), device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    plain = GPT(GPTConfig(sparse_attention=sp(), **kw))
    plain.load_state_dict(model.state_dict())
    ids = torch.randint(0, 256, (2, 512), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    _build.reset_launch_counts()
    loss = lm_loss_fn(model(ids), {"input_ids": ids})
    loss.backward()
    torch.cuda.synchronize()
    assert [_build.LAUNCHES[n] for n in SPARSE] == [4, 2, 2]
    assert not any(_build.LAUNCHES[n] for n in
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    ids_cpu = ids.cpu()
    ref = lm_loss_fn(plain(ids_cpu), {"input_ids": ids_cpu})
    ref.backward()
    torch.testing.assert_close(loss.cpu(), ref, rtol=1e-5, atol=1e-5)
    for (name, p), r in zip(model.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad.cpu(), r.grad, rtol=1e-4,
                                   atol=1e-5, msg=name)


class _RaggedLayout:
    """A layout at any S (no multiple of its block needed): per head, the
    diagonal blocks, a global first block and random blocks (about a
    third), over ceil(S / block) blocks; a block of 16 gives tile pairs
    whose fine masks are partly live."""
    attention = "bidirectional"

    def __init__(self, heads, block):
        self.heads, self.block = heads, block

    def make_layout(self, seq_len):
        nb = -(-seq_len // self.block)
        rng = np.random.default_rng(self.block * 1000 + seq_len)
        lay = rng.random((self.heads, nb, nb)) < 0.35
        lay[:, :, 0] = True
        lay[:, np.arange(nb), np.arange(nb)] = True
        return lay.astype(np.int64)


def _sparse_forward_check(dev, cfg, q, k, v, causal, kvm):
    """The forward kernel once against its plain version: out within the
    flash tolerances, lse within 1e-4; returns the kernel's (out, lse)."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    layout = compiled_layout(cfg, q.shape[1], causal).on(dev)
    scale = q.shape[-1] ** -0.5
    before = dict(_build.LAUNCHES)
    out, lse = sa.sparse_attention_forward(q, k, v, layout, scale, kvm)
    ref_out, ref_lse = sa.sparse_attention_forward_reference(q, k, v, layout,
                                                             scale, kvm)
    torch.cuda.synchronize()
    _launched(("sparse_fwd",), before)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref_out.float(),
                               **FLASH_TOL[q.dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    return out, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("S", [480, 77])
def test_sparse_forward_matches_plain(dev, dtype, d, causal, masked, block,
                                      S):
    """The 16-bit forward's branches: every head dim, causal or not, with
    or without a key-padding mask, partly live fine masks (block 16) and
    tiles of a 128 block, S a partial last tile (480) or under one tile
    (77)."""
    B, H = 2, 3
    q, k, v, _ = _qkv_views(dev, B, S, H, d, dtype, S + d + block)
    kvm = None
    if masked:
        kvm = torch.ones(B, S, device=dev)
        kvm[0, S // 2:] = 0
        kvm[1, 5:9] = 0
    _sparse_forward_check(dev, _RaggedLayout(H, block), q, k, v, causal, kvm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_forward_dropped_key_tile_and_dead_rows(dev, dtype, causal):
    """A key-padding mask that drops every key of one key tile (the stage
    keeps each row's running max and sum), and a batch row whose keys are
    all dropped: its out is exactly zero and its lse exactly -1e30."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    B, S, H = 3, 512, 3
    cfg = BigBirdSparsityConfig(num_heads=H, block=64,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, _ = _qkv_views(dev, B, S, H, 64, dtype, 3)
    kvm = torch.ones(B, S, device=dev)
    kvm[0, 128:192] = 0              # key tile 2 of batch row 0
    kvm[1, 64:] = 0                  # only key tile 0 of batch row 1
    kvm[2] = 0                       # batch row 2 sees nothing
    out, lse = _sparse_forward_check(dev, cfg, q, k, v, causal, kvm)
    assert not out[2].any() and bool((lse[2] == -1e30).all())
    assert bool((lse[:2] > -1e30).all()) and out[:2].abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sparse_forward_repeats_bitwise_at_the_training_shape(dev, dtype):
    """B=1, S=32768, H=12, D=64 with the long-context bench layout (BigBird
    block 64, causal): a second forward gives bitwise the same out and lse,
    both within the bounds of the plain version."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    cfg = BigBirdSparsityConfig(num_heads=12, block=64, num_random_blocks=3,
                                num_sliding_window_blocks=3,
                                num_global_blocks=1)
    q, k, v, _ = _qkv_views(dev, 1, 32768, 12, 64, dtype, 32768)
    out, lse = _sparse_forward_check(dev, cfg, q, k, v, True, None)
    again = sa.sparse_attention_forward(
        q, k, v, compiled_layout(cfg, 32768, True).on(dev), 64 ** -0.5)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_forward_lse_feeds_the_backward(dev, dtype, causal, masked):
    """The kernels' out and lse into the backward kernels: dq, dk and dv
    against the plain backward of the plain forward's out and lse."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    B, S, H = 2, 512, 3
    cfg = BigBirdSparsityConfig(num_heads=H, block=32,
                                different_layout_per_head=True,
                                num_random_blocks=2)
    q, k, v, do = _qkv_views(dev, B, S, H, 64, dtype, 21)
    kvm = None
    if masked:
        kvm = torch.ones(B, S, device=dev)
        kvm[1, 200:] = 0
    out, lse = _sparse_forward_check(dev, cfg, q, k, v, causal, kvm)
    layout = compiled_layout(cfg, S, causal).on(dev)
    scale = 64 ** -0.5
    ro, rl = sa.sparse_attention_forward_reference(q, k, v, layout, scale,
                                                   kvm)
    grads = sa.sparse_attention_backward(q, k, v, out, lse, do, layout,
                                         scale, kvm)
    refs = sa.sparse_attention_backward_reference(q, k, v, ro, rl, do,
                                                  layout, scale, kvm)
    torch.cuda.synchronize()
    for got, ref in zip(grads, refs):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[dtype])


# --------------------------------------------------------------------------
# Row-wise kernels: LayerNorm (B6), bias-GELU (B7), softmax (B8)
# --------------------------------------------------------------------------

# (atol, rtol) of kernel vs plain version. Both compute in f32 and round
# once to the element type: bf16 / fp16 within one ulp (2^-7 / 2^-10
# relative); f32 forwards within summation order and the rsqrtf / tanhf /
# expf roundings; gradients sum rows of products, so 1e-4 absolute.
ROW_FWD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
               torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7),
               torch.float16: dict(atol=1e-5, rtol=2 ** -10)}
ROW_GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7),
                torch.float16: dict(atol=1e-4, rtol=2 ** -10)}
ROW_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _launched(names, before):
    from deepspeed_tpu_torch.ops.cuda import _build
    for name in names:
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1, name


@pytest.mark.parametrize("param_f32", [True, False])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("d", [96, 1000, 1016, 1024, 1032, 2048, 4096, 8192])
@pytest.mark.parametrize("n", [1, 12, 37, 4096])
def test_layer_norm_kernels_match_plain(dev, n, d, dtype, param_f32):
    """d up to 1024 takes a warp a row (8, 16 or 32 elements a lane), wider
    rows a block of up to 16 warps; 37 rows leave a block's last warps
    without a row."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = (torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
    pd = torch.float32 if param_f32 else dtype
    gamma = (1 + 0.3 * torch.randn(d, device=dev, generator=g)).to(pd)
    beta = (0.3 * torch.randn(d, device=dev, generator=g)).to(pd)
    dy = torch.randn(n, d, device=dev, generator=g).to(dtype)
    before = dict(_build.LAUNCHES)
    y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, 1e-5)
    ry, rmean, rrstd = ln.layer_norm_forward_reference(x, gamma, beta, 1e-5)
    dx = ln.layer_norm_dx(x, gamma, rmean, rrstd, dy)
    rdx = ln.layer_norm_backward_reference(x, gamma, rmean, rrstd, dy)
    torch.cuda.synchronize()
    _launched(("layer_norm_fwd", "layer_norm_dx"), before)
    assert y.dtype == dx.dtype == dtype and mean.dtype == torch.float32
    torch.testing.assert_close(y.float(), ry.float(), **ROW_FWD_TOL[dtype])
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), **ROW_GRAD_TOL[dtype])


@pytest.mark.parametrize("bias_f32", [True, False])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("d", [96, 1000, 1001, 1024, 4096])
@pytest.mark.parametrize("n", [1, 12, 4096])
def test_bias_gelu_kernels_match_plain(dev, n, d, dtype, bias_f32):
    """d 1001 is no whole number of 16-byte vectors: the scalar loop."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import gelu as gl
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    x = (2 * torch.randn(n, d, device=dev, generator=g)).to(dtype)
    bias = (0.5 * torch.randn(d, device=dev, generator=g)).to(
        torch.float32 if bias_f32 else dtype)
    dy = torch.randn(n, d, device=dev, generator=g).to(dtype)
    before = dict(_build.LAUNCHES)
    y = gl.bias_gelu_forward(x, bias)
    dx = gl.bias_gelu_backward(x, bias, dy)
    torch.cuda.synchronize()
    _launched(("bias_gelu_fwd", "bias_gelu_bwd"), before)
    assert y.dtype == dx.dtype == dtype
    torch.testing.assert_close(y.float(), gl.bias_gelu_forward_reference(
        x, bias).float(), **ROW_FWD_TOL[dtype])
    torch.testing.assert_close(dx.float(), gl.bias_gelu_backward_reference(
        x, bias, dy).float(), **ROW_GRAD_TOL[dtype])


def test_bias_gelu_kernel_on_a_misaligned_view(dev):
    """A contiguous tensor that starts 2 bytes past a 16-byte boundary
    takes the scalar loop."""
    from deepspeed_tpu_torch.ops.cuda import gelu as gl
    flat = torch.randn(12 * 1024 + 1, device=dev).bfloat16()
    x = flat[1:].view(12, 1024)
    assert x.data_ptr() % 16
    bias = torch.randn(1024, device=dev).bfloat16()
    torch.testing.assert_close(
        gl.bias_gelu_forward(x, bias).float(),
        gl.bias_gelu_forward_reference(x, bias).float(),
        **ROW_FWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("S", [1, 77, 512, 1023, 1024, 1025, 2048, 4096])
def test_softmax_kernels_match_plain(dev, S, square, causal, dtype):
    """Rows of up to 1024 take a warp, wider rows a block; S 1, 77, 1023 and
    1025 are no whole number of 16-byte packs (one element a pack); a
    non-square [.., 5, S] score matrix (10 rows) is masked top-left."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    sq = S if square else 5
    g = torch.Generator(device=dev).manual_seed(S * 3 + sq)
    x = (3 * torch.randn(1, 2, sq, S, device=dev, generator=g)).to(dtype)
    dy = torch.randn(x.shape, device=dev, generator=g).to(dtype)
    x2, dy2 = x.view(-1, S), dy.view(-1, S)
    before = dict(_build.LAUNCHES)
    y = sm.softmax_forward(x2, sq, causal)
    ry = sm.softmax_forward_reference(x2, sq, causal)
    dx = sm.softmax_backward(ry, dy2)
    rdx = sm.softmax_backward_reference(ry, dy2)
    torch.cuda.synchronize()
    _launched(("softmax_fwd", "softmax_bwd"), before)
    assert y.dtype == dx.dtype == dtype
    torch.testing.assert_close(y.float(), ry.float(), **ROW_FWD_TOL[dtype])
    torch.testing.assert_close(dx.float(), rdx.float(), **ROW_GRAD_TOL[dtype])
    if causal:
        rows = torch.arange(y.shape[0], device=dev)[:, None] % sq
        above = torch.arange(S, device=dev)[None, :] > rows
        assert float((y.float() * above).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("d", [1000, 1024, 4096])
def test_layer_norm_forward_on_a_misaligned_view(dev, d, dtype):
    """x, gamma and beta start one element past a 16-byte boundary: the
    register kernels at one element a pack."""
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(d)
    n = 37
    x = (torch.randn(n * d + 1, device=dev, generator=g) * 3 + 1).to(
        dtype)[1:].view(n, d)
    params = (1 + 0.3 * torch.randn(2 * d + 2, device=dev, generator=g)).to(
        dtype)
    gamma, beta = params[1:d + 1], params[d + 2:]
    assert x.data_ptr() % 16 and gamma.data_ptr() % 16 and beta.data_ptr() % 16
    y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, 1e-5)
    ry, rmean, rrstd = ln.layer_norm_forward_reference(x, gamma, beta, 1e-5)
    torch.testing.assert_close(y.float(), ry.float(), **ROW_FWD_TOL[dtype])
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("S", [512, 1024, 2048])
def test_softmax_forward_on_a_misaligned_view(dev, S, dtype):
    """x starts one element past a 16-byte boundary: the register kernels
    at one element a pack."""
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    g = torch.Generator(device=dev).manual_seed(S)
    n = 37
    x = (3 * torch.randn(n * S + 1, device=dev, generator=g)).to(
        dtype)[1:].view(n, S)
    assert x.data_ptr() % 16
    for causal in (False, True):
        torch.testing.assert_close(
            sm.softmax_forward(x, 7, causal).float(),
            sm.softmax_forward_reference(x, 7, causal).float(),
            **ROW_FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("S", [512, 1024, 2048])
def test_softmax_forward_at_large_magnitudes(dev, S, dtype):
    """Rows of +-1e4 and the causal row 0 (every column but the first at
    -1e30): exactly one 1.0 in each, the rest 0, no NaN."""
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    g = torch.Generator(device=dev).manual_seed(S + 1)
    n = 12
    hot = torch.randint(0, S, (n,), device=dev, generator=g)
    x = torch.full((n, S), -1e4, device=dev)
    x[torch.arange(n, device=dev), hot] = 1e4
    x = x.to(dtype)
    for causal, sq, cols in ((False, n, hot), (True, n, None)):
        y = sm.softmax_forward(x, sq, causal).float()
        ry = sm.softmax_forward_reference(x, sq, causal).float()
        assert not bool(y.isnan().any())
        torch.testing.assert_close(y, ry, **ROW_FWD_TOL[dtype])
        if cols is not None:
            assert bool((y[torch.arange(n, device=dev), cols] == 1).all())
            assert int((y == 1).sum()) == n and int((y != 0).sum()) == n
        else:
            assert float(y[0, 0]) == 1.0 and int((y[0] != 0).sum()) == 1


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("width", [16384, 16392, 16393])
def test_row_forwards_at_the_register_limit(dev, width, dtype):
    """16384 is the widest row a block holds in registers; wider rows take
    the looping kernels."""
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    g = torch.Generator(device=dev).manual_seed(width)
    x = (3 * torch.randn(37, width, device=dev, generator=g) + 1).to(dtype)
    gamma = (1 + 0.3 * torch.randn(width, device=dev, generator=g)).to(dtype)
    beta = (0.3 * torch.randn(width, device=dev, generator=g)).to(dtype)
    y, mean, rstd = ln.layer_norm_forward(x, gamma, beta, 1e-5)
    ry, rmean, rrstd = ln.layer_norm_forward_reference(x, gamma, beta, 1e-5)
    torch.testing.assert_close(y.float(), ry.float(), **ROW_FWD_TOL[dtype])
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    for causal in (False, True):
        torch.testing.assert_close(
            sm.softmax_forward(x, 7, causal).float(),
            sm.softmax_forward_reference(x, 7, causal).float(),
            **ROW_FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("width", [16384, 16392, 20000])
def test_layer_norm_dx_at_the_register_limit(dev, width, dtype):
    """dx at the widest row a block holds in registers (16384) and on the
    looping kernel past it."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(width)
    x = (3 * torch.randn(37, width, device=dev, generator=g) + 1).to(dtype)
    gamma = (1 + 0.3 * torch.randn(width, device=dev, generator=g)).to(dtype)
    dy = torch.randn(37, width, device=dev, generator=g).to(dtype)
    _, mean, rstd = ln.layer_norm_forward_reference(x, gamma, gamma, 1e-5)
    before = dict(_build.LAUNCHES)
    dx = ln.layer_norm_dx(x, gamma, mean, rstd, dy)
    rdx = ln.layer_norm_backward_reference(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    _launched(("layer_norm_dx",), before)
    torch.testing.assert_close(dx.float(), rdx.float(), **ROW_GRAD_TOL[dtype])


@pytest.mark.parametrize("param_f32", [True, False])
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("d", [1000, 1024, 4096])
def test_layer_norm_dx_on_a_misaligned_view(dev, d, dtype, param_f32):
    """x, dy and gamma start one element past a 16-byte boundary: the
    register dx kernels at one element a pack (dy and gamma read again)."""
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(d + 1)
    n = 37
    x, dy = ((torch.randn(n * d + 1, device=dev, generator=g) * 3 + 1).to(
        dtype)[1:].view(n, d) for _ in range(2))
    gamma = (1 + 0.3 * torch.randn(d + 1, device=dev, generator=g)).to(
        torch.float32 if param_f32 else dtype)[1:]
    assert x.data_ptr() % 16 and dy.data_ptr() % 16 and gamma.data_ptr() % 16
    _, mean, rstd = ln.layer_norm_forward_reference(x, gamma, gamma, 1e-5)
    dx = ln.layer_norm_dx(x, gamma, mean, rstd, dy)
    rdx = ln.layer_norm_backward_reference(x, gamma, mean, rstd, dy)
    torch.testing.assert_close(dx.float(), rdx.float(), **ROW_GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_layer_norm_dx_repeats_bitwise(dev, dtype):
    """A second dx on the same inputs gives the same bits on every path
    (warp rows of 8, 16 and 32 elements a lane, block rows, the loop)."""
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(12)
    for d in (96, 512, 1024, 1025, 4096, 20000):
        x, dy = (torch.randn(37, d, device=dev, generator=g).to(dtype)
                 for _ in range(2))
        gamma = torch.randn(d, device=dev, generator=g).to(dtype)
        _, mean, rstd = ln.layer_norm_forward_reference(x, gamma, gamma, 1e-5)
        assert torch.equal(ln.layer_norm_dx(x, gamma, mean, rstd, dy),
                           ln.layer_norm_dx(x, gamma, mean, rstd, dy)), d


@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_row_forwards_repeat_bitwise(dev, dtype):
    """A second call of each forward on the same inputs gives the same
    bits, on every path (warp rows, block rows, one element a pack)."""
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    g = torch.Generator(device=dev).manual_seed(11)
    for d in (96, 1024, 1025, 4096):
        x = torch.randn(37, d, device=dev, generator=g).to(dtype)
        gamma = torch.randn(d, device=dev, generator=g).to(dtype)
        beta = torch.randn(d, device=dev, generator=g).to(dtype)
        first = ln.layer_norm_forward(x, gamma, beta, 1e-5)
        second = ln.layer_norm_forward(x, gamma, beta, 1e-5)
        for a, b in zip(first, second):
            assert torch.equal(a, b), d
    for S in (77, 512, 1024, 1025, 4096):
        x = (3 * torch.randn(2, 5, S, device=dev, generator=g)).to(
            dtype).view(-1, S)
        for causal in (False, True):
            assert torch.equal(sm.softmax_forward(x, 5, causal),
                               sm.softmax_forward(x, 5, causal)), S


def test_masked_softmax_kernel_matches_plain(dev):
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 4, 64, 64, device=dev, generator=g)
    mask = torch.where(torch.rand(2, 1, 1, 64, device=dev, generator=g)
                       < 0.25, -10000.0, 0.0)
    y = sm.masked_softmax(x, mask, scale=0.125)
    ref = sm.softmax_forward_reference((x * 0.125 + mask).view(-1, 64), 64,
                                       False).view(x.shape)
    torch.testing.assert_close(y, ref, **ROW_FWD_TOL[torch.float32])


def test_row_kernels_raise_on_what_they_lack(dev):
    from deepspeed_tpu_torch.ops.cuda import gelu as gl
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    x = torch.randn(4, 32, device=dev).bfloat16()
    f32 = torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="layer_norm kernels take"):
        ln.layer_norm(x.double(), f32.double(), f32.double())
    with pytest.raises(ValueError, match="layer_norm kernels take"):
        ln.layer_norm(x, f32.half(), f32.half())        # fp16 under bf16
    with pytest.raises(ValueError, match="layer_norm kernels take"):
        ln.layer_norm(x, f32, f32.bfloat16())           # mixed param types
    with pytest.raises(ValueError, match="bias_gelu kernels take"):
        gl.bias_gelu(x, torch.ones(16, device=dev))
    with pytest.raises(ValueError, match="bias_gelu kernels take"):
        gl.gelu(x.double())
    with pytest.raises(ValueError, match="softmax kernels take"):
        sm.fused_softmax(x.double())
    with pytest.raises(ValueError, match="must match"):
        sm.softmax_backward(x, x.float())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_transformer_layer_on_the_card_matches_the_cpu(dev, pre_ln, masked):
    """The layer in f32 on the card (B6, B8 or B1/B1b kernels) against the
    same weights on the CPU (their plain versions): output and every grad
    of the L2 objective, and the kernels' launch counts."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    cfg = DeepSpeedTransformerConfig(hidden_size=256, heads=4, bf16=False,
                                     pre_layer_norm=pre_ln)
    cpu = DeepSpeedTransformerLayer(cfg, generator=torch.Generator()
                                    .manual_seed(0))
    card = DeepSpeedTransformerLayer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 128, 256, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(128)[None, :] < torch.tensor([[128], [77]])).int()
    results = []
    before = dict(_build.LAUNCHES)
    for layer, device in ((cpu, "cpu"), (card, dev)):
        xt = x.to(device, copy=True).requires_grad_()
        out = layer(xt, mask.to(device) if masked else None,
                    deterministic=True)
        out.square().mean().backward()
        results.append([out.detach().cpu(), xt.grad.cpu()]
                       + [p.grad.cpu() for p in layer.parameters()])
    torch.cuda.synchronize()
    want = {"layer_norm_fwd": 2, "layer_norm_dx": 2}
    want.update({"softmax_fwd": 1, "softmax_bwd": 1} if masked else
                {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})
    for name in ("layer_norm_fwd", "layer_norm_dx", "softmax_fwd",
                 "softmax_bwd", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] - before.get(name, 0) \
            == want.get(name, 0), name
    for got, ref in zip(results[1], results[0]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
