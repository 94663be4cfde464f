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


# bf16 inputs: the plain version rounds its probabilities to bf16, the
# kernel keeps them in f32; f32 inputs differ only in summation order
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


# 50304 (GPT-2) stages the row in shared memory; 131072 is past the staging
# budget and reads the row from device memory on every pass
@pytest.mark.parametrize("V", [50304, 131072])
def test_sampling_kernel_matches_plain(dev, V):
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    g = torch.Generator(device=dev).manual_seed(0)
    b = 6
    assert sp.sampling_supported(b, V)
    x = torch.randn(b, V, device=dev, generator=g) * 4
    x[0, 11] = x[0, 13] = x[0].max() + 1          # tie at the top
    gum = -torch.log(-torch.log(torch.rand(b, V, device=dev, generator=g)
                                .clamp_min(1e-30)))
    greedy = sp.fused_sample(x, None, 0.0, None)
    assert torch.equal(greedy, sp.fused_sample_reference(x, None, None,
                                                         None))
    assert int(greedy[0]) == 11
    for top_k, top_p in ((50, None), (1, None), (None, 0.9), (40, 0.7)):
        kern = sp.threshold_filter_logits(x, 1.3, top_k, top_p)
        ref = sp.filter_rows_reference(x / 1.3, top_k, top_p)
        if top_p is None:
            assert torch.equal(kern, ref)
        else:
            assert torch.equal(kern > -1e9, ref > -1e9)
        drawn = sp.fused_sample(x, gum, 1.3, top_k, top_p).long()
        assert (kern[torch.arange(b, device=dev), drawn] > -1e9).all()


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
# f32 kernels use CUDA-core FMAs); the bf16 kernels round p and ds to bf16
# for the tensor-core products and both sides round their outputs to bf16
# (1 bf16 ulp is 2^-8 relative), so the bound is relative plus a floor
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qkv_views(dev, B, S, H, d, dtype, seed):
    """q, k, v as strided views of one fused [B, S, 3*H*d] tensor (the
    model's qkv projection), and a random dO."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * d, device=dev, generator=g).to(dtype)
    q, k, v = (t.view(B, S, H, d) for t in qkv.split(H * d, -1))
    do = torch.randn(B, S, H, d, device=dev, generator=g).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("S", [1024, 1000, 77])
def test_flash_kernels_match_plain(dev, dtype, causal, d, S):
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    B, H, scale = 2, 3, 1 / d ** 0.5
    q, k, v, do = _qkv_views(dev, B, S, H, d, dtype, S + d)
    before = dict(_build.LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, causal, scale)
    ref_out, ref_lse = fa.flash_attention_forward_reference(q, k, v, causal,
                                                            scale)
    grads = fa.flash_attention_backward(q, k, v, ref_out, ref_lse, do,
                                        causal, scale)
    refs = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse,
                                                 do, causal, scale)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    torch.testing.assert_close(out.float(), ref_out.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[dtype])


def test_flash_raises_on_a_head_dim_the_kernels_lack(dev):
    """attention_impl="auto" on the card never gives way to the einsum."""
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    q = torch.randn(1, 16, 2, 48, device=dev)
    with pytest.raises(ValueError, match="flash kernels take"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="flash kernels take"):
        fa.flash_attention(q.half(), q.half(), q.half())
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
# f32 and bf16, layout blocks 16-128, causal and not, with and without a
# key-padding mask, S a multiple of the 64-row tile or not, q/k/v as views
# of a fused qkv. Tolerances as for flash (same arithmetic in each family)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,S", [(32, 1536), (64, 2048)])
def test_sparse_dkv_split_rows_match_plain(dev, dtype, causal, block, S):
    """Global key tiles seen by more than 16 query tiles: the dk/dv kernel
    splits their column-LUT rows over several blocks (a workspace partial
    each, the last block sums them in item order and stores), so a second
    call gives bitwise the same dk and dv."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    cfg = BigBirdSparsityConfig(num_heads=2, block=block)
    layout = compiled_layout(cfg, S, causal)
    assert layout.dkv_parts > 0
    q, k, v, do = _qkv_views(dev, 2, S, 2, 64, dtype, S)
    kvm = torch.ones(2, S, device=dev)
    kvm[1, S // 3:] = 0
    for mask in (None, kvm):
        out, lse, _ = _sparse_check(dev, cfg, q, k, v, do, causal, mask,
                                    dtype)
        grads = [sa.sparse_attention_backward(q, k, v, out, lse, do,
                                              layout.on(dev), 1 / 8, mask)
                 for _ in range(4)]
        for again in grads[1:]:
            assert all(torch.equal(a, g) for a, g in zip(again, grads[0]))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
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
    q = torch.randn(1, 64, 2, 48, device=dev)
    with pytest.raises(ValueError, match="sparse kernels take"):
        sparse_attention(q, q, q, cfg)
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="sparse kernels take"):
        sparse_attention(q.half(), q.half(), q.half(), cfg)
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
