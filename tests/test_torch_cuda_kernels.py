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
