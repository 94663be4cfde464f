"""Speculative decoding in the port (deepspeed_tpu_torch/serving/
speculative.py and ServingEngine(speculative=True)) against the TPU
package, on the CPU in f32.

Layered like the subsystem: the n-gram drafter's proposals and the greedy
verifier equal the TPU package's exactly; the rejection verifier is held to
the filtered target distribution by counting (first emitted token's
marginal within total variation 0.02 over 20000 draws, a draft's
acceptance frequency within 0.015 of p(draft), nothing outside top-k); the
k + 1-token verify forward over the engine's arena equals one-token decodes
near the end of a row; then the engine: greedy output ids and acceptance
counts equal to the TPU spec engine's over the dense and paged arenas
(prefix cache on and off), fp and int8 KV, with an EOS mid-chunk, an EOS on
the first token, a budget K does not divide and verify writes that cross
max_seq_len (dense) or the block reservation (paged); equal to the port's
own non-speculative engine; sampled runs reproducible under a seed. The
plain versions run on the CPU, with ``megakernel`` on and off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ServingEngine
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.serving.kv_cache import SlotKVCacheManager
from deepspeed_tpu_torch.serving.paged_kv import PagedKVCacheManager
from deepspeed_tpu_torch.serving.sampling import (filter_logits,
                                                  fused_filter_logits)
from deepspeed_tpu_torch.serving.speculative import (NGramDrafter,
                                                     verify_greedy,
                                                     verify_rejection)

from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

TV_BOUND = 0.02          # first emitted token vs the filtered softmax
ACCEPT_TOL = 0.015       # acceptance frequency vs p(draft): > 4 sigma
N_DRAWS = 20000
VERIFY_ATOL = 1e-5       # f32: a k+1 verify vs one-token decodes


# ------------------------------------------------------------ drafter
def test_ngram_drafter_rejects_bad_orders():
    with pytest.raises(ValueError, match="draft length"):
        NGramDrafter(k=0)
    with pytest.raises(ValueError, match="n-gram order"):
        NGramDrafter(k=4, n=0)
    d = NGramDrafter()
    assert (d.k, d.n) == (4, 2)


def _histories(seed, S=24):
    """Rows of a [B, S] history with their last positions: periodic rows
    (periods 1-5), random rows over a small vocabulary (chance matches),
    all-distinct rows (no match), and positions 0, 1 and S-1."""
    rng = np.random.default_rng(seed)
    rows, pos = [], []
    for period in (1, 2, 3, 4, 5):
        motif = rng.integers(1, 50, period)
        rows.append(np.resize(motif, S))
        pos.append(int(rng.integers(period, S)))
    for _ in range(4):
        rows.append(rng.integers(1, 5, S))
        pos.append(int(rng.integers(0, S)))
    for p in (0, 1, 7, S - 1):
        rows.append(rng.permutation(np.arange(100, 100 + S)))
        pos.append(p)
    rows.append(np.resize(rng.integers(1, 9, 3), S))
    pos.append(S - 1)
    return np.stack(rows).astype(np.int64), np.array(pos, np.int64)


@pytest.mark.parametrize("k", [1, 4, 7])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_proposals_equal_the_tpu_drafter(n, k):
    from deepspeed_tpu.serving.speculative import NGramDrafter as JaxDrafter
    hist, pos = _histories(seed=10 * n + k)
    tok = hist[np.arange(len(pos)), pos]
    ref = np.asarray(JaxDrafter(k, n).propose(
        jnp.asarray(hist, jnp.int32), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32)))
    got = NGramDrafter(k, n).propose(torch.from_numpy(hist),
                                     torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    assert got.shape == (len(pos), k) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    # the all-distinct rows (no earlier occurrence of the trailing n-gram)
    # repeat the last token
    for r in range(9, 13):
        assert (got[r] == int(tok[r])).all()


# ---------------------------------------------------------- verifiers
@pytest.mark.parametrize("k", [1, 3, 5])
def test_verify_greedy_equals_the_tpu_verifier(k):
    """Integer-valued logits so rows hold ties: both take the first
    maximal index."""
    from deepspeed_tpu.serving.speculative import verify_greedy as jverify
    B, V = 64, 8
    rng = np.random.default_rng(k)
    logits = rng.integers(-3, 4, (B, k + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = np.where(rng.random((B, k)) < 0.7, tgt[:, :k],
                      rng.integers(0, V, (B, k)))
    j_emit, j_acc = jverify(jnp.asarray(logits),
                            jnp.asarray(drafts, jnp.int32))
    emit, acc = verify_greedy(torch.from_numpy(logits),
                              torch.from_numpy(drafts))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(j_emit))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    assert set(acc.tolist()) >= {0, k}


def _target(logits, temperature, top_k, top_p):
    return torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                         dim=-1)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.0, None, 0.8), (1.3, 4, 0.9)])
def test_rejection_first_token_marginal_is_the_filtered_softmax(
        temperature, top_k, top_p):
    """Every lane holds the same logits and drafts: position 0's emitted
    token is distributed as the filtered softmax (the draft's acceptance
    plus the residual's resample), position 1's as its own given an
    accepted position 0, and a rejected draft is never re-emitted at its
    position."""
    B, k, V = N_DRAWS, 2, 8
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.normal(size=(1, k + 1, V)).astype(
        np.float32) * 1.5)
    p = _target(base, temperature, top_k, top_p)[0]
    d0 = int(p[0].argmax())                   # high acceptance
    d1 = int(p[1].argsort()[V - 3])           # middling acceptance
    drafts = torch.tensor([[d0, d1]]).repeat(B, 1)
    gen = torch.Generator().manual_seed(0)
    emitted, acc = verify_rejection(base.repeat(B, 1, 1), drafts, gen,
                                    temperature, top_k, top_p)
    freq0 = torch.bincount(emitted[:, 0], minlength=V).double() / B
    tv0 = 0.5 * float((freq0 - p[0].double()).abs().sum())
    assert tv0 <= TV_BOUND, tv0
    sel = acc >= 1
    freq1 = torch.bincount(emitted[sel, 1], minlength=V).double() / \
        int(sel.sum())
    tv1 = 0.5 * float((freq1 - p[1].double()).abs().sum())
    assert tv1 <= 2 * TV_BOUND, tv1           # about half the draws
    assert not (emitted[acc == 0, 0] == d0).any()
    assert not (emitted[acc == 1, 1] == d1).any()


def test_rejection_through_the_fused_filter_keeps_the_marginal():
    """``filter_fn=fused_filter_logits`` (the megakernel's route: the
    sampling kernel's plain version on a CPU tensor at V = 128) gives the
    same distribution."""
    B, k, V, top_k = N_DRAWS, 1, 128, 10
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.normal(size=(1, k + 1, V)).astype(
        np.float32) * 2)
    p = torch.softmax(fused_filter_logits(base, 0.9, top_k, 0.95), -1)[0]
    assert torch.allclose(p, _target(base, 0.9, top_k, 0.95)[0])
    drafts = torch.full((B, k), int(p[0].argsort()[V - 2]))
    emitted, acc = verify_rejection(
        base.repeat(B, 1, 1), drafts, torch.Generator().manual_seed(1), 0.9,
        top_k, 0.95, filter_fn=fused_filter_logits)
    freq0 = torch.bincount(emitted[:, 0], minlength=V).double() / B
    assert 0.5 * float((freq0 - p[0].double()).abs().sum()) <= TV_BOUND


@pytest.mark.parametrize("rank", [0, 1, 3, 6])
def test_rejection_accepts_a_draft_with_probability_p_of_the_draft(rank):
    """The acceptance frequency of draft d at position 0 is p0(d); a draft
    outside top-k (rank 6 of top_k 5) is never accepted."""
    B, V, top_k = N_DRAWS, 8, 5
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.normal(size=(1, 2, V)).astype(np.float32))
    p = _target(base, 1.0, top_k, None)[0]
    d = int(p[0].argsort(descending=True)[rank])
    emitted, acc = verify_rejection(
        base.repeat(B, 1, 1), torch.full((B, 1), d),
        torch.Generator().manual_seed(rank), 1.0, top_k, None)
    freq = float((acc >= 1).double().mean())
    assert abs(freq - float(p[0, d])) <= ACCEPT_TOL, (freq, float(p[0, d]))
    if rank >= top_k:
        assert freq == 0.0


def test_rejection_never_emits_outside_top_k():
    B, k, V, top_k = 512, 3, 16, 3
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(B, k + 1, V)).astype(
        np.float32))
    allowed = logits.argsort(-1)[..., -top_k:]
    drafts = allowed[:, :k, -1]               # inside the filter
    emitted, acc = verify_rejection(logits, drafts,
                                    torch.Generator().manual_seed(2), 1.0,
                                    top_k, None)
    for b in range(B):
        for j in range(int(acc[b]) + 1):
            assert int(emitted[b, j]) in allowed[b, j].tolist()


# ----------------------------------------------- the verify forward
@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_forward_near_the_row_end_equals_one_token_decodes(pair,
                                                                  paged):
    """GPT.decode of k + 1 tokens at positions pos..pos+k, over the arena a
    speculative engine builds (k positions of lookahead past max_seq_len),
    gives each query below max_seq_len the logits of a one-token decode at
    its position, also where pos + k + 1 crosses max_seq_len. Through the
    decode kernel's plain version (decode_impl "auto") and the einsum.
    Without the lookahead the kernel's cache length is clamped to S and
    the first query's causal window shifts."""
    pm = pair[2]
    cfg = pm.cfg
    S, k, B = cfg.max_seq_len, 3, 3
    rng = np.random.default_rng(0)
    fills = np.array([S - 2, S - 4, 20])
    ids = torch.from_numpy(rng.integers(1, 256, (B, S)))
    inputs = torch.from_numpy(rng.integers(1, 256, (B, k + 1)))

    def arena(lookahead):
        if not paged:
            kv = SlotKVCacheManager(cfg, B, "cpu", lookahead=lookahead)
        else:
            kv = PagedKVCacheManager(cfg, B, "cpu", block_size=8,
                                     prefix_caching=False,
                                     lookahead=lookahead)
            for b in range(B):
                kv.allocator.alloc(int(fills[b]))
        with torch.inference_mode():
            _, keys, values = pm.prefill(ids)
        if paged:
            kv.allocator.fill[:] = fills
        kv.insert_batch(keys, values, range(B))
        if not paged:
            kv.allocator.fill[:] = fills
        return kv

    def decode(kv, toks, pos, impl):
        return pm.decode(toks, pos.clamp(max=S - 1), kv.cache_k, kv.cache_v,
                         pos[:, 0], decode_impl=impl,
                         block_tables=kv.block_tables)

    pos0 = torch.from_numpy(fills)
    qpos = pos0[:, None] + torch.arange(k + 1)
    for impl in ("auto", "xla"):
        kv = arena(k)
        with torch.inference_mode():
            spec = decode(kv, inputs, qpos, impl)
            one = arena(k)
            for j in range(k + 1):
                ref = decode(one, inputs[:, j:j + 1], qpos[:, j:j + 1],
                             impl)[:, 0]
                live = qpos[:, j] < S
                torch.testing.assert_close(spec[live, j], ref[live],
                                           atol=VERIFY_ATOL, rtol=0)
    if not paged:
        with torch.inference_mode():
            clamped = decode(arena(0), inputs, qpos, "auto")
        assert (clamped[0, 0] - spec[0, 0]).abs().max() > 1e-3


# ------------------------------------------------------------ engine
# the arenas of the engine comparisons: (name, ServingEngine keywords)
ARENAS = {
    "dense": {},
    "dense_int8": dict(kv_dtype="int8"),
    "paged_prefix": dict(paged=True, kv_block_size=8),
    "paged_no_prefix": dict(paged=True, kv_block_size=8, prefix_cache=False),
    "paged_int8": dict(paged=True, kv_block_size=8, kv_dtype="int8"),
}
SPEC = dict(speculative=True, spec_k=3, decode_chunk=4)
BASE = dict(max_batch=3, max_prompt_len=64, max_queue=16)


def _requests(paged):
    """(prompt, max_new_tokens, eos index) per request: an EOS mid-chunk
    (token 2 of the unconstrained run), an EOS on the first token, budgets
    K does not divide, a repeat (a prefix-cache hit), and budgets that end
    at max_seq_len (dense: verify writes cross S) or, paged, at the end of
    a block reservation 8 positions below S, which verify writes cross
    (the TPU package's paged attention clamps a cache length past S and
    shifts the verify queries there, ROADMAP C)."""
    rng = np.random.default_rng(21)
    p = [rng.integers(1, 256, n).astype(np.int32)
         for n in (9, 13, 6, 17, 50, 58, 37)]
    near = [(p[4], 14), (p[5], 6)] if not paged else [(p[4], 6), (p[6], 19)]
    return [(p[0], 11, 2), (p[1], 11, 0), (p[2], 10, None), (p[3], 7, None),
            (p[2].copy(), 10, None)] + [(q, m, None) for q, m in near]


def _serve(eng, reqs, eos_ids):
    out = [eng.submit(p.copy(), max_new_tokens=m, eos_token_id=e)
           for (p, m, _), e in zip(reqs, eos_ids)]
    eng.run()
    return out


_EOS = {}


def _eos_ids(pmodel, reqs, name, paged_requests):
    """Each request's EOS id: the token at its eos index in an
    unconstrained run of the port's non-speculative engine (once per
    arena and request set)."""
    key = (name, paged_requests)
    if key not in _EOS:
        base = _serve(ServingEngine(pmodel, device="cpu",
                                    dtype=torch.float32, decode_chunk=4,
                                    **BASE, **ARENAS[name]),
                      reqs, [None] * len(reqs))
        _EOS[key] = [None if i is None else int(r.tokens[i])
                     for r, (_, _, i) in zip(base, reqs)]
    return _EOS[key]


_JAX_RUNS = {}


def _jax_spec_run(pair, name):
    """The TPU spec engine's requests and acceptance counts, once per
    arena (greedy: its megakernel switch does not change its tokens)."""
    if name not in _JAX_RUNS:
        from deepspeed_tpu.serving import ServingEngine as JaxServing
        jmodel, params, pmodel = pair
        arena = ARENAS[name]
        paged = arena.get("paged", False)
        reqs = _requests(paged)
        eos = _eos_ids(pmodel, reqs, name, paged)
        eng = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                         megakernel=True, **SPEC, **BASE, **arena)
        out = _serve(eng, reqs, eos)
        _JAX_RUNS[name] = (reqs, eos, out, eng.metrics.spec_proposed,
                           eng.metrics.spec_accepted)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_spec_greedy_equals_the_tpu_spec_engine(pair, arena, megakernel):
    reqs, eos, ref, proposed, accepted = _jax_spec_run(pair, arena)
    eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                        megakernel=megakernel, **SPEC, **BASE,
                        **ARENAS[arena])
    before = dict(_build.LAUNCHES)
    out = _serve(eng, reqs, eos)
    assert dict(_build.LAUNCHES) == before       # plain versions on the CPU
    for r, o in zip(ref, out):
        assert o.status == r.status == "done"
        np.testing.assert_array_equal(o.output_ids, r.output_ids)
    assert len(out[0].tokens) < 11               # the EOS mid-chunk
    assert len(out[1].tokens) == 1               # the EOS on token #1
    assert (eng.metrics.spec_proposed, eng.metrics.spec_accepted) == \
        (proposed, accepted)
    assert proposed > 0 and accepted > 0
    if arena == "paged_prefix":
        assert eng.metrics.n_prefix_hits >= 1
    if ARENAS[arena].get("paged"):
        kv = eng.kv
        assert kv.allocator.blocks.n_free + kv.prefix_cache.blocks_held \
            == kv.num_blocks


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_spec_greedy_equals_the_non_spec_engine(pair, arena, megakernel):
    """Against the port's own non-speculative engine (one token a step),
    paged budgets included that end at max_seq_len."""
    pmodel = pair[2]
    reqs = _requests(paged=False)
    kw = dict(device="cpu", dtype=torch.float32, megakernel=megakernel,
              **BASE, **ARENAS[arena])
    eos = _eos_ids(pmodel, reqs, arena, False)
    ref = _serve(ServingEngine(pmodel, decode_chunk=4, **kw), reqs, eos)
    out = _serve(ServingEngine(pmodel, **SPEC, **kw), reqs, eos)
    for r, o in zip(ref, out):
        assert o.status == r.status == "done"
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("arena", ["dense", "paged_no_prefix"])
def test_spec_sampled_is_reproducible_under_a_seed(pair, arena, megakernel):
    """temperature / top-k / top-p through the speculative loop: the same
    seed gives the same streams, another seed others; every token is a
    vocabulary id."""
    rng = np.random.default_rng(6)
    ps = [rng.integers(1, 256, 5).astype(np.int32) for _ in range(4)]

    def run(seed):
        eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                            megakernel=megakernel, temperature=1.0, top_k=8,
                            top_p=0.95, seed=seed, **SPEC, **BASE,
                            **ARENAS[arena])
        out = eng.run([p.copy() for p in ps], max_new_tokens=9)
        assert all(r.status == "done" and len(r.tokens) == 9 for r in out)
        assert all(0 <= t < 256 for r in out for t in r.tokens)
        assert eng.metrics.spec_proposed > 0
        return [r.tokens for r in out]

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_a_custom_drafter_and_the_spec_metrics(pair):
    """``drafter=`` takes any object with ``k`` and ``propose``; a drafter
    that always proposes the greedy continuation's first token is verified
    like any other, and the snapshot reports the acceptance rate."""
    class Repeat:
        k = 2

        def propose(self, hist, tok, pos):
            return tok[:, None].repeat(1, self.k)

    kw = dict(device="cpu", dtype=torch.float32, **BASE)
    ps = [np.arange(1, 9, dtype=np.int32), np.full(6, 7, np.int32)]
    ref = ServingEngine(pair[2], **kw).run([p.copy() for p in ps],
                                           max_new_tokens=8)
    eng = ServingEngine(pair[2], speculative=True, drafter=Repeat(),
                        spec_k=9, **kw)
    assert eng.spec_k == 2
    out = eng.run([p.copy() for p in ps], max_new_tokens=8)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.output_ids, r.output_ids)
    m = eng.metrics
    assert m.spec_proposed > 0 and m.spec_proposed % 2 == 0
    snap = m.snapshot(0, 0.0)
    assert snap["serving/spec_acceptance_rate"] == \
        m.spec_accepted / m.spec_proposed
    assert ServingEngine(pair[2], **kw).metrics.spec_acceptance_rate == 0.0


@pytest.mark.parametrize("s", [1, 2, 5])
@pytest.mark.parametrize("scales", [False, True])
def test_dense_kv_write_drops_past_the_row_in_one_scatter(s, scales):
    """The dense arena's write of s columns per row (a verify writes k + 1)
    equals a column-by-column loop that skips positions past the row,
    rows at the start, in the middle, crossing the end, at the sentinel
    and past it; the scatter's repeated indices carry equal values."""
    from deepspeed_tpu_torch.models.gpt import _kv_write
    g = torch.Generator().manual_seed(s)
    shape = (6, 12) if scales else (6, 12, 8)
    arena = torch.randn(2, *shape, generator=g)
    want = arena.clone()
    kv = torch.randn(shape[0], s, *shape[2:], generator=g)
    cur = torch.tensor([0, 5, 10, 11, 12, 40])
    _kv_write(arena[1], kv, cur)
    for r in range(shape[0]):
        for j in range(s):
            if int(cur[r]) + j < shape[1]:
                want[1, r, int(cur[r]) + j] = kv[r, j]
    assert torch.equal(arena, want)
