"""Self-drafting speculative decoding for the chunked serving loop.

Counterpart of ``deepspeed_tpu/serving/speculative.py`` (Leviathan et al.,
"Fast Inference from Transformers via Speculative Decoding"): a cheap
drafter proposes k tokens, the target model scores all k+1 positions in one
batched forward, and an accept-prefix + rejection-resampling rule emits
between 1 and k+1 tokens whose joint distribution is exactly the target
model's. Everything here is tensor code on the caller's device with no host
read (no ``.item()``, no boolean-mask indexing, no ``nonzero``): the serving
engine runs it inside a launched decode chunk (serving/engine.py
``_spec_chunk``), whose token buffer the host reads once per chunk.

The built-in drafter is prompt lookup (n-gram): find the most recent
earlier occurrence of the trailing n-gram of the lane's history and propose
its continuation. The :class:`Drafter` protocol keeps the slot open for a
draft model: anything with a ``k`` attribute and a
``propose(hist, tok, pos) -> [B, k]`` method works.

Exactness:
  * greedy (temperature 0): verification accepts the longest prefix where
    draft == argmax(target) (first index on ties, as ``jnp.argmax``); the
    emitted tokens are argmax(target) at every position up to and including
    the first mismatch, the sequence the one-token loop produces;
  * sampled (temperature > 0): a delta drafter (q = 1 on the proposed
    token) accepts draft d_j with probability p_j(d_j); the first rejection
    resamples from the residual, p_j with d_j zeroed and renormalized, and
    a fully accepted step draws a bonus token from p_k. The categorical
    draws are Gumbel-max over the log-probabilities (the draw
    ``jax.random.categorical`` makes), with noise from the caller's
    ``torch.Generator``: the same distribution, another random stream.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import torch

from .sampling import filter_logits, gumbel_noise


class Drafter(Protocol):
    """Pluggable draft-proposal strategy. ``propose`` runs inside a
    launched chunk, so it must not read device data on the host. It is
    called with the device history ``hist`` [B, S] (row b's tokens
    0..pos[b], prompt + emitted, with ``hist[b, pos[b]] == tok[b]``), the
    current last token ``tok`` [B] and its position ``pos`` [B]; it returns
    k proposed continuation tokens [B, k] of ``hist``'s dtype."""

    k: int

    def propose(self, hist: torch.Tensor, tok: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor: ...


class NGramDrafter:
    """Prompt-lookup decoding (n-gram self-drafting): match the trailing
    ``n``-gram of each lane's history against every earlier position and
    continue from just after the most recent match, wrapping with the match
    period so all k proposals come from real history. Lanes with no match
    propose ``tok`` repeated."""

    def __init__(self, k: int = 4, n: int = 2):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.k = int(k)
        self.n = int(n)

    def propose(self, hist: torch.Tensor, tok: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        B, S = hist.shape
        k, n = self.k, self.n
        dev = hist.device
        hlen = pos.long() + 1                            # tokens in history
        idx = torch.arange(S, device=dev)[None, :]       # candidate ends
        match = torch.ones((B, S), dtype=torch.bool, device=dev)
        for t in range(n):
            # hist[b, idx - t] == hist[b, hlen-1-t]: the roll brings
            # position idx-t to column idx (the wrapped columns are
            # excluded by the idx >= n-1 mask below); the gather index is
            # clipped into the row first, as the TPU package's
            # take_along_axis clips it
            ref_t = torch.gather(hist, 1,
                                 (hlen - 1 - t).clamp(0, S - 1)[:, None])
            match = match & (torch.roll(hist, t, dims=1) == ref_t)
        valid = match & (idx >= n - 1) & (idx < hlen[:, None] - 1)
        jstar = torch.where(valid, idx, -1).amax(dim=1)          # [B]
        found = jstar >= 0
        # continue after the match, wrapping with the period so proposals
        # past the matched span re-walk the repeating cycle
        period = (hlen - 1 - jstar).clamp(min=1)
        i = torch.arange(k, device=dev)[None, :]
        src = (jstar[:, None] + 1 + i % period[:, None]).clamp(0, S - 1)
        drafts = torch.gather(hist, 1, src)
        return torch.where(found[:, None], drafts,
                           tok.to(hist.dtype)[:, None])


def verify_greedy(logits: torch.Tensor, drafts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy verification. ``logits`` [B, k+1, V]: target scores at the
    k+1 positions fed (last token + k drafts); ``drafts`` [B, k]. Returns
    ``(emitted [B, k+1], acc [B])``: ``acc`` counts accepted drafts (0..k)
    and positions 0..acc of ``emitted`` are the real output (acc+1
    tokens)."""
    tgt = torch.argmax(logits, dim=-1).to(drafts.dtype)     # [B, k+1]
    k = drafts.shape[1]
    ok = (drafts == tgt[:, :k]).long()
    acc = ok.cumprod(dim=1).sum(dim=1)                       # [B]
    return tgt, acc


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``softmax(logits)``: Gumbel-max."""
    g = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + g, dim=-1)


def _log_mass(p: torch.Tensor) -> torch.Tensor:
    """log p where p > 0, -1e9 elsewhere (never drawn)."""
    return torch.where(p > 0, torch.log(p.clamp(min=1e-30)), -1e9)


def verify_rejection(logits: torch.Tensor, drafts: torch.Tensor,
                     generator: Optional[torch.Generator],
                     temperature: float, top_k: Optional[int],
                     top_p: Optional[float], filter_fn=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-resampling verification at temperature > 0 against the
    same filtered distribution ``sample_tokens`` draws from (temperature,
    top-k, top-p before the softmax; serving/sampling.py ``filter_logits``).
    Draft j is accepted with probability p_j(d_j); the first rejected
    position resamples from the residual (p_j with the draft's mass zeroed,
    renormalized), and a fully accepted step draws a bonus token from p_k.
    Returns ``(emitted [B, k+1], acc [B])`` with positions 0..acc real; the
    emitted tokens are distributed exactly as k+1 sequential draws.

    ``filter_fn`` overrides the logit filter (the megakernel engine passes
    serving/sampling.fused_filter_logits, so the [B*(k+1), V] rows go
    through the sampling kernel in one launch); it must keep
    filter_logits' masked-logit contract. Randomness: ``generator``."""
    if filter_fn is None:
        filter_fn = filter_logits
    B, kp1, V = logits.shape
    k = kp1 - 1
    dev = logits.device
    probs = torch.softmax(filter_fn(logits, temperature, top_k, top_p),
                          dim=-1)
    # a draft is a token id, so in range; clipped anyway, since an index
    # out of range is a device-side assert on a CUDA tensor
    d = drafts.long().clamp(0, V - 1)[..., None]
    p_draft = torch.gather(probs[:, :k], -1, d)[..., 0]        # [B, k]
    u = torch.rand((B, k), generator=generator, device=dev)
    accept = u < p_draft
    acc = accept.long().cumprod(dim=1).sum(dim=1)
    # the residual at every draft position (only position ``acc`` is used):
    # the rejected draft's mass zeroed; the draw renormalizes
    res = probs[:, :k].scatter(-1, d, 0.0)
    rescue = _categorical(_log_mass(res), generator)            # [B, k]
    bonus = _categorical(_log_mass(probs[:, k]), generator)     # [B]
    correction = torch.cat([rescue, bonus[:, None]], dim=1).to(drafts.dtype)
    drafts_pad = torch.cat([drafts, drafts.new_zeros((B, 1))], dim=1)
    j = torch.arange(kp1, device=dev)[None, :]
    emitted = torch.where(j < acc[:, None], drafts_pad, correction)
    return emitted, acc
