"""The port's ServingEngine against the TPU package's keyword list: every
keyword of the TPU ``ServingEngine`` is either taken by the port or named in
``NOT_PORTED_KNOBS``; a not-ported knob set away from its default raises
``NotImplementedError`` naming its ROADMAP item (with or without
``engine=``), never a silent no-op; ``tp`` (ported) set to 2 on a one-rank
world raises a ``ValueError`` (no tp-2 mesh there; with ``engine=`` the
engine's tp 1 mismatches, the JAX engine's error); ``sp_prefill_threshold``
(ported) is taken; with ``engine=`` any other leftover
keyword raises ``TypeError``; the defaults, passed explicitly, still build
and serve; the speculative and the fused-prefill knobs, ported, build and
serve away from their defaults, and fused + speculative sampling raises the
JAX engine's ``ValueError``. On the CPU, f32, a tiny GPT."""

import inspect

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ServingEngine
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.serving.engine import NOT_PORTED_KNOBS
from torch_test_threads import one_torch_thread  # noqa: F401

# a value away from each knob's default
NON_DEFAULT = {
    "sp_prefill_threshold": 8, "monitor": object(), "emit_every_steps": 4,
    "tp": 2, "disaggregate_prefill": True, "tiered_kv": True,
    "tier_dram_bytes": 1 << 20, "tier_nvme_bytes": 1 << 30,
    "tier_spill_dir": "spill", "tuned_config": {"max_batch": 4},
}


# the knobs ported since the list was made: taken, not refused
PORTED = {"tp", "sp_prefill_threshold"}


def _model():
    cfg = GPTConfig(vocab_size=128, max_seq_len=32, num_layers=1,
                    num_heads=2, d_model=64, d_ff=128, dtype=torch.float32)
    model = GPT(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def test_every_tpu_keyword_is_taken_or_named():
    from deepspeed_tpu.serving.engine import ServingEngine as JaxServing
    jax_kw = set(inspect.signature(JaxServing.__init__).parameters)
    port_kw = set(inspect.signature(ServingEngine.__init__).parameters)
    assert set(NON_DEFAULT) == set(NOT_PORTED_KNOBS) | PORTED
    assert PORTED <= port_kw
    assert not set(NOT_PORTED_KNOBS) & port_kw
    assert jax_kw - port_kw == set(NOT_PORTED_KNOBS)
    params = inspect.signature(JaxServing.__init__).parameters
    for name, (default, _) in NOT_PORTED_KNOBS.items():
        assert params[name].default == default, name


@pytest.mark.parametrize("via_engine", [False, True])
@pytest.mark.parametrize("name", sorted(NON_DEFAULT))
def test_a_knob_set_away_from_its_default_raises(name, via_engine):
    kw = dict(device="cpu", dtype=torch.float32)
    if via_engine:
        kw = dict(engine=InferenceEngine(_model(), **kw))
        model = None
    else:
        model = _model()
    if name == "tp":
        match = ("the engine's mesh has tp=1" if via_engine
                 else "1 devices not divisible")
        with pytest.raises(ValueError, match=match):
            ServingEngine(model, max_batch=2, tp=2, **kw)
        return
    if name == "sp_prefill_threshold":
        # ported (tests/test_torch_sequence_parallel.py): taken, and a
        # prompt at the threshold takes the sp leg, a shorter one does not
        eng = ServingEngine(model, max_batch=2, **{name: NON_DEFAULT[name]},
                            **kw)
        assert eng.sp_prefill_threshold == NON_DEFAULT[name]
        eng.run([np.arange(1, 9), np.arange(1, 5)], max_new_tokens=2)
        assert (eng.sp_prefill_tokens, eng.inline_prefill_tokens) == (8, 0)
        return
    item = NOT_PORTED_KNOBS[name][1]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\b"):
        ServingEngine(model, max_batch=2, **{name: NON_DEFAULT[name]}, **kw)


def test_a_leftover_keyword_with_engine_raises_type_error():
    eng = InferenceEngine(_model(), device="cpu", dtype=torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        ServingEngine(engine=eng, dtype=torch.float32)
    with pytest.raises(TypeError, match="no_such_knob"):
        ServingEngine(engine=eng, no_such_knob=1)


@pytest.mark.parametrize("via_engine", [False, True])
def test_the_defaults_still_build_and_serve(via_engine):
    defaults = {n: d for n, (d, _) in NOT_PORTED_KNOBS.items()}
    kw = dict(device="cpu", dtype=torch.float32)
    if via_engine:
        eng = ServingEngine(engine=InferenceEngine(_model(), **kw),
                            max_batch=2, megakernel=True, **defaults)
    else:
        eng = ServingEngine(_model(), max_batch=2, megakernel=True,
                            **defaults, **kw)
    out = eng.run([np.arange(1, 6), np.arange(3, 12)], max_new_tokens=4)
    assert [r.status for r in out] == ["done", "done"]
    assert [len(r.tokens) for r in out] == [4, 4]


class _LastToken:
    """A drafter: any object with ``k`` and ``propose``."""
    k = 3

    def propose(self, hist, tok, pos):
        return tok[:, None].repeat(1, self.k)


# each speculative knob away from its default (the TPU engine's 4 and 2)
SPEC_KNOBS = {"speculative": dict(speculative=True),
              "spec_k": dict(speculative=True, spec_k=2),
              "spec_ngram": dict(speculative=True, spec_ngram=3),
              "drafter": dict(speculative=True, drafter=_LastToken())}


@pytest.mark.parametrize("name", sorted(SPEC_KNOBS))
def test_each_spec_knob_builds_and_serves(name):
    from deepspeed_tpu.serving.engine import ServingEngine as JaxServing
    params = inspect.signature(JaxServing.__init__).parameters
    port = inspect.signature(ServingEngine.__init__).parameters
    assert port[name].default == params[name].default
    kw = SPEC_KNOBS[name]
    eng = ServingEngine(_model(), device="cpu", dtype=torch.float32,
                        max_batch=2, megakernel=True, **kw)
    assert eng.speculative and eng._chunked
    assert eng.spec_k == {"spec_k": 2, "drafter": 3}.get(name, 4)
    if name == "spec_ngram":
        assert eng.drafter.n == 3
    out = eng.run([np.arange(1, 6), np.arange(3, 12)], max_new_tokens=6)
    assert [r.status for r in out] == ["done", "done"]
    assert [len(r.tokens) for r in out] == [6, 6]
    assert eng.metrics.spec_proposed > 0


# each fused-prefill knob away from its default (the TPU engine's False, 16,
# None); the chunk and the budget act only with fused_prefill
FUSED_KNOBS = {"fused_prefill": dict(fused_prefill=True),
               "prefill_chunk": dict(fused_prefill=True, prefill_chunk=4),
               "chunk_token_budget": dict(fused_prefill=True,
                                          chunk_token_budget=5)}


@pytest.mark.parametrize("via_engine", [False, True])
@pytest.mark.parametrize("name", sorted(FUSED_KNOBS))
def test_each_fused_knob_builds_and_serves(name, via_engine):
    from deepspeed_tpu.serving.engine import ServingEngine as JaxServing
    params = inspect.signature(JaxServing.__init__).parameters
    port = inspect.signature(ServingEngine.__init__).parameters
    assert port[name].default == params[name].default
    kw = dict(device="cpu", dtype=torch.float32)
    if via_engine:
        kw = dict(engine=InferenceEngine(_model(), **kw))
        model = None
    else:
        model = _model()
    eng = ServingEngine(model, max_batch=2, megakernel=True,
                        **FUSED_KNOBS[name], **kw)
    assert eng.fused_prefill and eng._chunked
    assert eng.prefill_chunk == (4 if name == "prefill_chunk" else 16)
    # not speculative: the step is C wide (no verify width) and the arena
    # holds C - 1 positions of lookahead
    assert eng.spec_k == 0 and eng._width == eng.prefill_chunk
    assert eng.paged or (eng._kv_extent
                         == eng.max_seq_len + eng.prefill_chunk - 1)
    assert eng.chunk_token_budget == {
        "chunk_token_budget": 5}.get(name, 2 * eng.prefill_chunk + 2)
    out = eng.run([np.arange(1, 6), np.arange(3, 12)], max_new_tokens=4)
    assert [r.status for r in out] == ["done", "done"]
    assert [len(r.tokens) for r in out] == [4, 4]
    assert eng.inline_prefill_tokens == 5 + 9
    assert eng.metrics.prefill_programs == 0


def test_fused_speculative_sampling_raises_like_jax():
    """Fused prefill with speculative decoding verifies greedily: at a
    temperature above 0 the port refuses it with the JAX engine's
    ValueError (test_torch_fused_prefill.py holds the two side by side);
    greedy it builds, a step max(C, k + 1) wide."""
    with pytest.raises(ValueError, match="greedy sampling only"):
        ServingEngine(_model(), device="cpu", dtype=torch.float32,
                      fused_prefill=True, speculative=True, temperature=0.8)
    eng = ServingEngine(_model(), device="cpu", dtype=torch.float32,
                        fused_prefill=True, speculative=True)
    assert eng._width == max(eng.prefill_chunk, eng.spec_k + 1)
