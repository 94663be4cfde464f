"""The port's BERT family (models/bert.py) on the CPU against the TPU
package's, f32, tiny sizes, weights from a JAX init through
``convert.bert_params_to_state_dict`` (stacked and per-layer trees):

  * ``BertModel`` sequence and pooled outputs and ``BertForMaskedLM``
    logits, MLM loss and every parameter grad, on the "xla" path (masked
    einsum) and the "sparse" path (BigBird layout with the padding as a
    key-padding mask; the sparse kernels in interpret mode on the JAX side),
    tolerances as in tests/test_bert_sparse.py;
  * ``pad_to_block_size`` end to end: a padded sparse BERT's real
    positions equal the dense model's on the unpadded input;
  * the config: the same validation and presets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import sparsity_pair

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BASE = dict(vocab_size=128, max_seq_len=128, type_vocab_size=2,
            num_layers=2, num_heads=2, d_model=64, d_ff=128,
            hidden_dropout=0.0)
SPARSE = ("BigBirdSparsityConfig", dict(num_heads=2, block=16,
                                        num_random_blocks=1))


def bert_pair(cls_name="BertModel", seed=0, sparse=None, **overrides):
    """(jax_model, jax_params, port_model) with identical f32 weights."""
    from deepspeed_tpu.models import bert as jbert
    from deepspeed_tpu_torch.convert import bert_params_to_state_dict
    from deepspeed_tpu_torch.models import bert as pbert
    kw = dict(BASE, **overrides)
    jcfg = jbert.BertConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    params = getattr(jbert, cls_name)(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32))["params"]
    kw.pop("scan_layers", None)
    pkw = {}
    if sparse is not None:
        jsp, psp = sparsity_pair(sparse[0], **sparse[1])
        jcfg = dataclasses.replace(jcfg, attention_impl="sparse",
                                   sparse_attention=jsp)
        pkw = dict(attention_impl="sparse", sparse_attention=psp)
    pcfg = pbert.BertConfig(**kw, **pkw)
    pmodel = getattr(pbert, cls_name)(pcfg)
    pmodel.load_state_dict(bert_params_to_state_dict(
        jax.tree.map(np.asarray, params), pcfg))
    return getattr(jbert, cls_name)(jcfg), params, pmodel


def _batch(seed, b=2, s=64, real=(64, 37)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BASE["vocab_size"], (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(real)[:, None]).astype(
        np.int32)
    return ids, types, mask


IMPLS = {"xla": None, "sparse": SPARSE}


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_bert_model_matches_jax(impl, scan_layers):
    jmodel, params, pmodel = bert_pair(seed=1, sparse=IMPLS[impl],
                                       scan_layers=scan_layers)
    ids, types, mask = _batch(2)
    jseq, jpool = jmodel.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(types), jnp.asarray(mask))
    with torch.no_grad():
        seq, pool = pmodel(*(torch.from_numpy(x).long()
                             for x in (ids, types, mask)))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **FWD)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), **FWD)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_mlm_loss_and_grads_match_jax(impl):
    from deepspeed_tpu_torch.convert import bert_params_to_state_dict
    jmodel, params, pmodel = bert_pair("BertForMaskedLM", seed=3,
                                       sparse=IMPLS[impl])
    ids, types, mask = _batch(4)
    labels = np.random.default_rng(5).integers(
        0, BASE["vocab_size"], ids.shape).astype(np.int32)
    picked = (np.random.default_rng(6).random(ids.shape) < 0.3) * mask

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                              jnp.asarray(types), jnp.asarray(mask))
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, jnp.asarray(labels)[..., None],
                                 axis=-1)[..., 0]
        w = jnp.asarray(picked, jnp.float32)
        return jnp.sum((lse - ll) * w) / jnp.sum(w)

    jl, jg = jax.value_and_grad(jloss)(params)
    logits = pmodel(*(torch.from_numpy(x).long() for x in (ids, types, mask)))
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    w = torch.from_numpy(picked).float()
    loss = (nll * w).sum() / w.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = {k: v.numpy() for k, v in bert_params_to_state_dict(
        jax.tree.map(np.asarray, jg), pmodel.cfg).items()}
    assert set(want) == {n for n, _ in pmodel.named_parameters()}
    for name, p in pmodel.named_parameters():
        if p.grad is None:                # the pooler: unused by the head
            assert name.startswith("bert.pooler") and not want[name].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name], **GRAD,
                                   err_msg=name)


def test_pad_to_block_size_end_to_end():
    """A 40-token input padded to 48 through the port's and the JAX
    package's pad_to_block_size (same outputs), run through sparse BERT with
    the padding mask: the real positions equal the dense model's on the
    unpadded input, and the JAX sparse model's everywhere."""
    from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
        SparseAttentionUtils as JaxUtils
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
    dense = ("DenseSparsityConfig", dict(num_heads=2, block=16))
    jdense, params, _ = bert_pair(seed=7)
    jsparse, _, psparse = bert_pair(seed=7, sparse=dense)
    ids = np.random.default_rng(8).integers(0, 128, (2, 40)).astype(np.int32)
    types = np.ones_like(ids)
    jpad = JaxUtils.pad_to_block_size(16, jnp.asarray(ids),
                                      token_type_ids=jnp.asarray(types))
    ppad = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), token_type_ids=torch.from_numpy(types))
    assert ppad[0] == jpad[0] == 8
    for got, want in zip(ppad[1:], jpad[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, pids, pmask, ptypes = ppad
    with torch.no_grad():
        seq, _ = psparse(pids.long(), ptypes.long(), pmask)
    ref, _ = jdense.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(types))
    np.testing.assert_allclose(
        SparseAttentionUtils.unpad_sequence_output(8, seq).numpy(),
        np.asarray(ref), **FWD)
    jseq, _ = jsparse.apply({"params": params}, *(jnp.asarray(x)
                                                  for x in jpad[1:4]))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **FWD)
    assert SparseAttentionUtils.pad_to_block_size(16, pids)[0] == 0


def test_distilbert_shape_matches_jax():
    """No token types, no pooler (the raw [CLS] state)."""
    jmodel, params, pmodel = bert_pair(seed=9, type_vocab_size=0,
                                       use_pooler=False)
    ids, _, mask = _batch(10)
    jseq, jcls = jmodel.apply({"params": params}, jnp.asarray(ids),
                              attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        seq, cls = pmodel(torch.from_numpy(ids).long(),
                          attention_mask=torch.from_numpy(mask))
    assert not hasattr(pmodel, "wtt") and not hasattr(pmodel, "pooler")
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **FWD)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), **FWD)


def test_config_validates_like_jax():
    from deepspeed_tpu.models import bert as jbert
    from deepspeed_tpu_torch.models import bert as pbert
    for kw in (dict(attention_impl="sparse"), dict(attention_impl="flash")):
        with pytest.raises(ValueError) as jerr:
            jbert.BertConfig(**kw)
        with pytest.raises(ValueError) as perr:
            pbert.BertConfig(**kw)
        assert str(perr.value) == str(jerr.value)
    for preset in ("bert_base", "bert_large"):
        j, p = getattr(jbert, preset)(), getattr(pbert, preset)()
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert p.head_dim == j.head_dim
