"""ERNIE against the JAX package.

The knowledge masking is numpy on the host in both packages: from the
same seed, ``ernie_knowledge_mask`` and ``ernie_mask_batch`` give the same
``(input_ids, masked_positions, masked_labels)`` arrays, bit for bit, with
and without phrase spans, with padding (word index -1 and pad ids) and
when ``max_predictions`` binds. ``ErnieForPretraining`` (hidden 64, 2
layers, 4 heads, vocab 512, 4 sentence types, p = 0) on one masked batch
with ragged padding masks: the loss within 1e-5 relative and every
gradient within 1e-4 of its largest entry (floor 1e-3: the key bias's true
gradient is zero), fp32; the weights carried across ``interop`` both
ways.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text import ernie as jernie

from paddle_tpu_torch import text
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.text import ernie as ternie

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64, type_vocab_size=4)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, L, K = 3, 40, 8


def _np(t):
    return np.asarray(t._value)


def _corpus(seed, b=B, length=L, pad_from=(40, 31, 17)):
    """Token ids, word indices (2-3 wordpieces a word now and then), pad
    rows marked -1, and per-row phrase spans."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, 30000, (b, length)).astype(np.int64)
    words = np.zeros((b, length), np.int64)
    spans = []
    for i in range(b):
        w = 0
        for t in range(length):
            if t and rs.rand() < 0.7:
                w += 1
            words[i, t] = w
        n = pad_from[i % len(pad_from)]
        words[i, n:] = -1
        ids[i, n:] = 0
        spans.append([(2, 5), (9, 11)] if i % 2 == 0 else [(0, 3)])
    return ids, words, spans


@pytest.mark.parametrize('phrases', [False, True])
@pytest.mark.parametrize('max_predictions', [20, 4])
def test_mask_batch_equals_reference(phrases, max_predictions):
    ids, words, spans = _corpus(1)
    kw = dict(max_predictions=max_predictions,
              phrase_spans=spans if phrases else None, seed=123)
    want = jernie.ernie_mask_batch(ids, words, 30522, **kw)
    got = ternie.ernie_mask_batch(ids, words, 30522, **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the padding is never masked; labels past the predictions are -1
    in_ids, pos, lab = got
    assert ((lab == -1) | (ids[np.arange(B)[:, None], pos] != 0)).all()


def test_knowledge_mask_masks_whole_phrases():
    ids, words, spans = _corpus(2, b=1, pad_from=(40,))
    for seed in range(6):
        rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
        kw = dict(max_predictions=30, masked_lm_prob=0.3,
                  phrase_spans=[(3, 9)])
        want = jernie.ernie_knowledge_mask(ids[0], words[0], 30522,
                                           rng=rng_a, **kw)
        got = ternie.ernie_knowledge_mask(ids[0], words[0], 30522,
                                          rng=rng_b, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        pos = got[1][got[2] >= 0]
        chosen = set(words[0][pos])
        phrase = set(range(3, 9)) & set(words[0])
        # a phrase is masked whole or not at all
        assert phrase <= chosen or not (phrase & chosen)


def test_knowledge_mask_checks_its_inputs():
    with pytest.raises(ValueError, match='outside vocab_size'):
        ternie.ernie_knowledge_mask([5, 6], [0, 1], 100, mask_token_id=103)
    with pytest.raises(ValueError, match='length mismatch'):
        ternie.ernie_knowledge_mask([5, 6], [0], 30522)


def test_exports():
    assert text.ErnieConfig is text.BertConfig
    assert issubclass(text.ErnieModel, text.BertModel)
    assert issubclass(text.ErnieForPretraining, text.BertForPretraining)
    assert set(ternie.__all__) == set(jernie.__all__)


@pytest.fixture(scope='module')
def pair():
    paddle.seed(17)
    ref = jernie.ErnieForPretraining(jernie.ErnieConfig(**SMALL))
    ref.eval()
    rs = np.random.RandomState(18)
    state = {k: (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in ((k, _np(v)) for k, v in ref.state_dict().items())}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL),
                                      device='cpu').eval()
    load_paddle_tpu_state(port, state)
    return ref, port, state


def _batch():
    ids, words, spans = _corpus(3)
    ids = ids % SMALL['vocab_size']
    ids[words < 0] = 0
    in_ids, pos, lab = ternie.ernie_mask_batch(
        ids, words, SMALL['vocab_size'], max_predictions=K,
        phrase_spans=spans, seed=4)
    rs = np.random.RandomState(5)
    feeds = {'input_ids': in_ids,
             'token_type_ids': rs.randint(0, 4, (B, L)).astype(np.int64),
             'attention_mask': (words >= 0).astype(np.int64),
             'masked_positions': pos}
    nsp = rs.randint(0, 2, (B, 1)).astype(np.int64)
    return feeds, lab, nsp


def test_weights_carry_across_both_ways(pair):
    ref, port, state = pair
    assert sorted(port.state_dict()) == sorted(state)
    back = to_paddle_tpu_state(port)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    assert port.bert.embeddings.token_type_embeddings.weight.shape == \
        (4, 64)


def test_pretraining_loss_and_gradients_match_reference(pair):
    ref, port, _ = pair
    feeds, lab, nsp = _batch()
    params = param_values(ref, trainable_only=False)

    def loss_of(p):
        (logits, nsp_logits), _ = functional_call(
            ref, p, JaxTensor(feeds['input_ids']),
            JaxTensor(feeds['token_type_ids']),
            JaxTensor(feeds['attention_mask']),
            masked_positions=JaxTensor(feeds['masked_positions']))
        return ref.pretraining_loss(logits, nsp_logits, JaxTensor(lab),
                                    JaxTensor(nsp))._value
    want_loss, want = jax.jit(jax.value_and_grad(loss_of))(params)
    port = copy.deepcopy(port)
    logits, nsp_logits = port(**{k: torch.from_numpy(v)
                                 for k, v in feeds.items()})
    assert logits.shape == (B, K, SMALL['vocab_size'])
    loss = port.pretraining_loss(logits, nsp_logits, torch.from_numpy(lab),
                                 torch.from_numpy(nsp))
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        LOSS_TOL * abs(float(want_loss))
    loss.backward()
    grads = to_paddle_tpu_state(port, grads=True)
    assert sorted(grads) == sorted(want)
    for key, g in want.items():
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-3)
        assert np.abs(grads[key] - g).max() <= GRAD_TOL * scale, key


def test_ernie_model_matches_reference(pair):
    ref, port, _ = pair
    feeds, _, _ = _batch()
    args = [feeds[k] for k in ('input_ids', 'token_type_ids')]
    jm = jernie.ErnieModel(jernie.ErnieConfig(**SMALL))
    jm.eval()
    tm = ternie.ErnieModel(ternie.ErnieConfig(**SMALL), device='cpu').eval()
    state = {k[len('bert.'):]: v for k, v in
             to_paddle_tpu_state(port).items() if k.startswith('bert.')}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_paddle_tpu_state(tm, state)
    rseq, rpool = jm(*(paddle.to_tensor(a) for a in args),
                     attention_mask=paddle.to_tensor(feeds['attention_mask']))
    with torch.no_grad():
        seq, pool = tm(*(torch.from_numpy(a) for a in args),
                       attention_mask=torch.from_numpy(
                           feeds['attention_mask']))
    for g, w in ((seq, rseq), (pool, rpool)):
        w = _np(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
