"""``LSTMLanguageModel``, ``SkipGram``, the ``Tokenizer`` and the weights
of the recurrent models across ``interop``, against the JAX package.

``LSTMLanguageModel``: vocab 23, hidden 6, 2 layers, p = 0, both
``tie_weights`` forms; a first call from the zero state, then a second
call from its final state (carried as truncated backpropagation through
time carries it): the logits and the second call's loss, states and
gradients (to the parameters and the carried state). ``SkipGram``: vocab
19, dimension 5, 3 given negatives a pair: the loss and its gradients.
Tolerances, fp32: values within 1e-5 of their largest entry, gradients
within 1e-4 of their largest (floor 1e-3). The tokenizer's ids equal the
reference's, wordpiece or not, on ASCII and non-ASCII text. ``interop``
moves the reference's exact key lists both ways: a parameter two
attributes share once, under the reference's name; the recurrent
weights untransposed and the ``Linear``s transposed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.text as jt
from paddle_tpu.core.tensor import Tensor as JaxTensor

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.text as tt
from paddle_tpu_torch.interop import state_keys, to_paddle_tpu_state

from _torch_rnn_pair import assert_close, port_run, ref_run, share

V, H, B, T = 23, 6, 3, 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize('tie', [False, True])
def test_lstm_lm_with_a_carried_state_matches_reference(tie):
    ref = jt.LSTMLanguageModel(V, H, num_layers=2, tie_weights=tie)
    port = tt.LSTMLanguageModel(V, H, num_layers=2, tie_weights=tie,
                                device='cpu')
    share(ref, port, 41)
    rs = np.random.RandomState(42)
    ids = rs.randint(0, V, (2, B, T)).astype(np.int64)
    targets = rs.randint(0, V, (B, T)).astype(np.int64)
    r_logits, (r_h, r_c) = ref(JaxTensor(ids[0]))
    with torch.no_grad():
        logits, (h, c) = port(torch.from_numpy(ids[0]))
    want = np.asarray(r_logits._value)
    assert np.abs(logits.numpy() - want).max() <= OUT_TOL * np.abs(want).max()
    state = [np.asarray(r_h._value), np.asarray(r_c._value)]
    for got, w in zip((h, c), state):
        assert np.abs(got.numpy() - w).max() <= OUT_TOL * np.abs(w).max()

    def run(model, x, h0, c0, y):
        logits, (hn, cn) = model(x, (h0, c0))
        return model.loss(logits, y), [logits, hn, cn]
    inputs = [ids[1], *state, targets]
    assert_close(port_run(port, run, inputs), ref_run(ref, run, inputs),
                 OUT_TOL, GRAD_TOL)


def test_skipgram_with_given_negatives_matches_reference():
    ref, port = jt.SkipGram(19, 5), tt.SkipGram(19, 5, device='cpu')
    share(ref, port, 43)
    rs = np.random.RandomState(44)
    inputs = [rs.randint(0, 19, (7,)).astype(np.int64),
              rs.randint(0, 19, (7,)).astype(np.int64),
              rs.randint(0, 19, (7, 3)).astype(np.int64)]

    def run(model, c, o, n):
        loss = model(c, o, n)
        return loss, [loss]
    assert_close(port_run(port, run, inputs), ref_run(ref, run, inputs),
                 OUT_TOL, GRAD_TOL)


def test_skipgram_draws_negatives_from_its_generator():
    def loss(seed):
        model = tt.SkipGram(19, 5, neg_samples=4, device='cpu',
                            generator=torch.Generator().manual_seed(seed))
        model.load_state_dict(base.state_dict())
        c = torch.arange(6)
        return float(model(c, c.flip(0)))
    base = tt.SkipGram(19, 5, device='cpu')
    assert loss(1) == loss(1) and loss(1) != loss(2)


VOCAB = {'[UNK]': 0, 'the': 1, 'cat': 2, 'sat': 3, 'un': 4, '##aff': 5,
         '##able': 6, ',': 7, '_': 8, 'é': 9, 'école': 10, '!': 11,
         'on': 12, 'mat': 13}
TEXTS = ['The cat sat on the mat!', 'unaffable, the_cat',
         'École unaffable cat', 'xyz unknown', '', 'cat ' * 40]


@pytest.mark.parametrize('wordpiece', [False, True])
def test_tokenizer_ids_match_reference(wordpiece):
    from paddle_tpu._native.tokenizer import Tokenizer as RefTokenizer
    ref = RefTokenizer(VOCAB, wordpiece=wordpiece)
    port = tt.Tokenizer(VOCAB, wordpiece=wordpiece)
    assert not port.native
    for text in TEXTS:
        np.testing.assert_array_equal(port.encode(text, max_len=16),
                                      ref.encode(text, max_len=16))
    got_ids, got_lens = port.encode_batch(TEXTS, max_len=12, pad_id=0)
    want_ids, want_lens = ref.encode_batch(TEXTS, max_len=12, pad_id=0)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got_ids.dtype == np.int32


INTEROP = {
    'nn.LSTM bidirect': (lambda: jnn.LSTM(4, 5, 2, direction='bidirect'),
                         lambda: tnn.LSTM(4, 5, 2, direction='bidirect',
                                          device='cpu')),
    'text.LSTM': (lambda: jt.LSTM(4, 5, num_layers=2),
                  lambda: tt.LSTM(4, 5, num_layers=2, device='cpu')),
    'SequenceTagging': (lambda: jt.SequenceTagging(30, 7, 8, 6),
                        lambda: tt.SequenceTagging(30, 7, 8, 6,
                                                   device='cpu')),
    'LSTMLanguageModel': (lambda: jt.LSTMLanguageModel(30, 8),
                          lambda: tt.LSTMLanguageModel(30, 8, device='cpu')),
    'SkipGram': (lambda: jt.SkipGram(30, 8),
                 lambda: tt.SkipGram(30, 8, device='cpu')),
}


@pytest.mark.parametrize('name', sorted(INTEROP))
def test_interop_round_trips_the_reference_keys(name):
    make_ref, make_port = INTEROP[name]
    ref, port = make_ref(), make_port()
    state = share(ref, port, 45)
    assert list(state_keys(port)) == list(ref.state_dict())
    back = to_paddle_tpu_state(port)
    assert list(back) == list(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    own = dict(port.named_parameters())
    for k, v in state.items():
        if k.endswith(('weight_ih', 'weight_hh', 'transition')):
            np.testing.assert_array_equal(own[k].detach().numpy(), v)
        if k == 'fc.weight':
            np.testing.assert_array_equal(own[k].detach().numpy(), v.T)
    port.zero_grad()
    out = port(*_example(name))
    (out[0] if isinstance(out, tuple) else out).float().sum().backward()
    grads = to_paddle_tpu_state(port, grads=True)
    assert set(grads) <= set(state)
    assert all(grads[k] is None or grads[k].shape == state[k].shape
               for k in grads)


def _example(name):
    ids = torch.randint(0, 30, (2, 4), generator=torch.Generator()
                        .manual_seed(46))
    if name.endswith('LSTM bidirect') or name == 'text.LSTM':
        return (torch.randn(2, 4, 4),)
    if name == 'SequenceTagging':
        return ids, np.array([4, 2]), ids % 7
    if name == 'SkipGram':
        return ids[0], ids[1], ids.reshape(4, 2)
    return (ids,)
