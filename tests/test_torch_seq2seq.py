"""``Seq2SeqTransformer`` against the JAX package, on shared weights.

A small model (vocabularies 23 and 29, d_model 32, 4 heads, 2 + 2
layers, FFN 64, 40 positions, p = 0), its state randomised on the
reference and carried across with ``interop``. Tolerances, fp32: the
logits within 1e-5 of their largest entry; the teacher-forced loss
(cross-entropy over the target tokens, as a user trains it) within 1e-5
relative, every gradient within 1e-4 of its largest entry (floor 1e-3).
``translate``'s parity with the reference is in
``test_torch_seq2seq_translate.py``; here its refusals, its mode and its
attention routes.
"""
import collections

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer_base import functional_call, param_values
from paddle_tpu.text.seq2seq import Seq2SeqTransformer as JaxSeq2Seq

from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import transformer as tft
from paddle_tpu_torch.text import Seq2SeqTransformer

SV, TV, D, H, FF, MAXLEN = 23, 29, 32, 4, 64, 40
B, LS, LT = 3, 9, 6
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(t):
    return np.asarray(t._value)


@pytest.fixture(scope='module')
def pair():
    paddle.seed(5)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              max_length=MAXLEN)
    ref = JaxSeq2Seq(SV, TV, **kw)
    ref.eval()
    rs = np.random.RandomState(6)
    state = {k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
             for k, v in ref.state_dict().items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    port = Seq2SeqTransformer(SV, TV, **kw, device='cpu').eval()
    load_paddle_tpu_state(port, state)
    return ref, port, state


@pytest.fixture(scope='module')
def batch():
    rs = np.random.RandomState(7)
    src = rs.randint(2, SV, (B, LS)).astype(np.int64)
    trg = rs.randint(2, TV, (B, LT + 1)).astype(np.int64)
    return src, trg[:, :-1].copy(), trg[:, 1:].copy()


def test_weights_carry_across_both_ways(pair):
    ref, port, state = pair
    assert sorted(port.state_dict()) == sorted(state)
    back = to_paddle_tpu_state(port)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(port.out_proj.weight.detach().numpy(),
                                  state['out_proj.weight'].T)


def test_forward_matches_reference(pair, batch):
    ref, port, _ = pair
    src, trg_in, _ = batch
    want = _np(ref(paddle.to_tensor(src), paddle.to_tensor(trg_in)))
    with torch.no_grad():
        got = port(torch.from_numpy(src), torch.from_numpy(trg_in)).numpy()
    assert got.shape == (B, LT, TV)
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_teacher_forced_loss_and_gradients_match_reference(pair, batch):
    ref, port, _ = pair
    src, trg_in, trg_out = batch
    params = param_values(ref, trainable_only=False)

    def loss_of(p):
        logits, _ = functional_call(ref, p, JaxTensor(src),
                                    JaxTensor(trg_in))
        return JF.cross_entropy(logits.reshape([-1, TV]),
                                JaxTensor(trg_out.reshape(-1)))._value
    want_loss, want = jax.jit(jax.value_and_grad(loss_of))(params)
    port.zero_grad()
    logits = port(torch.from_numpy(src), torch.from_numpy(trg_in))
    loss = TF.cross_entropy(logits.reshape(-1, TV),
                            torch.from_numpy(trg_out).reshape(-1))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        OUT_TOL * abs(float(want_loss))
    grads = to_paddle_tpu_state(port, grads=True)
    assert sorted(grads) == sorted(want)
    for key, g in want.items():
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 1e-3)
        assert np.abs(grads[key] - g).max() <= GRAD_TOL * scale, key


def test_translate_restores_training_mode(pair, batch):
    _, port, _ = pair
    port.train()
    try:
        port.translate(torch.from_numpy(batch[0][:1]), max_len=4)
        assert port.training
    finally:
        port.eval()


def test_translate_refuses_max_len_beyond_the_position_table(pair, batch):
    ref, port, _ = pair
    with pytest.raises(ValueError, match='positional table'):
        port.translate(torch.from_numpy(batch[0]), max_len=MAXLEN + 1)
    with pytest.raises(ValueError, match='positional table'):
        ref.translate(paddle.to_tensor(batch[0]), max_len=MAXLEN + 1)


def test_decode_routes(pair, batch, monkeypatch):
    """translate: the encoder's self-attention on the flash kernel; the
    first decoding step's self-attention (one query, one cached key) too;
    every later step and every cross-attention composed."""
    _, port, _ = pair
    calls = collections.Counter()
    real_flash, real_composed = tft.flash_attention_bhld, tft._composed

    def flash(q, *a, **k):
        calls['flash', q.shape[2], a[0].shape[2]] += 1
        return real_flash(q, *a, **k)

    def composed(q, k, *a, **kw):
        calls['composed', q.shape[2], k.shape[2]] += 1
        return real_composed(q, k, *a, **kw)
    monkeypatch.setattr(tft, 'flash_attention_bhld', flash)
    monkeypatch.setattr(tft, '_composed', composed)
    steps = 5
    out = port.translate(torch.from_numpy(batch[0]), max_len=steps)
    assert out.shape == (B, steps, 4)
    want = {('flash', LS, LS): 2, ('flash', 1, 1): 2}
    for t in range(1, steps):
        want['composed', 1, t + 1] = 2
    want['composed', 1, LS] = 2 * steps
    assert calls == want
