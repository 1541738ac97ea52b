"""The recurrent and convolutional halves of the port's ``text.layers``
against the JAX package on shared weights (the Transformer family is in
``test_torch_text_layers_transformer.py``, the CRF half in
``test_torch_crf.py``).

Sizes: input 6, hidden 5, batch 4, 4 steps, lengths 4, 1, 0, 3.
Reference losses and gradients run under one ``jax.jit`` of
``jax.value_and_grad`` (``_torch_rnn_pair``). Tolerances, fp32: outputs
and losses within 1e-5 of their largest entry, gradients within 1e-4 of
their largest (floor 1e-3). The reference's ``text.RNN`` runs its fluid
driver, whose reverse pass with lengths is right, so these cases hold
lengths and reverse passes directly.

A fault of the reference, with a test here: the basic cells and the
stacks take ``gate_activation`` / ``activation`` and never use them (the
port applies them).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu.text as jt
from paddle_tpu.core.tensor import Tensor as JaxTensor

import paddle_tpu_torch.text as tt
from paddle_tpu_torch.nn.functional import rnn as frnn

from _torch_rnn_pair import (assert_close, port_run, ref_forward, ref_run,
                             share)

I, H, B, T = 6, 5, 4, 4
LENS = np.array([4, 1, 0, 3], np.int64)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _leaves(part)]
    return [x]


def _loss(outs, seed=13):
    rs = np.random.RandomState(seed)
    total = 0.0
    for o in outs:
        w = rs.uniform(-1, 1, tuple(o.shape)).astype(np.float32)
        w = torch.tensor(w) if isinstance(o, torch.Tensor) else JaxTensor(w)
        total = total + (o * w).sum()
    return total


def _x(seed=14, time_major=False):
    shape = (T, B, I) if time_major else (B, T, I)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seq_run(lens=LENS, init=False):
    """run(model, x, *init): the layer over x with ``lens`` and the given
    initial states (a list a layer, [h, c] for LSTMs)."""
    def run(model, x, *states):
        lengths = None if lens is None else (
            JaxTensor(lens) if isinstance(x, JaxTensor) else lens)
        st = None
        if states:
            st = [list(states[i:i + 2]) for i in range(0, len(states), 2)] \
                if init == 'lstm' else list(states)
        out, final = model(x, st, lengths)
        outs = _leaves(out) + _leaves(final)
        return _loss(outs), outs
    return run


# (class, kwargs, time_major, initial states, gradients held too)
SEQ_CASES = {
    'lstm_reverse_init': (
        'LSTM', dict(num_layers=2, is_reverse=True, forget_bias=1.0), False,
        'lstm', True),
    'gru_time_major': ('GRU', dict(num_layers=2, time_major=True), True,
                       'gru', False),
    'bilstm_stacked': ('BidirectionalLSTM', dict(num_layers=2), False, None,
                       False),
    'bilstm_each_layer': ('BidirectionalLSTM',
                          dict(num_layers=2, merge_each_layer=True), False,
                          None, True),
    'bigru_stacked': ('BidirectionalGRU', dict(num_layers=2), False, None,
                      True),
    'bigru_each_layer_sum': ('BidirectionalGRU',
                             dict(num_layers=2, merge_each_layer=True,
                                  merge_mode='sum'), False, None, False),
}


@pytest.fixture(scope='module', params=sorted(SEQ_CASES))
def seq_case(request):
    cls, kw, time_major, init, grads = SEQ_CASES[request.param]
    ref = getattr(jt, cls)(I, H, **kw)
    port = getattr(tt, cls)(I, H, device='cpu', **kw)
    share(ref, port, 15)
    rs = np.random.RandomState(16)
    inputs = [_x(time_major=time_major)]
    if init:
        per_layer = 2 if init == 'lstm' else 1
        inputs += [rs.randn(B, H).astype(np.float32)
                   for _ in range(kw['num_layers'] * per_layer)]
    run = _seq_run(init=init)
    want = ref_run(ref, run, inputs) if grads else ref_forward(ref, run,
                                                              inputs)
    return port, run, inputs, want


def test_sequence_layer_matches_reference(seq_case):
    """The outputs and final states; where the case holds them, the
    gradients too (the others' are the same code paths)."""
    port, run, inputs, want = seq_case
    got = port_run(port, run, inputs)
    assert_close(got if len(want) == 4 else got[:2], want, OUT_TOL,
                 GRAD_TOL)


def test_sequence_layer_torch_route_matches_per_step(seq_case):
    """Basic cells and their stacks take PyTorch's RNN layer by layer
    (``rnn_route('torch')``, as CUDA tensors do), the same numbers."""
    port, run, inputs, _ = seq_case
    per_step = port_run(port, run, inputs)
    frnn.reset_route_counts()
    with frnn.rnn_route('torch'):
        routed = port_run(port, run, inputs)
    counts = frnn.route_counts()
    assert counts['per_step'] == 0 and counts['torch_rnn'] > 0
    assert_close(routed, per_step, OUT_TOL, OUT_TOL)


@pytest.mark.parametrize('cls', ['BasicLSTMCell', 'BasicGRUCell'])
def test_basic_cell_step_matches_reference(cls):
    ref = getattr(jt, cls)(I, H)
    port = getattr(tt, cls)(I, H, device='cpu')
    share(ref, port, 17)
    rs = np.random.RandomState(18)
    n = 2 if cls == 'BasicLSTMCell' else 1
    inputs = [rs.randn(B, I).astype(np.float32)] + \
        [rs.randn(B, H).astype(np.float32) for _ in range(n)]

    def run(model, x, *s):
        out, new = model(x, list(s) if n == 2 else s[0])
        outs = [out] + _leaves(new)
        return _loss(outs), outs
    assert_close(port_run(port, run, inputs), ref_run(ref, run, inputs),
                 OUT_TOL, GRAD_TOL)


def test_forget_bias_is_added_into_the_input_bias():
    gen = torch.Generator().manual_seed(1)
    plain = tt.BasicLSTMCell(I, H, forget_bias=0.0, device='cpu',
                             generator=gen)
    gen.manual_seed(1)
    biased = tt.BasicLSTMCell(I, H, forget_bias=1.0, device='cpu',
                              generator=gen)
    diff = (biased._cell.bias_ih - plain._cell.bias_ih).detach()
    np.testing.assert_allclose(diff[H:2 * H].numpy(), np.ones(H),
                               rtol=1.3e-6, atol=1e-5)
    assert float(diff[:H].abs().max()) == 0.0
    assert float(diff[2 * H:].abs().max()) == 0.0


@pytest.mark.parametrize('mode', ['concat', 'sum', 'ave', 'mul', 'zip'])
def test_bidirectional_rnn_merge_modes_match_reference(mode):
    ref = jt.BidirectionalRNN(jt.BasicGRUCell(I, H), jt.BasicGRUCell(I, H),
                              merge_mode=mode)
    port = tt.BidirectionalRNN(tt.BasicGRUCell(I, H, device='cpu'),
                               tt.BasicGRUCell(I, H, device='cpu'),
                               merge_mode=mode)
    share(ref, port, 19)
    x = _x(20)
    want = [np.asarray(o) for o in jax.jit(lambda x: [
        o._value for o in _leaves(ref(JaxTensor(x), None, JaxTensor(LENS)))])(
            x)]
    with torch.no_grad():
        got_out, (g_f, g_b) = port(torch.from_numpy(x), None, LENS)
    got = [o.numpy() for o in _leaves(got_out) + [g_f, g_b]]
    assert isinstance(got_out, tuple) == (mode == 'zip')
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= OUT_TOL * np.abs(w).max()


def test_cnn_encoder_matches_reference():
    kw = dict(num_channels=3, num_filters=[4, 5], filter_size=3,
              pool_size=2, num_layers=2, act='relu',
              pool_type=['max', 'avg'])
    ref = jt.CNNEncoder(**kw)
    port = tt.CNNEncoder(device='cpu', **kw)
    share(ref, port, 23)
    x = np.random.RandomState(24).randn(2, 3, 11).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: ref(JaxTensor(x))._value)(x))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    glob_ref = jt.Conv1dPoolLayer(3, 4, 3, 2, global_pooling=True,
                                  pool_type='avg', act='tanh')
    glob = tt.Conv1dPoolLayer(3, 4, 3, 2, global_pooling=True,
                              pool_type='avg', act='tanh', device='cpu')
    share(glob_ref, glob, 25)
    want = np.asarray(jax.jit(lambda x: glob_ref(JaxTensor(x))._value)(x))
    got = glob(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 4, 1)
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()


def test_cell_activations_reference_ignores_them():
    """The reference's fault: a ``BasicLSTMCell`` built with other
    activations computes the default ones. The port applies them (and so
    takes the per-step route)."""
    x = np.random.RandomState(28).randn(B, I).astype(np.float32)
    zeros = np.zeros((B, H), np.float32)
    ref = jt.BasicLSTMCell(I, H)
    ref_relu = jt.BasicLSTMCell(I, H, gate_activation='relu',
                                activation='relu')
    share(ref, tt.BasicLSTMCell(I, H, device='cpu'), 29)
    share(ref_relu, tt.BasicLSTMCell(I, H, device='cpu'), 29)
    a = ref(JaxTensor(x), [JaxTensor(zeros), JaxTensor(zeros)])[0]
    b = ref_relu(JaxTensor(x), [JaxTensor(zeros), JaxTensor(zeros)])[0]
    np.testing.assert_array_equal(np.asarray(a._value), np.asarray(b._value))

    port = tt.BasicLSTMCell(I, H, device='cpu')
    relu = tt.BasicLSTMCell(I, H, gate_activation='relu',
                            activation=torch.relu, device='cpu')
    relu.load_state_dict(port.state_dict())
    xt, z = torch.from_numpy(x), torch.zeros(B, H)
    with torch.no_grad():
        gates = torch.nn.functional.linear(xt, port._cell.weight_ih,
                                           port._cell.bias_ih) + \
            port._cell.bias_hh
        i, f, g, o = gates.chunk(4, -1)
        want = torch.relu(o) * torch.relu(torch.relu(i) * torch.relu(g))
        got = relu(xt, [z, z])[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1.3e-6,
                                   atol=1e-5)
        assert not torch.allclose(got, port(xt, [z, z])[0])
    assert relu._cell._torch_mode is None and port._cell._torch_mode == 'LSTM'
    stack = tt.LSTM(I, H, activation='relu', device='cpu')
    frnn.reset_route_counts()
    with frnn.rnn_route('torch'):
        stack(torch.from_numpy(_x()))
    assert frnn.route_counts()['torch_rnn'] == 0


def test_stacked_rnn_cell_of_basic_cells_matches_reference():
    """``text.RNN`` over a plain ``StackedRNNCell`` (no dropout of its own)
    of two ``BasicGRUCell``s, with lengths: both routes."""
    ref = jt.RNN(jt.StackedRNNCell([jt.BasicGRUCell(I, H),
                                    jt.BasicGRUCell(H, H)]))
    port = tt.RNN(tt.StackedRNNCell([tt.BasicGRUCell(I, H, device='cpu'),
                                     tt.BasicGRUCell(H, H, device='cpu')]))
    share(ref, port, 32)
    run, inputs = _seq_run(), [_x(33)]
    want = ref_forward(ref, run, inputs)
    got = port_run(port, run, inputs)
    assert_close(got[:2], want, OUT_TOL, GRAD_TOL)
    with frnn.rnn_route('torch'):
        assert_close(port_run(port, run, inputs), got, OUT_TOL, OUT_TOL)
