"""The port's recurrent ``nn`` (cells, ``RNN``, ``BiRNN``, ``SimpleRNN``,
``LSTM``, ``GRU``) against the JAX package, on shared weights.

Sizes: input 6, hidden 5, batch 4, 5 steps; the lengths 5, 1, 0 and 3
(a whole row, one step, an empty row, a ragged one). Each case runs the
layer and a loss (a fixed random projection of the outputs and the final
states), the reference's under one ``jax.jit`` of ``jax.value_and_grad``.
Tolerances, fp32: the loss and every output within 1e-5 of its largest
entry, every gradient (parameters and inputs) within 1e-4 of its largest
entry (floor 1e-3). On the CPU the port takes the per-step route; the
same cases also run on PyTorch's RNN route (``rnn_route('torch')``, the
route CUDA tensors take) against the per-step one, at 1e-5 of each
tensor's largest entry.

The reference's ``rnn_scan`` runs a reverse pass with lengths forwards
(it flips the time axis, then each row's valid prefix again:
``paddle_tpu/nn/functional/rnn.py:45-60``), so with every length T its
"reverse" final state is the forward one. The port does not copy that:
its reverse pass runs each row's valid prefix backwards, as upstream's
and cuDNN's do. Where a case has both, the reference side is the
reference run row by row on each row's valid prefix without lengths
(its reverse pass without lengths is right), padded with zeros, its
gradients summed over the rows.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor as JaxTensor

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn.functional import rnn as frnn

from _torch_rnn_pair import assert_close, port_run, ref_run, share

I, H, B, T = 6, 5, 4, 5
LENS = np.array([5, 1, 0, 3], np.int64)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _leaves(part)]
    return [x]


def _loss(outs, ws=None, seed=11):
    """A fixed random projection of every output tensor (weights ``ws``,
    else drawn from ``seed``) -> a scalar."""
    rs = np.random.RandomState(seed)
    total = 0.0
    for i, o in enumerate(outs):
        w = ws[i] if ws is not None else \
            rs.uniform(-1, 1, tuple(o.shape)).astype(np.float32)
        w = torch.tensor(w) if isinstance(o, torch.Tensor) else JaxTensor(w)
        total = total + (o * w).sum()
    return total


def _by_rows(ref, cls, inputs):
    """The reference run row by row on each row's valid prefix (``LENS``),
    batch-major, without lengths: the outputs padded with zeros, an empty
    row's states its initial ones, the gradients summed over rows; the
    loss's weights those ``_loss`` draws for the whole batch."""
    x, *init = inputs
    outs_shape = (B, T, ref.num_directions * H)
    n = init[0].shape[0]
    shapes = [outs_shape] + [(n, B, H)] * (2 if cls == 'LSTM' else 1)
    rs = np.random.RandomState(11)
    ws = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    out = np.zeros(outs_shape, np.float32)
    states = [a.copy() for a in init]
    gx = np.zeros_like(x)
    g_init = [np.zeros_like(a) for a in init]
    grads, loss = None, 0.0
    for b, L in enumerate(LENS):
        row_w = [ws[0][b:b + 1, :L]] + [w[:, b:b + 1] for w in ws[1:]]
        if L == 0:
            loss += sum(float((a[:, b] * w[:, b]).sum())
                        for a, w in zip(init, ws[1:]))
            for g, w in zip(g_init, ws[1:]):
                g[:, b] = w[:, b]
            continue

        def run(model, xr, *s, row_w=row_w):
            state = s[0] if len(s) == 1 else (s[0], s[1])
            o, st = model(xr, state)
            outs = [o] + _leaves(st)
            return _loss(outs, row_w), outs
        r_loss, r_outs, r_grads, r_gx = ref_run(
            ref, run, [x[b:b + 1, :L]] + [a[:, b:b + 1] for a in init])
        loss += r_loss
        out[b, :L] = r_outs[0][0]
        for a, o in zip(states, r_outs[1:]):
            a[:, b] = o[:, 0]
        gx[b, :L] = r_gx[0][0]
        for g, o in zip(g_init, r_gx[1:]):
            g[:, b] = o[:, 0]
        grads = r_grads if grads is None else \
            {k: grads[k] + v for k, v in r_grads.items()}
    return loss, [out] + states, grads, [gx] + g_init


# (layer class name, kwargs, time_major, initial states, lengths)
LAYER_CASES = {
    'lstm_bidirect_init_lengths': ('LSTM', dict(num_layers=2,
                                                direction='bidirect'),
                                   False, True, True),
    'gru_time_major_lengths': ('GRU', dict(num_layers=2), True, False, True),
    'rnn_relu_bidirect': ('SimpleRNN', dict(num_layers=1,
                                            direction='bidirect',
                                            activation='relu'),
                          False, False, False),
    'rnn_tanh_init': ('SimpleRNN', dict(num_layers=2), False, True, False),
    'lstm_one_layer_time_major_init': ('LSTM', dict(num_layers=1), True,
                                       True, False),
}


def _layer_inputs(name, seed=3):
    cls, kw, time_major, init, lens = LAYER_CASES[name]
    rs = np.random.RandomState(seed)
    shape = (T, B, I) if time_major else (B, T, I)
    x = rs.randn(*shape).astype(np.float32)
    d = 2 if kw.get('direction') == 'bidirect' else 1
    inputs = [x]
    if init:
        n = kw['num_layers'] * d
        inputs.append(rs.randn(n, B, H).astype(np.float32))
        if cls == 'LSTM':
            inputs.append(rs.randn(n, B, H).astype(np.float32))
    return inputs, (LENS if lens else None)


def _layer_run(cls, n_init, lens):
    def run(model, x, *init):
        state = None
        if n_init == 1:
            state = init[0]
        elif n_init == 2:
            state = (init[0], init[1])
        if lens is not None:
            lengths = JaxTensor(lens) if isinstance(x, JaxTensor) else lens
            out, st = model(x, state, sequence_length=lengths)
        else:
            out, st = model(x, state)
        outs = [out] + _leaves(st)
        return _loss(outs), outs
    return run


@pytest.fixture(scope='module', params=sorted(LAYER_CASES))
def layer_case(request):
    name = request.param
    cls, kw, time_major, _, _ = LAYER_CASES[name]
    ref = getattr(jnn, cls)(I, H, time_major=time_major, **kw)
    port = getattr(tnn, cls)(I, H, time_major=time_major, device='cpu', **kw)
    share(ref, port, 5)
    inputs, lens = _layer_inputs(name)
    run = _layer_run(cls, len(inputs) - 1, lens)
    if kw.get('direction') == 'bidirect' and lens is not None:
        want = _by_rows(ref, cls, inputs)
    else:
        want = ref_run(ref, run, inputs)
    return name, ref, port, run, inputs, want


def test_layer_matches_reference(layer_case):
    _, _, port, run, inputs, want = layer_case
    assert_close(port_run(port, run, inputs), want, OUT_TOL, GRAD_TOL)


def test_layer_torch_route_matches_per_step(layer_case):
    _, _, port, run, inputs, _ = layer_case
    frnn.reset_route_counts()
    per_step = port_run(port, run, inputs)
    assert frnn.route_counts()['torch_rnn'] == 0
    with frnn.rnn_route('torch'):
        routed = port_run(port, run, inputs)
    assert frnn.route_counts()['torch_rnn'] == len(port._all_layers)
    assert_close(routed, per_step, OUT_TOL, OUT_TOL)


CELLS = {'SimpleRNNCell': 1, 'LSTMCell': 2, 'GRUCell': 1}


@pytest.mark.parametrize('cls', sorted(CELLS))
def test_cell_step_matches_reference(cls):
    ref = getattr(jnn, cls)(I, H)
    port = getattr(tnn, cls)(I, H, device='cpu')
    share(ref, port, 7)
    rs = np.random.RandomState(8)
    x = rs.randn(B, I).astype(np.float32)
    states = [rs.randn(B, H).astype(np.float32) for _ in range(CELLS[cls])]

    def run(model, x, *s):
        out, new = model(x, s[0] if len(s) == 1 else tuple(s))
        outs = [out] + _leaves(new)
        return _loss(outs), outs
    assert_close(port_run(port, run, [x] + states),
                 ref_run(ref, run, [x] + states), OUT_TOL, GRAD_TOL)


@pytest.mark.parametrize('wrap', ['RNN_reverse', 'BiRNN'])
def test_rnn_and_birnn_match_reference(wrap):
    """``RNN(cell, is_reverse=True)`` and ``BiRNN`` without lengths against
    the reference; with lengths, the reverse pass runs each row's valid
    prefix backwards: each row equals the whole-length pass on its
    prefix, its padding zeros, an empty row's state zeros."""
    if wrap == 'BiRNN':
        ref = jnn.BiRNN(jnn.GRUCell(I, H), jnn.GRUCell(I, H))
        port = tnn.BiRNN(tnn.GRUCell(I, H, device='cpu'),
                         tnn.GRUCell(I, H, device='cpu'))
    else:
        ref = jnn.RNN(jnn.LSTMCell(I, H), is_reverse=True)
        port = tnn.RNN(tnn.LSTMCell(I, H, device='cpu'), is_reverse=True)
    share(ref, port, 9)
    x = np.random.RandomState(10).randn(B, T, I).astype(np.float32)

    def run(model, x):
        out, st = model(x)
        outs = [out] + _leaves(st)
        return _loss(outs), outs
    got = port_run(port, run, [x])
    assert_close(got, ref_run(ref, run, [x]), OUT_TOL, GRAD_TOL)
    with torch.no_grad():
        out, st = port(torch.from_numpy(x), None, LENS)
        for b, L in enumerate(LENS):
            assert int(torch.count_nonzero(out[b, L:])) == 0
            if L == 0:
                assert all(int(torch.count_nonzero(s[b])) == 0
                           for s in _leaves(st))
                continue
            o_b, st_b = port(torch.from_numpy(x[b:b + 1, :L]))
            np.testing.assert_allclose(out[b, :L].numpy(), o_b[0].numpy(),
                                       rtol=0, atol=1e-6)
            for s, s_b in zip(_leaves(st), _leaves(st_b)):
                np.testing.assert_allclose(s[b].numpy(), s_b[0].numpy(),
                                           rtol=0, atol=1e-6)
        with frnn.rnn_route('torch'):
            routed, routed_st = port(torch.from_numpy(x), None, LENS)
        np.testing.assert_allclose(routed.numpy(), out.numpy(), rtol=0,
                                   atol=1e-6)
    with frnn.rnn_route('torch'):
        assert_close(port_run(port, run, [x]), got, OUT_TOL, OUT_TOL)


def test_reference_reverse_with_lengths_runs_forwards():
    """The reference's fault: with every length T, its reverse pass's
    final state is the forward pass's, and its outputs are not those of
    the reverse pass without lengths."""
    cell = jnn.GRUCell(I, H)
    x = JaxTensor(np.random.RandomState(12).randn(2, T, I)
                  .astype(np.float32))
    full = JaxTensor(np.array([T, T]))
    out_len, h_len = jnn.RNN(cell, is_reverse=True)(x, None, full)
    out_rev, _ = jnn.RNN(cell, is_reverse=True)(x)
    _, h_fw = jnn.RNN(cell)(x)
    np.testing.assert_array_equal(np.asarray(h_len._value),
                                  np.asarray(h_fw._value))
    assert np.abs(np.asarray(out_len._value)
                  - np.asarray(out_rev._value)).max() > 1e-2


def test_lengths_as_a_tensor_and_as_numpy_agree():
    port = tnn.GRU(I, H, 2, direction='bidirect', device='cpu')
    x = torch.randn(B, T, I)
    want, _ = port(x, sequence_length=LENS)
    with frnn.rnn_route('torch'):
        frnn.reset_route_counts()
        got, _ = port(x, sequence_length=torch.from_numpy(LENS))
        assert frnn.route_counts() == {'torch_rnn': 2, 'per_step': 0,
                                       'host_reads': 0}
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)


def test_reference_initial_states_ignore_shape_and_dtype():
    """The reference's fault (``paddle_tpu/nn/layer/rnn.py:22-30``): a
    ``shape`` or ``dtype`` passed to ``get_initial_states`` changes
    nothing."""
    ref = jnn.GRUCell(I, H)
    batch = JaxTensor(np.zeros((B, I), np.float32))
    s = ref.get_initial_states(batch, shape=[7], dtype='float16')
    assert tuple(s.shape) == (B, H) and str(s._value.dtype) == 'float32'


def test_port_initial_states_honour_shape_and_dtype():
    cell = tnn.LSTMCell(I, H, device='cpu')
    batch = torch.zeros(B, I)
    h, c = cell.get_initial_states(batch, shape=[[7], [3]],
                                   dtype='float64', init_value=2.0)
    assert h.shape == (B, 7) and c.shape == (B, 3)
    assert h.dtype == torch.float64 and float(h[0, 0]) == 2.0
    h, c = cell.get_initial_states(batch.double())
    assert h.shape == (B, H) and h.dtype == torch.float64
    ids = torch.zeros(3, 2, dtype=torch.int64)
    assert cell.get_initial_states(ids)[0].dtype == torch.float32


def test_dropout_between_layers_needs_no_outside_state():
    port = tnn.LSTM(I, H, 3, dropout=0.5, device='cpu',
                    generator=torch.Generator().manual_seed(1)).train()
    x = torch.randn(B, T, I)
    a, _ = port(x)
    b, _ = port(x)
    assert port.dropout_state.offset == 4 and not torch.equal(a, b)
    port.eval()
    c, _ = port(x)
    d, _ = port(x)
    assert torch.equal(c, d)
