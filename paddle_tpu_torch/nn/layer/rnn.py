"""Recurrent layers. Counterpart of ``paddle_tpu/nn/layer/rnn.py``
(``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``,
``BiRNN``, ``SimpleRNN``, ``LSTM``, ``GRU``).

The cells keep the reference's parameters: ``weight_ih`` (G·H, I),
``weight_hh`` (G·H, H), ``bias_ih`` and ``bias_hh`` (G·H), drawn from
U(-1/√H, 1/√H) on ``generator``, with the gates in cuDNN's order (LSTM
i, f, g, o; GRU r, z, n with ``r * (W_hn h + b_hn)``). Neither is a
``Linear``: ``interop`` moves them untransposed. ``cell_fn(state, x_t,
*params)`` is the reference's pure step on tensors.

``RNN`` and ``BiRNN`` run a standard cell through ``F.torch_rnn``
(cuDNN's RNN on the card; ``BiRNN`` both directions in one call) and any
other cell through ``F.rnn_scan``, the per-step loop the CPU takes
(``nn/functional/rnn.py`` says which route when). ``SimpleRNN``, ``LSTM``
and ``GRU`` stack them layer by layer as the reference does, dropping
between layers with the port's ``F.dropout`` on the ``DropoutState``
given as ``dropout_state=`` (their own, seeded from ``generator``, when
none is given and ``dropout > 0``).

One fault of the reference is not copied: its
``RNNCellBase.get_initial_states`` ignores ``shape`` and ``dtype``
(``paddle_tpu/nn/layer/rnn.py:22-30``); the port's honours both, and
with ``dtype=None`` takes ``batch_ref``'s floating dtype (float32 for
integer ids).
"""
import math

import torch
from torch import nn

from ...device import resolve_device
from ...kernels.philox import DropoutState
from .. import functional as F
from ..functional import rnn as _rnn
from ..initializer import create_parameter
from .container import LayerList

__all__ = ['RNNCellBase', 'SimpleRNNCell', 'LSTMCell', 'GRUCell', 'RNN',
           'BiRNN', 'SimpleRNN', 'LSTM', 'GRU']


def _linear(x, w, b):
    return torch.nn.functional.linear(x, w, b)


def state_dtype(batch_ref, dtype):
    """``dtype`` (a name, a torch dtype, or None for ``batch_ref``'s
    floating dtype, float32 for integer ids) -> a torch dtype."""
    if dtype is None:
        return batch_ref.dtype if batch_ref.is_floating_point() \
            else torch.float32
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0., batch_dim_idx=0):
        """States filled with ``init_value``: one (B, *s) tensor for each
        ``s`` of ``shape`` (``state_shape`` when None), B from
        ``batch_ref``'s ``batch_dim_idx`` axis, on ``batch_ref``'s
        device."""
        batch = batch_ref.shape[batch_dim_idx]
        shapes = self.state_shape if shape is None else shape
        dtype = state_dtype(batch_ref, dtype)

        def full(s):
            s = (s,) if isinstance(s, int) else tuple(s)
            return torch.full((batch,) + s, init_value, dtype=dtype,
                              device=batch_ref.device)
        if isinstance(shapes[0], (list, tuple)):
            return tuple(full(s) for s in shapes)
        return full(shapes)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``, ``act`` tanh or
    relu."""
    _GATES = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.activation = activation
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                          generator)

    def _make_params(self, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                     generator):
        device = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        G = self._GATES * hidden_size
        kw = dict(device=device, generator=generator,
                  default=lambda w: w.uniform_(-std, std,
                                               generator=generator))
        self.weight_ih = create_parameter((G, input_size), weight_ih_attr,
                                          **kw)
        self.weight_hh = create_parameter((G, hidden_size), weight_hh_attr,
                                          **kw)
        self.bias_ih = create_parameter((G,), bias_ih_attr, is_bias=True,
                                        **kw)
        self.bias_hh = create_parameter((G,), bias_hh_attr, is_bias=True,
                                        **kw)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    @property
    def _torch_mode(self):
        """The ``F.torch_rnn`` mode that computes this cell, or None."""
        if type(self).cell_fn is not SimpleRNNCell.cell_fn:
            return None
        return {'tanh': 'RNN_TANH', 'relu': 'RNN_RELU'}.get(self.activation)

    def cell_fn(self, state, x_t, w_ih, w_hh, b_ih, b_hh):
        act = {'tanh': torch.tanh, 'relu': torch.relu}.get(self.activation) \
            or getattr(F, self.activation)
        h = act(_linear(x_t, w_ih, b_ih) + _linear(state, w_hh, b_hh))
        return h, h

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = self.cell_fn(states, inputs, *self._params())[0]
        return out, out


class LSTMCell(SimpleRNNCell):
    """Gates i, f, g, o: ``c' = f * c + i * g``, ``h' = o * tanh(c')``.
    ``_gate_act`` / ``_act`` replace sigmoid / tanh where a text cell asks
    for other activations (the per-step route then)."""
    _GATES = 4
    _gate_act = None
    _act = None

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        RNNCellBase.__init__(self)
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                          generator)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    @property
    def _torch_mode(self):
        if type(self).cell_fn is not LSTMCell.cell_fn or self._gate_act \
                or self._act:
            return None
        return 'LSTM'

    def cell_fn(self, state, x_t, w_ih, w_hh, b_ih, b_hh):
        sig, act = self._gate_act or torch.sigmoid, self._act or torch.tanh
        h, c = state
        gates = _linear(x_t, w_ih, b_ih) + _linear(h, w_hh, b_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = sig(f) * c + sig(i) * act(g)
        h_new = sig(o) * act(c_new)
        return (h_new, c_new), h_new

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        (h, c), _ = self.cell_fn(tuple(states), inputs, *self._params())
        return h, (h, c)


class GRUCell(SimpleRNNCell):
    """Gates r, z, n: ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``,
    ``h' = (1 - z) * n + z * h``. ``_gate_act`` / ``_act`` as
    ``LSTMCell``'s."""
    _GATES = 3
    _gate_act = None
    _act = None

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, generator=None):
        RNNCellBase.__init__(self)
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                          generator)

    @property
    def _torch_mode(self):
        if type(self).cell_fn is not GRUCell.cell_fn or self._gate_act \
                or self._act:
            return None
        return 'GRU'

    def cell_fn(self, state, x_t, w_ih, w_hh, b_ih, b_hh):
        sig, act = self._gate_act or torch.sigmoid, self._act or torch.tanh
        xr, xz, xn = _linear(x_t, w_ih, b_ih).chunk(3, dim=-1)
        hr, hz, hn = _linear(state, w_hh, b_hh).chunk(3, dim=-1)
        r = sig(xr + hr)
        z = sig(xz + hz)
        n = act(xn + r * hn)
        h_new = (1 - z) * n + z * state
        return h_new, h_new

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = self.cell_fn(states, inputs, *self._params())[0]
        return out, out


def _batch_major(inputs, time_major):
    return inputs.transpose(0, 1) if time_major else inputs


class RNN(nn.Module):
    """``cell`` over the time axis: PyTorch's RNN for a standard cell where
    ``F.use_torch_rnn`` says so, else the per-step ``F.rnn_scan``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                _batch_major(inputs, self.time_major))
        mode = getattr(self.cell, '_torch_mode', None)
        if mode and _rnn.use_torch_rnn(inputs):
            out, (final,) = _rnn.torch_rnn(
                mode, inputs, [self.cell._params()], [initial_states],
                self.time_major, sequence_length, self.is_reverse)
            return out, final
        return _rnn.rnn_scan(self.cell.cell_fn, inputs, initial_states,
                             time_major=self.time_major,
                             reverse=self.is_reverse,
                             sequence_length=sequence_length,
                             extra_params=self.cell._params())


class BiRNN(nn.Module):
    """A forward and a backward ``RNN``, outputs concatenated; two standard
    cells of one mode run as one bidirectional call."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_st = bw_st = None
        if initial_states is not None:
            fw_st, bw_st = initial_states
        fw, bw = self.rnn_fw.cell, self.rnn_bw.cell
        mode = getattr(fw, '_torch_mode', None)
        if mode and mode == getattr(bw, '_torch_mode', None) and \
                (fw.bias_ih is None) == (bw.bias_ih is None) and \
                _rnn.use_torch_rnn(inputs):
            ref = _batch_major(inputs, self.rnn_fw.time_major)
            if fw_st is None:
                fw_st = fw.get_initial_states(ref)
            if bw_st is None:
                bw_st = bw.get_initial_states(ref)
            out, (st_f, st_b) = _rnn.torch_rnn(
                mode, inputs, [fw._params(), bw._params()], [fw_st, bw_st],
                self.rnn_fw.time_major, sequence_length)
            return out, (st_f, st_b)
        out_f, st_f = self.rnn_fw(inputs, fw_st, sequence_length)
        out_b, st_b = self.rnn_bw(inputs, bw_st, sequence_length)
        return torch.cat([out_f, out_b], dim=-1), (st_f, st_b)


class _RNNBase(nn.Module):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, activation="tanh", *, device=None,
                 generator=None, dropout_state=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.direction = direction
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr, device=device,
                  generator=generator)

        def make_cell(isz):
            if mode == "LSTM":
                return LSTMCell(isz, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(isz, hidden_size, **kw)
            return SimpleRNNCell(isz, hidden_size, activation=activation,
                                 **kw)

        self._all_layers = LayerList()
        for i in range(num_layers):
            isz = input_size if i == 0 else hidden_size * self.num_directions
            if bidirect:
                self._all_layers.append(BiRNN(make_cell(isz), make_cell(isz),
                                              time_major))
            else:
                self._all_layers.append(RNN(make_cell(isz), False,
                                            time_major))
        if dropout_state is None and dropout > 0:
            dropout_state = DropoutState.from_generator(generator) \
                if generator is not None else DropoutState(0)
        self.dropout_state = dropout_state

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        final_h, final_c = [], []
        for i, layer in enumerate(self._all_layers):
            init = None
            if initial_states is not None:
                init = self._slice_states(initial_states, i)
            out, st = layer(out, init, sequence_length)
            if i < self.num_layers - 1 and self.dropout > 0:
                out = F.dropout(out, p=self.dropout, training=self.training,
                                dropout_state=self.dropout_state)
            self._collect(st, final_h, final_c)
        if self.mode == "LSTM":
            return out, (torch.stack(final_h, 0), torch.stack(final_c, 0))
        return out, torch.stack(final_h, 0)

    def _slice_states(self, initial_states, i):
        d = self.num_directions
        if self.mode == "LSTM":
            h, c = initial_states
            if d == 2:
                return ((h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1]))
            return (h[i], c[i])
        h = initial_states
        if d == 2:
            return (h[2 * i], h[2 * i + 1])
        return h[i]

    def _collect(self, st, final_h, final_c):
        for s in (st if self.num_directions == 2 else (st,)):
            if self.mode == "LSTM":
                final_h.append(s[0])
                final_c.append(s[1])
            else:
                final_h.append(s)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout,
                         activation=activation, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
