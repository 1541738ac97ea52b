"""The per-step RNN driver that ``text.RNN`` runs a cell with. The port's
copy of ``paddle_tpu/fluid/rnn_tail.py:22-190`` (``RNNCell``, ``GRUCell``,
``LSTMCell``, ``rnn``, ``birnn``), which the reference's ``text.RNN``
reaches through its fluid package; the port's ``fluid`` (ROADMAP Queue 1
item 7e) will re-export it.

``rnn`` runs ``cell.call(x_t, states)`` once a time step through
``F.rnn_scan``, whose masking is the reference's ``_mask_state`` (upstream's
``_maybe_copy``): past a row's ``sequence_length`` the state stops
advancing and the outputs are zeroed, and a reverse pass starts each row
at its last valid step.

The fluid cells build their ``nn`` cell on the first call, on the input's
device (``generator=`` draws its weights, the device's default generator
when None). The reference accepts ``gate_activation`` and ``activation``
and never uses them (``rnn_tail.py:63-64``); the port applies them (a
callable, or the name of an ``nn.functional`` activation).
"""
import torch

from ..nn import functional as F
from ..nn.layer.rnn import GRUCell as _NNGRUCell
from ..nn.layer.rnn import LSTMCell as _NNLSTMCell
from ..nn.layer.rnn import state_dtype

__all__ = ['RNNCell', 'GRUCell', 'LSTMCell', 'rnn', 'birnn']


def activation_fn(spec):
    """A callable activation, or the name of an ``nn.functional`` one, or
    None (the cell's default) -> a callable or None."""
    if spec is None or callable(spec):
        return spec
    return getattr(F, spec)


def initial_states(batch_ref, shapes, dtype, init_value, batch_dim_idx):
    """A state of each shape in ``shapes`` (one shape, or a list of them),
    filled with ``init_value``, on ``batch_ref``'s device: the text and
    fluid cells' ``get_initial_states``, lists where the reference makes
    lists."""
    B = batch_ref.shape[batch_dim_idx]
    dtype = state_dtype(batch_ref, dtype)

    def build(s):
        dims = [int(d) for d in (s if isinstance(s, (list, tuple)) else [s])]
        return torch.full([B] + dims, init_value, dtype=dtype,
                          device=batch_ref.device)
    if isinstance(shapes, (list, tuple)) and shapes and \
            isinstance(shapes[0], (list, tuple)):
        return [build(s) for s in shapes]
    return build(shapes)


def add_forget_bias(cell, forget_bias):
    """The reference adds ``forget_bias`` into ``bias_ih[H:2H]`` when it
    builds the cell, so weights carried across compute the same."""
    if forget_bias and cell.bias_ih is not None:
        h = cell.hidden_size
        with torch.no_grad():
            cell.bias_ih[h:2 * h] += forget_bias


class RNNCell:
    """Subclasses implement ``call(inputs, states) -> (out, new_states)``
    (upstream ``rnn.py:59``)."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    @property
    def state_shape(self):
        raise NotImplementedError("state_shape not defined for this cell")

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        return initial_states(batch_ref,
                              self.state_shape if shape is None else shape,
                              dtype, init_value, batch_dim_idx)


class GRUCell(RNNCell):
    """fluid ``GRUCell`` (upstream ``rnn.py:226``): an ``nn.GRUCell`` built
    on the first call."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell", *, generator=None):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.gate_activation = activation_fn(gate_activation)
        self.activation = activation_fn(activation)
        self.generator = generator
        self._cell = None

    def _build(self, inputs):
        self._cell = _NNGRUCell(inputs.shape[-1], self.hidden_size,
                                weight_ih_attr=self.param_attr,
                                weight_hh_attr=self.param_attr,
                                bias_ih_attr=self.bias_attr,
                                bias_hh_attr=self.bias_attr,
                                device=inputs.device,
                                generator=self.generator)
        self._cell._gate_act = self.gate_activation
        self._cell._act = self.activation

    def call(self, inputs, states):
        if self._cell is None:
            self._build(inputs)
        return self._cell(inputs, states)

    @property
    def state_shape(self):
        return [self.hidden_size]


class LSTMCell(RNNCell):
    """fluid ``LSTMCell`` (upstream ``rnn.py:324``): ``call`` returns (h,
    [h, c])."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell", *, generator=None):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.forget_bias = forget_bias
        self.gate_activation = activation_fn(gate_activation)
        self.activation = activation_fn(activation)
        self.generator = generator
        self._cell = None

    def _build(self, inputs):
        self._cell = _NNLSTMCell(inputs.shape[-1], self.hidden_size,
                                 weight_ih_attr=self.param_attr,
                                 weight_hh_attr=self.param_attr,
                                 bias_ih_attr=self.bias_attr,
                                 bias_hh_attr=self.bias_attr,
                                 device=inputs.device,
                                 generator=self.generator)
        self._cell._gate_act = self.gate_activation
        self._cell._act = self.activation
        add_forget_bias(self._cell, self.forget_bias)

    def call(self, inputs, states):
        if self._cell is None:
            self._build(inputs)
        h, c = states
        out, (new_h, new_c) = self._cell(inputs, (h, c))
        return out, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run ``cell`` over the time axis of ``inputs`` (upstream
    ``rnn.py:434``) -> (outputs, final states)."""
    if initial_states is None:
        initial_states = cell.get_initial_states(
            inputs.transpose(0, 1) if time_major else inputs)

    def step(states, x_t):
        out, new_states = cell.call(x_t, states)
        return new_states, out
    return F.rnn_scan(step, inputs, initial_states, time_major=time_major,
                      reverse=is_reverse, sequence_length=sequence_length)


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    """A forward and a backward ``rnn``, outputs concatenated on the last
    axis (upstream ``rnn.py:651``)."""
    init_fw = init_bw = None
    if initial_states is not None:
        init_fw, init_bw = initial_states
    out_fw, st_fw = rnn(cell_fw, inputs, init_fw, sequence_length,
                        time_major=time_major)
    out_bw, st_bw = rnn(cell_bw, inputs, init_bw, sequence_length,
                        time_major=time_major, is_reverse=True)
    return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)
