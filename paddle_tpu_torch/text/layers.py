"""The text layer zoo. Counterpart of ``paddle_tpu/text/layers.py``: the
recurrent cells and their drivers, the convolutional and decoding
wrappers, the Transformer family of the pre/post-process commands, and
the CRF layers with ``SequenceTagging`` (LAC's BiGRU-CRF tagger).

Class, attribute and parameter names are the reference's, so
``interop.load_paddle_tpu_state`` maps every key one to one. Where the
reference shares a module or a parameter between two attributes
(``text.LSTM``'s ``cell`` and ``rnn.cell``, ``BidirectionalRNN``'s
``cell_fw`` and ``rnn_fw.cell``, ``SequenceTagging``'s two transitions),
its ``state_dict`` lists it once, under the first name; so does
``interop``.

Routes. ``RNN`` runs a ``BasicLSTMCell`` or ``BasicGRUCell``, or a
``StackedLSTMCell`` / ``StackedGRUCell`` / ``StackedRNNCell`` of them, with
the default activations through ``F.torch_rnn`` (cuDNN's RNN on the card)
layer by layer, dropping between layers with the port's ``F.dropout``;
any other cell, and every cell on the CPU, takes the per-step driver
``_rnn_drive.rnn``, the reference's. The Transformer family composes its
attention from ``matmul`` and ``softmax`` and its ``'da'`` from a dropout
and an add, as the reference does; each ``'n'`` is the port's
``nn.LayerNorm``, the LayerNorm kernel on the card. The CRF layers wrap
``F.linear_chain_crf`` and ``F.crf_decoding``.

A layer that drops takes ``dropout_state=`` (a ``DropoutState``); the
top-level layers make their own, seeded from ``generator``, when none is
given. ``device`` and ``generator`` go to every parameter, as in the
port's ``nn``.

Faults of the reference not copied (ROADMAP Queue 3): its
``BasicLSTMCell``, ``BasicGRUCell`` and the ``Stacked*Cell``s accept
``gate_activation`` and ``activation`` and never use them (the port
applies them, on the per-step route); ``SequenceTagging`` accepts
``emb_learning_rate`` and ``crf_learning_rate`` and never uses them (the
port sets them as ``ParamAttr(learning_rate=)`` on the embedding and the
transition, as upstream's LAC network does). Followed, unverified:
``_GRUEncoder`` passes no lengths, so its reverse GRU starts in the
padding.
"""
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.philox import DropoutState
from ..nn import Embedding, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn.decode import BeamSearchDecoder, dynamic_decode
from ..nn.functional import rnn as _rnn
from ..nn.initializer import Normal, ParamAttr, Uniform, create_parameter
from ..nn.layer.conv import Conv1D
from ..nn.layer.rnn import GRUCell as _NNGRUCell
from ..nn.layer.rnn import LSTMCell as _NNLSTMCell
from . import _rnn_drive

__all__ = [
    'RNNCell', 'BasicLSTMCell', 'BasicGRUCell', 'RNN', 'BidirectionalRNN',
    'StackedRNNCell', 'StackedLSTMCell', 'LSTM', 'BidirectionalLSTM',
    'StackedGRUCell', 'GRU', 'BidirectionalGRU', 'DynamicDecode',
    'BeamSearchDecoder', 'Conv1dPoolLayer', 'CNNEncoder',
    'PrePostProcessLayer', 'MultiHeadAttention', 'FFN',
    'TransformerEncoderLayer', 'TransformerEncoder',
    'TransformerDecoderLayer', 'TransformerDecoder', 'TransformerCell',
    'TransformerBeamSearchDecoder', 'LinearChainCRF', 'CRFDecoding',
    'SequenceTagging',
]


def _own_dropout_state(dropout_state, generator):
    """``dropout_state``, or a new one seeded from ``generator``."""
    if dropout_state is not None:
        return dropout_state
    return DropoutState.from_generator(generator) if generator is not None \
        else DropoutState(0)


class RNNCell(nn.Module):
    """Base cell: ``forward(inputs, states) -> (outputs, new_states)``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        return _rnn_drive.initial_states(
            batch_ref, self.state_shape if shape is None else shape, dtype,
            init_value, batch_dim_idx)

    @property
    def state_shape(self):
        raise NotImplementedError


class BasicLSTMCell(RNNCell):
    """One LSTM cell (an ``nn.LSTMCell`` as ``_cell``) with ``forget_bias``
    added into ``bias_ih[H:2H]`` when it is built, as the reference does;
    ``gate_activation`` / ``activation`` replace sigmoid / tanh."""

    def __init__(self, input_size, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype='float32', *, device=None,
                 generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self._cell = _NNLSTMCell(input_size, hidden_size,
                                 weight_ih_attr=param_attr,
                                 weight_hh_attr=param_attr,
                                 bias_ih_attr=bias_attr,
                                 bias_hh_attr=bias_attr, device=device,
                                 generator=generator)
        self._cell._gate_act = _rnn_drive.activation_fn(gate_activation)
        self._cell._act = _rnn_drive.activation_fn(activation)
        _rnn_drive.add_forget_bias(self._cell, forget_bias)

    def forward(self, inputs, states):
        h, c = states
        out, (nh, nc) = self._cell(inputs, (h, c))
        return out, [nh, nc]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


class BasicGRUCell(RNNCell):
    """One GRU cell (an ``nn.GRUCell`` as ``_cell``)."""

    def __init__(self, input_size, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype='float32', *, device=None, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self._cell = _NNGRUCell(input_size, hidden_size,
                                weight_ih_attr=param_attr,
                                weight_hh_attr=param_attr,
                                bias_ih_attr=bias_attr,
                                bias_hh_attr=bias_attr, device=device,
                                generator=generator)
        self._cell._gate_act = _rnn_drive.activation_fn(gate_activation)
        self._cell._act = _rnn_drive.activation_fn(activation)

    def forward(self, inputs, states):
        return self._cell(inputs, states)

    @property
    def state_shape(self):
        return [self.hidden_size]


class StackedRNNCell(RNNCell):
    """Cells stacked into one multi-layer cell."""

    def __init__(self, cells):
        super().__init__()
        self.cells = LayerList(cells)

    def forward(self, inputs, states, **kwargs):
        new_states = []
        out = inputs
        for cell, s in zip(self.cells, states):
            out, ns = cell(out, s)
            new_states.append(ns)
        return out, new_states

    def get_initial_states(self, batch_ref, **kw):
        return [c.get_initial_states(batch_ref, **kw) for c in self.cells]

    @staticmethod
    def stack_param_attr(param_attr, n):
        return [param_attr] * n


class _DroppingStack(StackedRNNCell):
    """A stack that drops between its layers in training."""

    def __init__(self, cells, dropout, dropout_state, generator):
        super().__init__(cells)
        self.dropout = dropout
        self.num_layers = len(cells)
        self.dropout_state = _own_dropout_state(dropout_state, generator) \
            if dropout else dropout_state

    def drop(self, out, i):
        if self.dropout and i < self.num_layers - 1 and self.training:
            out = F.dropout(out, p=self.dropout,
                            dropout_state=self.dropout_state)
        return out

    def forward(self, inputs, states):
        new_states = []
        out = inputs
        for i, (cell, s) in enumerate(zip(self.cells, states)):
            out, ns = cell(out, s)
            out = self.drop(out, i)
            new_states.append(ns)
        return out, new_states


class StackedLSTMCell(_DroppingStack):
    """``num_layers`` ``BasicLSTMCell``s, dropping between layers."""

    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, forget_bias=1.0, num_layers=1,
                 dropout=0.0, param_attr=None, bias_attr=None,
                 dtype="float32", *, device=None, generator=None,
                 dropout_state=None):
        cells = [BasicLSTMCell(input_size if i == 0 else hidden_size,
                               hidden_size, param_attr, bias_attr,
                               gate_activation, activation, forget_bias,
                               dtype, device=device, generator=generator)
                 for i in range(num_layers)]
        super().__init__(cells, dropout, dropout_state, generator)


class StackedGRUCell(_DroppingStack):
    """``num_layers`` ``BasicGRUCell``s, dropping between layers."""

    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, num_layers=1, dropout=0.0,
                 param_attr=None, bias_attr=None, dtype="float32", *,
                 device=None, generator=None, dropout_state=None):
        cells = [BasicGRUCell(input_size if i == 0 else hidden_size,
                              hidden_size, param_attr, bias_attr,
                              gate_activation, activation, dtype,
                              device=device, generator=generator)
                 for i in range(num_layers)]
        super().__init__(cells, dropout, dropout_state, generator)


def _torch_layers(cell):
    """(mode, the ``nn`` cells layer by layer) when ``cell`` is a basic
    cell or a stack of them that ``F.torch_rnn`` computes; else None."""
    basic = (BasicLSTMCell, BasicGRUCell)
    if isinstance(cell, basic):
        layers = [cell]
    elif type(cell) in (StackedRNNCell, StackedLSTMCell, StackedGRUCell) \
            and all(isinstance(c, basic) for c in cell.cells):
        layers = list(cell.cells)
    else:
        return None
    modes = {c._cell._torch_mode for c in layers}
    biased = {c._cell.bias_ih is None for c in layers}
    if len(modes) != 1 or None in modes or len(biased) != 1:
        return None
    return modes.pop(), [c._cell for c in layers]


class RNN(nn.Module):
    """Drive ``cell`` over the time axis: ``F.torch_rnn`` layer by layer
    for basic cells and their stacks where ``F.use_torch_rnn`` says so,
    else the per-step driver."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        cell = self.cell
        layered = _torch_layers(cell)
        if layered is None or not _rnn.use_torch_rnn(inputs):
            return _rnn_drive.rnn(_CallProtocol(cell), inputs,
                                  initial_states, sequence_length,
                                  time_major=self.time_major,
                                  is_reverse=self.is_reverse, **kwargs)
        mode, cells = layered
        stacked = len(cells) > 1 or isinstance(cell, StackedRNNCell)
        if initial_states is None:
            initial_states = cell.get_initial_states(
                inputs.transpose(0, 1) if self.time_major else inputs)
        states = initial_states if stacked else [initial_states]
        out, finals = inputs, []
        for i, (c, st) in enumerate(zip(cells, states)):
            init = (st[0], st[1]) if mode == 'LSTM' else st
            out, (final,) = _rnn.torch_rnn(mode, out, [c._params()], [init],
                                           self.time_major, sequence_length,
                                           self.is_reverse)
            if isinstance(cell, _DroppingStack):
                out = cell.drop(out, i)
            finals.append(list(final) if mode == 'LSTM' else final)
        return out, finals if stacked else finals[0]


class _CallProtocol:
    """A ``Layer``-style cell seen through ``_rnn_drive.rnn``'s ``call``."""

    def __init__(self, cell):
        self.cell = cell

    def call(self, x, s):
        return self.cell(x, s)

    def get_initial_states(self, x):
        return self.cell.get_initial_states(x)


class LSTM(nn.Module):
    """A ``StackedLSTMCell`` over sequences."""

    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, forget_bias=1.0, num_layers=1,
                 dropout=0.0, is_reverse=False, time_major=False,
                 param_attr=None, bias_attr=None, dtype='float32', *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        self.cell = StackedLSTMCell(input_size, hidden_size,
                                    gate_activation, activation,
                                    forget_bias, num_layers, dropout,
                                    param_attr, bias_attr, dtype,
                                    device=device, generator=generator,
                                    dropout_state=dropout_state)
        self.rnn = RNN(self.cell, is_reverse, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return self.rnn(inputs, initial_states, sequence_length)


class GRU(nn.Module):
    """A ``StackedGRUCell`` over sequences."""

    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, num_layers=1, dropout=0.0,
                 is_reverse=False, time_major=False, param_attr=None,
                 bias_attr=None, dtype='float32', *, device=None,
                 generator=None, dropout_state=None):
        super().__init__()
        self.cell = StackedGRUCell(input_size, hidden_size,
                                   gate_activation, activation, num_layers,
                                   dropout, param_attr, bias_attr, dtype,
                                   device=device, generator=generator,
                                   dropout_state=dropout_state)
        self.rnn = RNN(self.cell, is_reverse, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return self.rnn(inputs, initial_states, sequence_length)


class BidirectionalRNN(nn.Module):
    """A forward and a backward ``RNN``, merged by ``merge_mode``:
    ``'concat'``, ``'sum'``, ``'ave'``, ``'mul'``, or ``'zip'`` (the
    pair)."""

    def __init__(self, cell_fw, cell_bw, merge_mode='concat',
                 time_major=False, cell_cls=None, **kwargs):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.merge_mode = merge_mode
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            init_fw = init_bw = None
        elif isinstance(initial_states, (list, tuple)) and \
                len(initial_states) == 2:
            init_fw, init_bw = initial_states
        else:
            init_fw = init_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, init_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, init_bw, sequence_length)
        if self.merge_mode == 'concat':
            out = torch.cat([out_fw, out_bw], dim=-1)
        elif self.merge_mode == 'sum':
            out = out_fw + out_bw
        elif self.merge_mode == 'ave':
            out = (out_fw + out_bw) * 0.5
        elif self.merge_mode == 'mul':
            out = out_fw * out_bw
        else:
            out = (out_fw, out_bw)
        return out, (st_fw, st_bw)


class _Bidirectional(nn.Module):
    """``merge_each_layer=False``: one ``BidirectionalRNN`` over two whole
    stacks; True: a ``BidirectionalRNN`` of basic cells a layer."""

    def __init__(self, stack, basic, input_size, hidden_size, num_layers,
                 merge_mode, merge_each_layer, time_major, generator,
                 dropout_state):
        super().__init__()
        self.merge_each_layer = merge_each_layer
        if not merge_each_layer:
            self.birnn = BidirectionalRNN(stack(dropout_state),
                                          stack(dropout_state), merge_mode,
                                          time_major)
        else:
            self.layers = LayerList()
            for i in range(num_layers):
                in_sz = input_size if i == 0 else (
                    hidden_size * 2 if merge_mode == 'concat'
                    else hidden_size)
                self.layers.append(BidirectionalRNN(
                    basic(in_sz), basic(in_sz), merge_mode, time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if not self.merge_each_layer:
            return self.birnn(inputs, initial_states, sequence_length)
        out = inputs
        states = []
        for layer in self.layers:
            out, st = layer(out, None, sequence_length)
            states.append(st)
        return out, states


class BidirectionalLSTM(_Bidirectional):
    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, forget_bias=1.0, num_layers=1,
                 dropout=0.0, merge_mode='concat', merge_each_layer=False,
                 time_major=False, param_attr=None, bias_attr=None,
                 dtype='float32', *, device=None, generator=None,
                 dropout_state=None):
        kw = dict(device=device, generator=generator)
        dropout_state = _own_dropout_state(dropout_state, generator) \
            if dropout and not merge_each_layer else dropout_state

        def stack(state):
            return StackedLSTMCell(input_size, hidden_size, gate_activation,
                                   activation, forget_bias, num_layers,
                                   dropout, param_attr, bias_attr, dtype,
                                   dropout_state=state, **kw)

        def basic(in_sz):
            return BasicLSTMCell(in_sz, hidden_size, param_attr, bias_attr,
                                 gate_activation, activation, forget_bias,
                                 dtype, **kw)
        super().__init__(stack, basic, input_size, hidden_size, num_layers,
                         merge_mode, merge_each_layer, time_major, generator,
                         dropout_state)


class BidirectionalGRU(_Bidirectional):
    def __init__(self, input_size, hidden_size, gate_activation=None,
                 activation=None, forget_bias=1.0, num_layers=1,
                 dropout=0.0, merge_mode='concat', merge_each_layer=False,
                 time_major=False, param_attr=None, bias_attr=None,
                 dtype='float32', *, device=None, generator=None,
                 dropout_state=None):
        kw = dict(device=device, generator=generator)
        dropout_state = _own_dropout_state(dropout_state, generator) \
            if dropout and not merge_each_layer else dropout_state

        def stack(state):
            return StackedGRUCell(input_size, hidden_size, gate_activation,
                                  activation, num_layers, dropout,
                                  param_attr, bias_attr, dtype,
                                  dropout_state=state, **kw)

        def basic(in_sz):
            return BasicGRUCell(in_sz, hidden_size, param_attr, bias_attr,
                                gate_activation, activation, dtype, **kw)
        super().__init__(stack, basic, input_size, hidden_size, num_layers,
                         merge_mode, merge_each_layer, time_major, generator,
                         dropout_state)


class DynamicDecode(nn.Module):
    """``nn.decode.dynamic_decode`` as a layer."""

    def __init__(self, decoder, max_step_num=None, output_time_major=False,
                 impute_finished=False, is_test=False, return_length=False):
        super().__init__()
        self.decoder = decoder
        self.max_step_num = max_step_num
        self.output_time_major = output_time_major
        self.impute_finished = impute_finished
        self.is_test = is_test
        self.return_length = return_length

    def forward(self, inits=None, **kwargs):
        return dynamic_decode(self.decoder, inits,
                              max_step_num=self.max_step_num,
                              output_time_major=self.output_time_major,
                              impute_finished=self.impute_finished,
                              is_test=self.is_test,
                              return_length=self.return_length, **kwargs)


class Conv1dPoolLayer(nn.Module):
    """``Conv1D``, an activation (a name of ``nn.functional``), then a 1-D
    max or average pool (or a global one), on (B, C, L). The reference's
    switch of convolution library selects nothing on either side: it is
    taken as a keyword and ignored."""

    def __init__(self, num_channels, num_filters, filter_size, pool_size,
                 conv_stride=1, pool_stride=1, conv_padding=0,
                 pool_padding=0, act=None, pool_type='max',
                 global_pooling=False, dilation=1, groups=None,
                 ceil_mode=False, exclusive=True, *, param_attr=None,
                 bias_attr=None, device=None, generator=None, **ignored):
        super().__init__()
        self.conv = Conv1D(num_channels, num_filters, filter_size,
                           stride=conv_stride, padding=conv_padding,
                           dilation=dilation, groups=groups or 1,
                           weight_attr=param_attr, bias_attr=bias_attr,
                           device=device, generator=generator)
        self.act = act
        self.pool_type = pool_type
        self.pool_size = pool_size
        self.pool_stride = pool_stride
        self.pool_padding = pool_padding
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode

    def forward(self, input):
        out = self.conv(input)
        if self.act:
            out = getattr(F, self.act)(out)
        if self.global_pooling:
            return F.global_pool(out, 'avg' if self.pool_type == 'avg'
                                 else 'max', 'NCL')
        fn = F.max_pool1d if self.pool_type == 'max' else F.avg_pool1d
        return fn(out, self.pool_size, self.pool_stride, self.pool_padding,
                  ceil_mode=self.ceil_mode)


class CNNEncoder(nn.Module):
    """``Conv1dPoolLayer``s side by side, their outputs concatenated on the
    channel axis; each argument one value or one a layer (the library
    switch ignored, as ``Conv1dPoolLayer``'s)."""

    def __init__(self, num_channels, num_filters, filter_size, pool_size,
                 num_layers=1, conv_stride=1, pool_stride=1,
                 conv_padding=0, pool_padding=0, act=None, pool_type='max',
                 global_pooling=False, *, device=None, generator=None,
                 **ignored):
        super().__init__()

        def listify(v):
            return v if isinstance(v, (list, tuple)) else [v] * num_layers
        self.convs = LayerList([
            Conv1dPoolLayer(nc, nf, fs, ps, conv_stride=cs,
                            pool_stride=pst, conv_padding=cp,
                            pool_padding=pp, act=a, pool_type=pt,
                            global_pooling=global_pooling, device=device,
                            generator=generator)
            for nc, nf, fs, ps, cs, pst, cp, pp, a, pt in zip(
                listify(num_channels), listify(num_filters),
                listify(filter_size), listify(pool_size),
                listify(conv_stride), listify(pool_stride),
                listify(conv_padding), listify(pool_padding),
                listify(act), listify(pool_type))])

    def forward(self, input):
        return torch.cat([conv(input) for conv in self.convs], dim=1)


# ---------------------------------------------------------------------------
# the Transformer family (pre/post-process commands)
# ---------------------------------------------------------------------------

class PrePostProcessLayer(nn.Module):
    """A command string: ``a`` adds the residual, ``n`` is a LayerNorm, ``d``
    a dropout (in training)."""

    def __init__(self, process_cmd, d_model, dropout_rate=0.1, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        self.process_cmd = process_cmd
        self.dropout_rate = dropout_rate
        self.dropout_state = dropout_state
        self.norms = LayerList([LayerNorm([d_model], device=device,
                                          generator=generator)
                                for c in process_cmd if c == 'n'])

    def forward(self, x, residual=None):
        ni = 0
        for cmd in self.process_cmd:
            if cmd == 'a':
                x = x + residual if residual is not None else x
            elif cmd == 'n':
                x = self.norms[ni](x)
                ni += 1
            elif cmd == 'd':
                if self.dropout_rate and self.training:
                    x = F.dropout(x, p=self.dropout_rate,
                                  dropout_state=self.dropout_state)
        return x


def _split_heads(x, n_head, d):
    B, T = x.shape[0], x.shape[1]
    return x.reshape(B, T, n_head, d).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Q/K/V projections and composed attention, ``softmax(q kᵀ /
    √d_key + bias) v``. ``cache``: a dict whose ``k`` / ``v`` (B, heads,
    T, d) grow by this call's keys and values along T, or whose
    ``static_k`` / ``static_v`` (``cal_kv``) replace the cross-attention's
    projections."""

    def __init__(self, d_key, d_value, d_model, n_head, dropout_rate=0.1, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        self.n_head = n_head
        self.d_key = d_key
        self.d_value = d_value
        kw = dict(bias_attr=False, device=device, generator=generator)
        self.q_fc = Linear(d_model, d_key * n_head, **kw)
        self.k_fc = Linear(d_model, d_key * n_head, **kw)
        self.v_fc = Linear(d_model, d_value * n_head, **kw)
        self.proj_fc = Linear(d_value * n_head, d_model, **kw)
        self.dropout_rate = dropout_rate
        self.dropout_state = dropout_state

    def _prepare_qkv(self, queries, keys, values, cache=None):
        if cache is not None and keys is not None and 'static_k' in cache:
            q = _split_heads(self.q_fc(queries), self.n_head, self.d_key)
            return q, cache['static_k'], cache['static_v']
        if keys is None:
            keys, values = queries, queries
        q = _split_heads(self.q_fc(queries), self.n_head, self.d_key)
        k = _split_heads(self.k_fc(keys), self.n_head, self.d_key)
        v = _split_heads(self.v_fc(values), self.n_head, self.d_value)
        if cache is not None:
            k = torch.cat([cache['k'], k], dim=2)
            v = torch.cat([cache['v'], v], dim=2)
            cache['k'], cache['v'] = k, v
        return q, k, v

    def forward(self, queries, keys=None, values=None, attn_bias=None,
                cache=None):
        q, k, v = self._prepare_qkv(queries, keys, values, cache)
        product = torch.matmul(q, k.transpose(-1, -2)) * self.d_key ** -0.5
        if attn_bias is not None:
            product = product + attn_bias
        weights = F.softmax(product, axis=-1)
        if self.dropout_rate and self.training:
            weights = F.dropout(weights, p=self.dropout_rate,
                                dropout_state=self.dropout_state)
        out = torch.matmul(weights, v)
        B, T = out.shape[0], out.shape[2]
        out = out.transpose(1, 2).reshape(B, T, self.n_head * self.d_value)
        return self.proj_fc(out)

    def cal_kv(self, keys, values):
        """The cross-attention's keys and values, projected once."""
        return (_split_heads(self.k_fc(keys), self.n_head, self.d_key),
                _split_heads(self.v_fc(values), self.n_head, self.d_value))


class FFN(nn.Module):
    """Position-wise feed-forward: ``fc2(dropout(act(fc1(x))))``."""

    def __init__(self, d_inner_hid, d_model, dropout_rate=0.1,
                 fc1_act="relu", *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = Linear(d_model, d_inner_hid, **kw)
        self.fc2 = Linear(d_inner_hid, d_model, **kw)
        self.fc1_act = fc1_act
        self.dropout_rate = dropout_rate
        self.dropout_state = dropout_state

    def forward(self, x):
        hidden = getattr(F, self.fc1_act)(self.fc1(x))
        if self.dropout_rate and self.training:
            hidden = F.dropout(hidden, p=self.dropout_rate,
                               dropout_state=self.dropout_state)
        return self.fc2(hidden)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, n_head, d_key, d_value, d_model, d_inner_hid,
                 prepostprocess_dropout=0.1, attention_dropout=0.1,
                 relu_dropout=0.1, preprocess_cmd="n", postprocess_cmd="da",
                 ffn_fc1_act="relu", *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        kw = dict(device=device, generator=generator,
                  dropout_state=dropout_state)

        def process(cmd):
            return PrePostProcessLayer(cmd, d_model, prepostprocess_dropout,
                                       **kw)
        self.preprocesser1 = process(preprocess_cmd)
        self.self_attn = MultiHeadAttention(d_key, d_value, d_model, n_head,
                                            attention_dropout, **kw)
        self.postprocesser1 = process(postprocess_cmd)
        self.preprocesser2 = process(preprocess_cmd)
        self.ffn = FFN(d_inner_hid, d_model, relu_dropout, ffn_fc1_act, **kw)
        self.postprocesser2 = process(postprocess_cmd)

    def forward(self, enc_input, attn_bias=None):
        attn_output = self.self_attn(self.preprocesser1(enc_input), None,
                                     None, attn_bias)
        attn_output = self.postprocesser1(attn_output, enc_input)
        ffn_output = self.ffn(self.preprocesser2(attn_output))
        return self.postprocesser2(ffn_output, attn_output)


class TransformerEncoder(nn.Module):
    """``n_layer`` encoder layers, then the preprocess command once
    more."""

    def __init__(self, n_layer, n_head, d_key, d_value, d_model,
                 d_inner_hid, prepostprocess_dropout=0.1,
                 attention_dropout=0.1, relu_dropout=0.1,
                 preprocess_cmd="n", postprocess_cmd="da",
                 ffn_fc1_act="relu", *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        state = self.dropout_state = _own_dropout_state(dropout_state,
                                                        generator)
        kw = dict(device=device, generator=generator, dropout_state=state)
        self.encoder_layers = LayerList([
            TransformerEncoderLayer(n_head, d_key, d_value, d_model,
                                    d_inner_hid, prepostprocess_dropout,
                                    attention_dropout, relu_dropout,
                                    preprocess_cmd, postprocess_cmd,
                                    ffn_fc1_act, **kw)
            for _ in range(n_layer)])
        self.processer = PrePostProcessLayer(preprocess_cmd, d_model,
                                             prepostprocess_dropout, **kw)

    def forward(self, enc_input, attn_bias=None):
        for layer in self.encoder_layers:
            enc_input = layer(enc_input, attn_bias)
        return self.processer(enc_input)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, n_head, d_key, d_value, d_model, d_inner_hid,
                 prepostprocess_dropout=0.1, attention_dropout=0.1,
                 relu_dropout=0.1, preprocess_cmd="n", postprocess_cmd="da",
                 ffn_fc1_act="relu", *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        kw = dict(device=device, generator=generator,
                  dropout_state=dropout_state)

        def process(cmd):
            return PrePostProcessLayer(cmd, d_model, prepostprocess_dropout,
                                       **kw)
        self.preprocesser1 = process(preprocess_cmd)
        self.self_attn = MultiHeadAttention(d_key, d_value, d_model, n_head,
                                            attention_dropout, **kw)
        self.postprocesser1 = process(postprocess_cmd)
        self.preprocesser2 = process(preprocess_cmd)
        self.cross_attn = MultiHeadAttention(d_key, d_value, d_model, n_head,
                                             attention_dropout, **kw)
        self.postprocesser2 = process(postprocess_cmd)
        self.preprocesser3 = process(preprocess_cmd)
        self.ffn = FFN(d_inner_hid, d_model, relu_dropout, ffn_fc1_act, **kw)
        self.postprocesser3 = process(postprocess_cmd)

    def forward(self, dec_input, enc_output, self_attn_bias=None,
                cross_attn_bias=None, cache=None):
        self_attn_output = self.self_attn(
            self.preprocesser1(dec_input), None, None, self_attn_bias, cache)
        self_attn_output = self.postprocesser1(self_attn_output, dec_input)
        cross_attn_output = self.cross_attn(
            self.preprocesser2(self_attn_output), enc_output, enc_output,
            cross_attn_bias,
            cache if (cache and 'static_k' in cache) else None)
        cross_attn_output = self.postprocesser2(cross_attn_output,
                                                self_attn_output)
        ffn_output = self.ffn(self.preprocesser3(cross_attn_output))
        return self.postprocesser3(ffn_output, cross_attn_output)


class TransformerDecoder(nn.Module):
    """``n_layer`` decoder layers, then the preprocess command once more;
    ``caches``: one dict a layer (``prepare_incremental_cache``, with
    ``prepare_static_cache``'s entries merged in for decoding)."""

    def __init__(self, n_layer, n_head, d_key, d_value, d_model,
                 d_inner_hid, prepostprocess_dropout=0.1,
                 attention_dropout=0.1, relu_dropout=0.1,
                 preprocess_cmd="n", postprocess_cmd="da",
                 ffn_fc1_act="relu", *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        state = self.dropout_state = _own_dropout_state(dropout_state,
                                                        generator)
        kw = dict(device=device, generator=generator, dropout_state=state)
        self.decoder_layers = LayerList([
            TransformerDecoderLayer(n_head, d_key, d_value, d_model,
                                    d_inner_hid, prepostprocess_dropout,
                                    attention_dropout, relu_dropout,
                                    preprocess_cmd, postprocess_cmd,
                                    ffn_fc1_act, **kw)
            for _ in range(n_layer)])
        self.processer = PrePostProcessLayer(preprocess_cmd, d_model,
                                             prepostprocess_dropout, **kw)

    def forward(self, dec_input, enc_output, self_attn_bias=None,
                cross_attn_bias=None, caches=None):
        for i, layer in enumerate(self.decoder_layers):
            dec_input = layer(dec_input, enc_output, self_attn_bias,
                              cross_attn_bias,
                              None if caches is None else caches[i])
        return self.processer(dec_input)

    def prepare_static_cache(self, enc_output):
        return [{'static_k': k, 'static_v': v}
                for k, v in (layer.cross_attn.cal_kv(enc_output, enc_output)
                             for layer in self.decoder_layers)]

    def prepare_incremental_cache(self, enc_output):
        B = enc_output.shape[0]
        attn = self.decoder_layers[0].self_attn
        kw = dict(dtype=enc_output.dtype, device=enc_output.device)
        return [{'k': torch.zeros((B, attn.n_head, 0, attn.d_key), **kw),
                 'v': torch.zeros((B, attn.n_head, 0, attn.d_value), **kw)}
                for _ in self.decoder_layers]


class TransformerCell(RNNCell):
    """A ``TransformerDecoder`` as a step cell: ``inputs`` (word, position)
    -> logits; the states are the layers' incremental caches."""

    def __init__(self, decoder, embedding_fn=None, output_fn=None):
        super().__init__()
        self.decoder = decoder
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def forward(self, inputs, states=None, enc_output=None,
                trg_slf_attn_bias=None, trg_src_attn_bias=None,
                static_caches=()):
        word, position = inputs
        inp = self.embedding_fn(word, position) \
            if self.embedding_fn is not None else word
        if states is not None and static_caches:
            caches = [dict(inc, **st) for inc, st in zip(states,
                                                         static_caches)]
        else:
            caches = states
        out = self.decoder(inp, enc_output, trg_slf_attn_bias,
                           trg_src_attn_bias, caches)
        if self.output_fn is not None:
            out = self.output_fn(out)
        if out.dim() == 3 and out.shape[1] == 1:
            out = out.squeeze(1)
        new_states = [{'k': c['k'], 'v': c['v']} for c in caches] \
            if caches else states
        return out, new_states


class TransformerBeamSearchDecoder(BeamSearchDecoder):
    """Beam search over a ``TransformerCell``: the step's ids go in as
    [B * beam, 1] with a position input filled with the step, and the
    growing caches are gathered by beam whole (``var_dim_in_state`` is
    kept for the reference's signature)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 var_dim_in_state):
        super().__init__(cell, start_token, end_token, beam_size)
        self.var_dim_in_state = var_dim_in_state

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        return BeamSearchDecoder.tile_beam_merge_with_batch(x, beam_size)

    def step(self, time, inputs, states, **kwargs):
        from ..nn.decode import _map_structure
        inputs = _map_structure(self._merge_batch_beams, inputs)
        word = inputs.unsqueeze(-1) if inputs.dim() == 1 else inputs
        pos = torch.full(word.shape, int(time), dtype=torch.int64,
                         device=word.device)
        cell_states = _map_structure(self._merge_batch_beams,
                                     states['cell_states'])
        cell_outputs, next_cell_states = self.cell((word, pos), cell_states,
                                                   **kwargs)
        cell_outputs = _map_structure(self._split_batch_beams, cell_outputs)
        next_cell_states = _map_structure(self._split_batch_beams,
                                          next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        output, state = self._beam_search_step(time, cell_outputs,
                                               next_cell_states, states)
        return output, state, output['predicted_ids'], state['finished']


# ---------------------------------------------------------------------------
# the CRF layers and SequenceTagging
# ---------------------------------------------------------------------------

def _transition(size, param_attr, device, generator):
    """The (size + 2, size) transition, N(0, 0.1) unless ``param_attr``
    says otherwise."""
    return create_parameter(
        (size + 2, size), param_attr, device=resolve_device(device),
        generator=generator,
        default=lambda w: w.normal_(0.0, 0.1, generator=generator))


class LinearChainCRF(nn.Module):
    """The CRF cost layer holding the transition: ``forward(input, label,
    length)`` -> (B, 1) negative log-likelihoods."""

    def __init__(self, size, param_attr=None, dtype='float32', *,
                 device=None, generator=None):
        super().__init__()
        self.transition = _transition(size, param_attr, device, generator)

    @property
    def weight(self):
        return self.transition

    def forward(self, input, label, length):
        return F.linear_chain_crf(input, label, self.transition,
                                  length=length)


class CRFDecoding(nn.Module):
    """Viterbi decoding under its transition: ``forward(input, length,
    label=None)``."""

    def __init__(self, size, param_attr=None, dtype='float32', *,
                 device=None, generator=None):
        super().__init__()
        self.transition = _transition(size, param_attr, device, generator)

    @property
    def weight(self):
        return self.transition

    def forward(self, input, length, label=None):
        return F.crf_decoding(input, self.transition, length=length,
                              label=label)


class _GRUEncoder(nn.Module):
    """``num_layers`` (bi-)GRUs of one layer each, their weights
    U(-init_bound, init_bound); no lengths reach them."""

    def __init__(self, input_dim, grnn_hidden_dim, init_bound,
                 num_layers=1, is_bidirection=False, *, device=None,
                 generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.is_bidirection = is_bidirection
        self.gru_list = LayerList()
        attr = ParamAttr(initializer=Uniform(-init_bound, init_bound))
        kw = dict(num_layers=1, param_attr=attr, device=device,
                  generator=generator)
        for i in range(num_layers):
            in_dim = input_dim if i == 0 else (
                grnn_hidden_dim * 2 if is_bidirection else grnn_hidden_dim)
            self.gru_list.append(
                BidirectionalGRU(in_dim, grnn_hidden_dim, **kw)
                if is_bidirection else GRU(in_dim, grnn_hidden_dim, **kw))

    def forward(self, input_feature, h0=None):
        out = input_feature
        for gru in self.gru_list:
            out, _ = gru(out)
        return out


class SequenceTagging(nn.Module):
    """LAC's BiGRU-CRF tagger: embedding, ``bigru_num`` bidirectional
    GRUs, a ``Linear`` to the tag scores, a CRF whose transition the
    decoding shares. ``forward(word, lengths, target=None)``: with
    ``target``, (the CRF cost (B, 1), the decoded paths); else the paths.
    ``emb_learning_rate`` and ``crf_learning_rate`` scale the embedding's
    and the transition's learning rates."""

    def __init__(self, vocab_size, num_labels, word_emb_dim=128,
                 grnn_hidden_dim=128, emb_learning_rate=0.1,
                 crf_learning_rate=0.1, bigru_num=2, init_bound=0.1, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embedding = Embedding(
            vocab_size, word_emb_dim,
            weight_attr=ParamAttr(learning_rate=emb_learning_rate), **kw)
        self.gru_encoder = _GRUEncoder(word_emb_dim, grnn_hidden_dim,
                                       init_bound, num_layers=bigru_num,
                                       is_bidirection=True, **kw)
        self.fc = Linear(grnn_hidden_dim * 2, num_labels, **kw)
        self.linear_chain_crf = LinearChainCRF(
            num_labels, ParamAttr(initializer=Normal(0.0, 0.1),
                                  learning_rate=crf_learning_rate), **kw)
        self.crf_decoding = CRFDecoding(num_labels, **kw)
        # decoding shares the training transition
        self.crf_decoding.transition = self.linear_chain_crf.transition

    def forward(self, word, lengths, target=None):
        emission = self.fc(self.gru_encoder(self.word_embedding(word)))
        decoded = F.crf_decoding(emission, self.linear_chain_crf.transition,
                                 length=lengths)
        if target is not None:
            return self.linear_chain_crf(emission, target, lengths), decoded
        return decoded
