"""The recurrent loop. Counterpart of ``paddle_tpu/nn/functional/rnn.py``
(``rnn_scan``), and the route of the port's recurrent layers onto
PyTorch's own RNN.

The reference runs every recurrence as one ``lax.scan`` over a pure cell
function. The port has two routes, with the reference's semantics on
both: past a row's ``sequence_length`` its state stops advancing and its
outputs are zeros, and a reverse pass with lengths runs each row's valid
prefix backwards (the padding stays where it is).

- ``rnn_scan``: a Python loop over the time steps calling ``cell_fn`` on
  tensors, the masks taken with ``torch.where``. Every cell takes it on
  the CPU; a custom cell (or a standard one with other activations) takes
  it everywhere. It is the plain version ``chip_smoke.py`` holds the
  other route against on the card.
- ``torch_rnn``: one layer, one direction or both, of a standard cell
  (the tanh or relu Elman cell, the LSTM with gates i, f, g, o, the GRU
  with r, z, n and ``r * (W_hn h + b_hn)``: cuDNN's gate orders, which
  are the reference's) through ``torch._VF.rnn_tanh`` / ``rnn_relu`` /
  ``lstm`` / ``gru`` on the cell's own ``weight_ih``, ``weight_hh``,
  ``bias_ih`` and ``bias_hh``: cuDNN's RNN on a CUDA tensor. It is the
  counterpart of the reference's ``lax.scan`` on the card, at the
  precision PyTorch's TF32 switch for that library sets
  (``chip_smoke.py`` holds it at full fp32, TF32 off). The four
  tensors are separate parameters, so cuDNN copies them into one buffer
  on every call (PyTorch warns once). Its dropout is always 0: the layers
  drop between layers with the port's own ``F.dropout``. Lengths are
  packed (``pack_padded_sequence``), which needs them on the host: lengths
  given as numpy or a CPU tensor cost no host read, a CUDA tensor costs
  one (counted); a row of length 0 is packed at length 1 and then masked
  back to zero outputs and its initial state, as the reference leaves it.
  Backward through cuDNN's RNN needs its training mode, so ``train`` is on
  whenever a gradient is wanted.

``rnn_route(name)`` sets the route for tests and ``chip_smoke.py``:
``'auto'`` (the default: ``torch_rnn`` for standard cells on CUDA tensors,
``rnn_scan`` otherwise), ``'per_step'`` or ``'torch'`` (PyTorch's RNN on
any device; on the CPU its native loop). ``route_counts()`` reads the
calls of each route and the host reads of CUDA lengths since
``reset_route_counts()``.
"""
import contextlib

import numpy as np
import torch
from torch.nn.utils import rnn as _packing

__all__ = ['rnn_scan', 'torch_rnn', 'rnn_route', 'route_counts',
           'reset_route_counts', 'use_torch_rnn']

_ROUTES = ('auto', 'per_step', 'torch')
_route = 'auto'
_counts = {'torch_rnn': 0, 'per_step': 0, 'host_reads': 0}


@contextlib.contextmanager
def rnn_route(name):
    """Run the recurrent layers on route ``name`` inside the block."""
    global _route
    if name not in _ROUTES:
        raise ValueError(f"rnn_route: {name!r} is not one of {_ROUTES}")
    before, _route = _route, name
    try:
        yield
    finally:
        _route = before


def route_counts():
    """-> {'torch_rnn': layer calls, 'per_step': loops, 'host_reads':
    CUDA lengths read to the host} since the last reset."""
    return dict(_counts)


def reset_route_counts():
    for k in _counts:
        _counts[k] = 0


def use_torch_rnn(x):
    """Whether a standard cell's layer on ``x`` takes ``torch_rnn``."""
    return _route == 'torch' or (_route == 'auto' and x.device.type == 'cuda')


def _map(fn, *structs):
    """``fn`` over the tensor leaves of parallel nests of lists/tuples."""
    first = structs[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*structs))
    return fn(*structs)


def _lengths(sequence_length, device, steps, host=False):
    """``sequence_length`` (numpy, a list, a tensor) -> (int64 lengths on
    ``device`` clipped to ``steps``, the same on the host or None). The
    host copy is made only when asked for; reading a CUDA tensor's
    is counted."""
    if isinstance(sequence_length, torch.Tensor):
        lens = sequence_length.to(torch.int64)
        on_host = None
        if host:
            if lens.device.type != 'cpu':
                _counts['host_reads'] += 1
            on_host = lens.cpu().clamp(0, steps)
        return lens.to(device, non_blocking=True).clamp(0, steps), on_host
    on_host = torch.as_tensor(np.asarray(sequence_length, dtype=np.int64)
                              ).clamp(0, steps)
    return on_host.to(device, non_blocking=True), on_host if host else None


def _flip_valid(xs, lens):
    """Time-major ``xs`` with each row's first ``lens`` steps reversed (the
    rest where they are); the whole time axis without lengths."""
    if lens is None:
        return xs.flip(0)
    T = xs.shape[0]
    t = torch.arange(T, device=xs.device)[:, None]
    idx = torch.where(t < lens[None], lens[None] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (xs.dim() - 2)).expand(xs.shape)
    return torch.gather(xs, 0, idx)


def rnn_scan(cell_fn, x, init_state, time_major=False, reverse=False,
             sequence_length=None, extra_params=()):
    """``cell_fn(state, x_t, *extra_params) -> (new_state, out_t)`` over the
    time axis of ``x`` ((B, T, I), or (T, B, I) with ``time_major``) from
    ``init_state`` (a tensor or a nest of lists/tuples of them) ->
    (outputs, final state)."""
    _counts['per_step'] += 1
    xs = x if time_major else x.transpose(0, 1)
    T = xs.shape[0]
    lens = keep = None
    if sequence_length is not None:
        lens, _ = _lengths(sequence_length, xs.device, T)
        keep = torch.arange(T, device=xs.device)[:, None] < lens[None]
    if reverse:
        xs = _flip_valid(xs, lens)
    state, outs = init_state, []
    for t in range(T):
        new_state, out = cell_fn(state, xs[t], *extra_params)
        if keep is not None:
            k = keep[t]
            new_state = _map(lambda n, o: torch.where(
                k.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
                new_state, state)
            out = torch.where(k.reshape((-1,) + (1,) * (out.dim() - 1)),
                              out, 0.0)
        state = new_state
        outs.append(out)
    outs = torch.stack(outs, 0)
    if reverse:
        outs = _flip_valid(outs, lens)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, state


_VF_NAMES = {'RNN_TANH': 'rnn_tanh', 'RNN_RELU': 'rnn_relu', 'LSTM': 'lstm',
             'GRU': 'gru'}


def torch_rnn(mode, x, weights, init, time_major=False,
              sequence_length=None, reverse=False):
    """One layer of ``mode`` (``'RNN_TANH'``, ``'RNN_RELU'``, ``'LSTM'``,
    ``'GRU'``) through PyTorch's RNN. ``weights``: for each direction (one,
    or forward and backward) its ``(weight_ih, weight_hh, bias_ih,
    bias_hh)`` (the biases None together when there are none); ``init``:
    each direction's initial state, (B, H), or ``(h, c)`` for the LSTM.
    ``reverse`` (one direction only): the pass runs backwards. -> (outputs
    (B, T, dirs * H) or time-major, [each direction's final state])."""
    _counts['torch_rnn'] += 1
    dirs = len(weights)
    bidirectional = dirs == 2
    xs = x if time_major else x.transpose(0, 1)
    T = xs.shape[0]
    lstm = mode == 'LSTM'
    lens = on_host = None
    if sequence_length is not None:
        lens, on_host = _lengths(sequence_length, xs.device, T, host=True)
        if bool((on_host == T).all()):
            lens = on_host = None      # every row whole: nothing to pack
    if reverse:
        xs = _flip_valid(xs, lens)
    has_biases = weights[0][2] is not None
    params = [w for ws in weights for w in (ws if has_biases else ws[:2])]
    if lstm:
        hx = (torch.stack([s[0] for s in init]),
              torch.stack([s[1] for s in init]))
    else:
        hx = torch.stack(list(init))
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xs, *params, *(hx if lstm else (hx,))))
    fn = getattr(torch._VF, _VF_NAMES[mode])
    if on_host is None:
        res = fn(xs, hx, params, has_biases, 1, 0.0, train, bidirectional,
                 False)
        out, finals = res[0], res[1:]
    else:
        packed = _packing.pack_padded_sequence(
            xs, on_host.clamp(min=1), enforce_sorted=False)
        order = packed.sorted_indices
        hx_sorted = tuple(h.index_select(1, order) for h in hx) if lstm \
            else hx.index_select(1, order)
        res = fn(packed.data, packed.batch_sizes, hx_sorted, params,
                 has_biases, 1, 0.0, train, bidirectional)
        out, _ = _packing.pad_packed_sequence(
            _packing.PackedSequence(res[0], packed.batch_sizes, order,
                                    packed.unsorted_indices),
            total_length=T)
        finals = tuple(h.index_select(1, packed.unsorted_indices)
                       for h in res[1:])
        if bool((on_host == 0).any()):
            # packed at length 1: back to zeros and the initial state
            empty = lens == 0
            out = torch.where(empty[None, :, None], 0.0, out)
            finals = tuple(torch.where(empty[None, :, None], h0, h)
                           for h, h0 in zip(finals, hx if lstm else (hx,)))
    if reverse:
        out = _flip_valid(out, lens)
    if not time_major:
        out = out.transpose(0, 1)
    states = [(finals[0][d], finals[1][d]) if lstm else finals[0][d]
              for d in range(dirs)]
    return out, states
