"""Helpers of the recurrent-layer tests: one model on both sides on shared
weights, and a loss's value and gradients on each side.

``share(ref, port, seed)`` draws every state entry of the reference
U(-0.5, 0.5) from ``seed``, sets it on the reference and carries it into
the port with ``interop``. ``ref_run(ref, run, inputs)`` runs ``run(ref,
*inputs)`` -> (loss Tensor, [output Tensors]) under one ``jax.jit`` of
``jax.value_and_grad`` over the reference's parameters and the float
inputs (eagerly each new shape of a reference RNN compiles its scan
anew); ``port_run`` does the same with autograd. Both return (loss,
[outputs as numpy], {key: parameter gradient}, [input gradients]).
``ref_forward`` gives the reference's loss and outputs alone, one
``jax.jit`` of the forward."""
import jax
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn.layer_base import param_values

from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)


def share(ref, port, seed, scale=0.5):
    rs = np.random.RandomState(seed)
    state = {k: rs.uniform(-scale, scale, v.shape).astype(np.float32)
             for k, v in ref.state_dict().items()}
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_paddle_tpu_state(port, state)
    return state


def _floats(inputs):
    return [i for i, a in enumerate(inputs)
            if isinstance(a, np.ndarray) and a.dtype.kind == 'f']


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _leaves(part)]
    return [] if x is None else [x]


def ref_run(ref, run, inputs):
    params = param_values(ref)
    fl = _floats(inputs)

    def loss_of(p, xs):
        args = list(inputs)
        for i, x in zip(fl, xs):
            args[i] = JaxTensor(x)
        args = [JaxTensor(a) if isinstance(a, np.ndarray) else a
                for a in args]
        loss, outs = run_with(ref, p, run, args)
        return loss._value, [o._value for o in _leaves(outs)]

    (loss, outs), (g, gx) = jax.jit(jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True))(
            params, [inputs[i] for i in fl])
    return (float(loss), [np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in g.items()},
            [np.asarray(v) for v in gx])


def ref_forward(ref, run, inputs):
    """``ref_run``'s loss and outputs without the gradients -> (loss,
    [outputs as numpy])."""
    fl = _floats(inputs)

    def forward(xs):
        args = list(inputs)
        for i, x in zip(fl, xs):
            args[i] = x
        args = [JaxTensor(a) if not isinstance(a, (int, float, type(None)))
                else a for a in args]
        loss, outs = run(ref, *args)
        return loss._value, [o._value for o in _leaves(outs)]
    loss, outs = jax.jit(forward)([inputs[i] for i in fl])
    return float(loss), [np.asarray(o) for o in outs]


def run_with(ref, params, run, args):
    """``run(ref, *args)`` with the reference's parameters swapped for
    ``params`` (traced), as ``functional_call`` does for a forward."""
    own = ref.state_dict()
    saved = {}
    try:
        for name, val in params.items():
            saved[name] = own[name]._value
            own[name]._value = val
        return run(ref, *args)
    finally:
        for name, v in saved.items():
            own[name]._value = v


def port_run(port, run, inputs):
    fl = _floats(inputs)
    args = [torch.tensor(a, requires_grad=i in fl)
            if isinstance(a, np.ndarray) else a
            for i, a in enumerate(inputs)]
    port.zero_grad()
    loss, outs = run(port, *args)
    loss.backward()
    return (float(loss.detach()),
            [o.detach().numpy() for o in _leaves(outs)],
            to_paddle_tpu_state(port, grads=True),
            [args[i].grad.numpy() for i in fl])


def assert_close(got, want, out_tol, grad_tol, grad_floor=1e-3):
    """Loss within ``out_tol`` relative, each output within ``out_tol`` of
    its largest entry, each gradient within ``grad_tol`` of its largest
    (floor ``grad_floor``); the outputs only when ``want`` has no
    gradients (``ref_forward``)."""
    (loss, outs), (w_loss, w_outs) = got[:2], want[:2]
    assert abs(loss - w_loss) <= out_tol * max(abs(w_loss), 1.0)
    assert len(outs) == len(w_outs)
    for o, w in zip(outs, w_outs):
        assert o.shape == w.shape
        assert np.abs(o - w).max() <= out_tol * max(np.abs(w).max(), 1.0)
    if len(want) == 2:
        return
    grads, gx = got[2:]
    w_grads, w_gx = want[2:]
    assert sorted(k for k, v in grads.items() if v is not None) == \
        sorted(w_grads)
    for k, w in w_grads.items():
        assert np.abs(grads[k] - w).max() <= \
            grad_tol * max(np.abs(w).max(), grad_floor), k
    for g, w in zip(gx, w_gx):
        assert np.abs(g - w).max() <= grad_tol * max(np.abs(w).max(),
                                                     grad_floor)
