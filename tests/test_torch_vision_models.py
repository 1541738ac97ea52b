"""The port's ResNets against the JAX package's, on the CPU, on the
reference's weights (``interop.load_paddle_tpu_state``); the other
vision models are in ``test_torch_vision_zoo.py`` and BatchNorm's buffers
in the train step in ``test_torch_vision_buffers.py``.

- ``resnet18`` (NCHW, 2x3x64x64, 10 classes) in train mode: the loss
  within 1e-5, every gradient within 1e-4 of its tensor's largest entry,
  the running statistics after the forward within 1e-5; one
  ``BottleneckBlock`` with a downsample the same way. 64x64 and not
  32x32: at 32x32 the last stage is 1x1, so each of its BatchNorms in
  train mode normalises two values a channel, an output of +-1 that
  multiplies the rounding differences before it by the inverse of their
  distance (5e-3 of the logits at layer 4 from 2e-5 at layer 3).
- ResNet-50 is in ``test_torch_vision_resnet50.py``.
- NHWC equals NCHW, and the space-to-depth stem the plain stem, in the
  port (1e-5).
- ResNet-18's state moves through ``interop`` both ways key for key.

The reference runs under one ``jax.jit`` a case (eagerly, op by op, a
ResNet costs tens of seconds on this CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.vision as jvision
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn.layer_base import (buffer_values, functional_call,
                                      param_values)

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _state(ref, seed):
    """The reference's state with its running statistics moved off their
    zeros and ones (a swap of the two would pass otherwise)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in ref.state_dict().items():
        v = np.asarray(v.numpy())
        if k.endswith('_mean'):
            v = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith('_variance'):
            v = (1 + 0.2 * rs.rand(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _ref_with(ref, state):
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return ref


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (what, err)


def _ref_train_loss_and_grads(ref, x, y):
    params = param_values(ref, trainable_only=False)
    buffers = buffer_values(ref)

    @jax.jit
    def run(p, b, xv, yv):
        def loss_of(p):
            logits, new = functional_call(ref, {**p, **b}, JT(xv))
            loss = JF.cross_entropy(logits, JT(yv))
            return loss._value, new
        (loss, new), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        return loss, grads, new
    loss, grads, new = run(params, buffers, jnp.asarray(x), jnp.asarray(y))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, \
        {k: np.asarray(v) for k, v in new.items()}


def _port_train_loss_and_grads(port, x, y):
    port.train()
    loss = TF.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    grads = to_paddle_tpu_state(port, grads=True)
    bufs = {k: v.numpy().copy() for k, v in port.state_dict().items()
            if k.endswith(('_mean', '_variance'))}
    return float(loss), grads, bufs


@pytest.fixture(scope='module')
def r18():
    paddle.seed(3)
    ref = jvision.resnet18(num_classes=10)
    state = _state(ref, 4)
    _ref_with(ref, state)
    port = tvision.resnet18(num_classes=10, device='cpu')
    load_paddle_tpu_state(port, state)
    _round_trip(port, state)
    return ref, port, state


def _round_trip(port, state):
    back = to_paddle_tpu_state(port)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_resnet18_loss_gradients_and_running_stats_match_reference(r18):
    ref, port, state = r18
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, 2).astype(np.int64)
    rloss, rgrads, rbufs = _ref_train_loss_and_grads(ref, x, y)
    ploss, pgrads, pbufs = _port_train_loss_and_grads(port, x, y)
    np.testing.assert_allclose(ploss, rloss, rtol=LOSS_TOL)
    assert set(pgrads) == set(rgrads)
    for k in rgrads:
        _close(pgrads[k], rgrads[k], GRAD_TOL, k)
    assert set(pbufs) == set(rbufs)
    for k in rbufs:
        np.testing.assert_allclose(pbufs[k], rbufs[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bottleneck_block_with_downsample_matches_reference():
    paddle.seed(6)
    ds = jnn.Sequential(jnn.Conv2D(16, 32, 1, stride=2, bias_attr=False),
                        jnn.BatchNorm2D(32))
    ref = jvision.models.resnet.BottleneckBlock(16, 8, stride=2,
                                                downsample=ds)
    state = _state(ref, 7)
    _ref_with(ref, state)
    kw = dict(device='cpu')
    port = tvision.models.BottleneckBlock(
        16, 8, stride=2, downsample=tnn.Sequential(
            tnn.Conv2D(16, 32, 1, stride=2, bias_attr=False, **kw),
            tnn.BatchNorm2D(32, **kw)), **kw)
    load_paddle_tpu_state(port, state)
    rs = np.random.RandomState(8)
    x = rs.randn(2, 16, 8, 8).astype(np.float32)
    g = rs.randn(2, 32, 4, 4).astype(np.float32)
    params, buffers = param_values(ref, trainable_only=False), \
        buffer_values(ref)

    @jax.jit
    def run(p, xv):
        def f(p, xv):
            out, new = functional_call(ref, {**p, **buffers}, JT(xv))
            return jnp.sum(out._value * g), new
        (v, new), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(p, xv)
        return v, grads, new
    rv, (rg, rgx), rnew = run(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(float((out * torch.from_numpy(g)).sum()),
                               float(rv), rtol=1e-5)
    _close(xt.grad.numpy(), rgx, GRAD_TOL, 'x')
    pg = to_paddle_tpu_state(port, grads=True)
    for k in rg:
        _close(pg[k], rg[k], GRAD_TOL, k)
    for k, v in port.state_dict().items():
        if k.endswith(('_mean', '_variance')):
            np.testing.assert_allclose(v.numpy(), np.asarray(rnew[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_nhwc_and_space_to_depth_stem_equal_nchw(r18):
    _, port, state = r18
    x = np.random.RandomState(12).randn(2, 3, 64, 64).astype(np.float32)
    nhwc = tvision.resnet18(num_classes=10, data_format='NHWC', device='cpu')
    s2d = tvision.resnet18(num_classes=10, data_format='NHWC',
                           space_to_depth_stem=True, device='cpu')
    for m in (nhwc, s2d):
        load_paddle_tpu_state(m, state)
    xh = torch.from_numpy(x.transpose(0, 2, 3, 1).copy())
    for training in (False, True):
        outs = []
        for m, v in ((port, torch.from_numpy(x)), (nhwc, xh), (s2d, xh)):
            load_paddle_tpu_state(m, state)
            m.train(training)
            with torch.no_grad():
                outs.append(m(v).numpy())
        _close(outs[1], outs[0], 1e-5, 'nhwc')
        _close(outs[2], outs[0], 1e-5, 's2d')
    with pytest.raises(ValueError):
        tvision.resnet18(space_to_depth_stem=True, device='cpu')


