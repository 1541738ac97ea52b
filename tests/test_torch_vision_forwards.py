"""Eval forwards of the port's LeNet, MobileNetV2 (x0.5) and VGG11 on the
reference's weights (``interop.load_paddle_tpu_state``, which also checks
their state keys and shapes) against the JAX package's, on the CPU,
within 1e-4 of the logits' largest entry; ``pretrained=True`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision as jvision
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn.layer_base import (buffer_values, functional_call,
                                      param_values)

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.interop import load_paddle_tpu_state



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


def test_small_models_forward_match_reference():
    """Eval forwards of LeNet, MobileNetV2 (x0.5) and VGG11 on the
    reference's weights."""
    paddle.seed(14)
    rs = np.random.RandomState(15)
    for name, kw, shape in (('LeNet', {}, (2, 1, 28, 28)),
                            ('mobilenet_v2', {'scale': 0.5},
                             (2, 3, 32, 32)),
                            ('vgg11', {}, (1, 3, 32, 32))):
        ref = getattr(jvision.models, name)(num_classes=10, **kw)
        state = _state(ref, 16)
        _ref_with(ref, state).eval()
        port = getattr(tvision.models, name)(num_classes=10, device='cpu',
                                             **kw)
        load_paddle_tpu_state(port, state)
        port.eval()
        x = rs.randn(*shape).astype(np.float32)
        params, buffers = param_values(ref, False), buffer_values(ref)
        run = jax.jit(lambda p, b, v: functional_call(
            ref, {**p, **b}, JT(v))[0]._value)
        want = run(params, buffers, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        _close(got, want, 1e-4, name)
    for fn in (tvision.resnet50, tvision.vgg16, tvision.mobilenet_v2):
        with pytest.raises(RuntimeError):
            fn(pretrained=True, device='cpu')
