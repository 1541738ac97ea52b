"""The port's ResNet-50 against the JAX package's, on the CPU, on the
reference's weights: the eval forward (4x3x64x64) within 1e-4 of the
logits' largest entry, the train-mode forward and the running statistics
after it within 1e-3: the first BatchNorm's batch sums already differ by
~1.4e-6 of the activations between XLA's and torch's CPU reductions (the
convolution before it is bitwise equal), and 52 more train-mode
BatchNorms grow that to 4.6e-4 at the last stage (measured stage by
stage); the eval forward, whose BatchNorms only scale and shift, stays at
1e-7. The state moves through ``interop`` both ways key for key. The
reference runs under one ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.vision as jvision
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn.layer_base import (buffer_values, functional_call,
                                      param_values)

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)


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


def _round_trip(port, state):
    back = to_paddle_tpu_state(port)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_resnet50_train_and_eval_forwards_match_reference():
    paddle.seed(9)
    ref = jvision.resnet50(num_classes=10)
    state = _state(ref, 10)
    _ref_with(ref, state)
    port = tvision.resnet50(num_classes=10, device='cpu')
    load_paddle_tpu_state(port, state)
    _round_trip(port, state)
    x = np.random.RandomState(11).randn(4, 3, 64, 64).astype(np.float32)
    params = param_values(ref, trainable_only=False)
    buffers = buffer_values(ref)

    def fwd(training):
        ref.train() if training else ref.eval()

        @jax.jit
        def run(p, b, xv):
            out, new = functional_call(ref, {**p, **b}, JT(xv))
            return out._value, new
        return run(params, buffers, jnp.asarray(x))
    for training in (True, False):
        want, new = fwd(training)
        load_paddle_tpu_state(port, state)   # the statistics before
        port.train(training)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        _close(got, want, 1e-3 if training else 1e-4,
               f'training={training}')
        if training:
            for k, v in port.state_dict().items():
                if k.endswith(('_mean', '_variance')):
                    _close(v.numpy(), new[k], 1e-3, k)
    ref.train()
