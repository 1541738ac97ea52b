"""Three ``engine.build_train_step`` steps of ``chip_smoke.py``'s
SSD (``_torch_detection.ssd_pair``: MobileNetV1 ``scale=0.25``, 96 x 96,
5 classes) against the reference's ``engine.build_train_step`` on the
same network and weights, on the CPU: the reference's ``loss_fn(params,
buffers, batch)`` form on both sides (``chip_smoke.ssd_loss_fn``),
PaddleDetection's optimizer (``RMSProp(learning_rate=0.001)`` with
``L2Decay(5e-5)``), BatchNorm frozen (eval: in train mode the fp32
backward is ill-conditioned, ``test_torch_ssd.py``, and RMSProp's first
step turns the gradients' last bits into 8e-3 of the next loss). Each
step's loss within 1e-5; after three steps every parameter within 1e-4
of its tensor's largest entry (the port's fp32 steps lie 1.7e-6 of it
from its own fp64 ones) and the buffers unchanged on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_detection import close_to_max, ref_ssd_loss_fn, ssd_pair
from paddle_tpu import engine as jengine
from paddle_tpu import optimizer as jopt
from paddle_tpu.nn.layer_base import buffer_values, param_values
from paddle_tpu.nn.regularizer import L2Decay as JL2Decay

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.engine.builder import persistent_buffers
from paddle_tpu_torch.interop import to_paddle_tpu_state
from paddle_tpu_torch.nn.regularizer import L2Decay

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


@pytest.fixture(scope='module')
def pair():
    return ssd_pair()


def test_three_rmsprop_steps_match_reference(pair):
    ref, port, state, batch = pair
    ref.eval()
    port.eval()
    rstep = jengine.build_train_step(
        ref_ssd_loss_fn(ref, port.priors.numpy(), port.prior_vars.numpy()),
        jopt.RMSProp(learning_rate=0.001, weight_decay=JL2Decay(5e-5)))
    rstate = rstep.init_state(
        {k: jnp.asarray(state[k]) for k in param_values(ref, False)},
        {k: jnp.asarray(state[k]) for k in buffer_values(ref)})
    step = build_train_step(
        cs.ssd_loss_fn(port), topt.RMSProp(learning_rate=0.001,
                                           weight_decay=L2Decay(5e-5)),
        params=dict(port.named_parameters()),
        buffers=persistent_buffers(port), device='cpu')
    pstate = step.init_state()
    tb = tuple(torch.from_numpy(a) for a in batch)
    jb = tuple(jnp.asarray(a) for a in batch)
    losses = []
    for i in range(3):
        rstate, rres = rstep(rstate, jb)
        pstate, res = step(pstate, tb)
        np.testing.assert_allclose(float(res.loss), float(rres.loss),
                                   rtol=LOSS_TOL, err_msg=f'step {i}')
        losses.append(float(res.loss))
    assert losses[2] < losses[0]
    got = to_paddle_tpu_state(port)
    for k, v in rstate['params'].items():
        close_to_max(got[k], v, PARAM_TOL, k)
        assert not np.array_equal(got[k], state[k]), k
    for k, v in rstate['buffers'].items():
        np.testing.assert_array_equal(got[k], state[k])
        np.testing.assert_array_equal(np.asarray(v), state[k])
