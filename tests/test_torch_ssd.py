"""The SSD of ``chip_smoke.py`` (``SSDMobileNet``: MobileNetV1,
four extra pairs, 1 x 1 heads, ``prior_box`` priors, ``ssd_loss``,
``detection_output`` through ``SSDDetector``) at a small size
(``_torch_detection.ssd_pair``: MobileNetV1 ``scale=0.25``, 96 x 96, 5
classes, 204 priors) against the same network built from the JAX
package's modules, on shared weights (``interop``), on the CPU (the
three train steps are in ``test_torch_ssd_steps.py``):

- train mode: the loss within 1e-5 and BatchNorm's running statistics
  within 1e-4 of each tensor's largest entry;
- every gradient within 1e-4 of its tensor's largest entry (a floor of
  1e-3 of the largest gradient) with BatchNorm frozen (eval), the loss
  within 1e-5. Frozen, the port's fp32 gradients lie 7.7e-7 from its own
  fp64 ones at this size. In train mode the fp32 backward through the
  BatchNorms is ill-conditioned: the port's own fp32 pass lies 3.9e-3 of
  the model's largest gradient entry from its fp64 pass here (3.4e-2 at
  300 x 300), so the chip's ``train_ssd`` holds the train-mode gradients
  in fp64, GPU against CPU;
- ``detection_output`` on the port's heads against the reference's on
  its heads after the softmax (upstream's rule): kept indices and counts
  equal, rows within 1e-4; ``SSDDetector`` returns the same.

The reference runs under one ``jax.jit`` a case; the networks and their
state are made once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu.vision.detection_train as jdt
from _torch_detection import close_to_max, ref, ref_ssd_loss_fn, ssd_pair
from paddle_tpu.nn.layer_base import buffer_values, param_values

from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                      to_paddle_tpu_state)
from paddle_tpu_torch.vision import detection_output, ssd_loss

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-4


@pytest.fixture(scope='module')
def pair():
    return ssd_pair()


def _ref_batch(batch):
    return tuple(jnp.asarray(a) for a in batch)


@pytest.fixture(scope='module')
def ref_eval(pair):
    """The reference with BatchNorm frozen, under one ``jax.jit``: the
    loss, every gradient, and the heads (loc, conf)."""
    ref, port, state, batch = pair
    loss_fn = ref_ssd_loss_fn(ref, port.priors.numpy(),
                              port.prior_vars.numpy())
    ref.eval()

    @jax.jit
    def run(p, b, xb):
        def f(p):
            loss, heads, _ = loss_fn(p, b, xb)
            return loss, heads
        return jax.value_and_grad(f, has_aux=True)(p)
    (loss, heads), grads = run(param_values(ref, False), buffer_values(ref),
                               _ref_batch(batch))
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
            [np.asarray(h) for h in heads])


def _port_loss(port, batch, train):
    port.train(train)
    port.zero_grad(set_to_none=True)
    images, gt, lab = (torch.from_numpy(a) for a in batch)
    loc, conf = port(images)
    loss = ssd_loss(loc, conf, gt, lab, port.priors, port.prior_vars,
                    **cs.SSD_LOSS).sum()
    return loss


def test_train_mode_loss_and_statistics_match_reference(pair):
    ref, port, state, batch = pair
    load_paddle_tpu_state(port, state)
    loss_fn = ref_ssd_loss_fn(ref, port.priors.numpy(),
                              port.prior_vars.numpy())
    ref.train()
    rloss, _, rnew = jax.jit(loss_fn)(param_values(ref, False),
                                      buffer_values(ref), _ref_batch(batch))
    with torch.no_grad():
        loss = _port_loss(port, batch, True)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_TOL)
    stats = {k: v for k, v in to_paddle_tpu_state(port).items()
             if k.endswith(('_mean', '_variance'))}
    assert set(stats) == set(rnew) and len(stats) == 70
    for k, v in stats.items():
        close_to_max(v, rnew[k], STAT_TOL, k)
        assert not np.array_equal(v, state[k]), k      # they moved


def test_every_gradient_matches_reference(pair, ref_eval):
    _, port, state, batch = pair
    rloss, rgrads, _ = ref_eval
    load_paddle_tpu_state(port, state)
    loss = _port_loss(port, batch, False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), rloss, rtol=LOSS_TOL)
    pgrads = to_paddle_tpu_state(port, grads=True)
    assert set(pgrads) == set(rgrads)
    top = max(np.abs(g).max() for g in rgrads.values())
    for k, rg in rgrads.items():
        close_to_max(pgrads[k], rg, GRAD_TOL, k, 1e-3 * top)


def test_detection_output_matches_reference(pair, ref_eval):
    _, port, state, batch = pair
    rloc, rconf = ref_eval[2]
    load_paddle_tpu_state(port, state)
    port.eval()
    probs = torch.softmax(torch.tensor(rconf), -1).numpy()
    want = ref(jdt.detection_output, rloc, probs, port.priors.numpy(),
               port.prior_vars.numpy(), return_index=True, **cs.SSD_DETECT)
    x = torch.from_numpy(batch[0])
    with torch.no_grad():
        loc, conf = port(x)
        got = detection_output(loc, conf, port.priors, port.prior_vars,
                               return_index=True, **cs.SSD_DETECT)
        served = cs.SSDDetector(port)(x)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    close_to_max(got[0].numpy(), want[0], 1e-4, 'rows')
    assert torch.equal(served[0], got[0]) and torch.equal(served[1], got[2])
    assert int(got[2].min()) > 0
