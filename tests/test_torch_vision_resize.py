"""The port's ``interpolate`` and ``pad`` against the JAX package's, on the
CPU: ``interpolate`` in every mode and both formats (Paddle's
``align_corners`` / ``align_mode`` coordinates, ``jax.image``'s cubic,
linear on NCW and trilinear on NCDHW), ``pad`` in every mode on the
spatial dims and on all four; the output within 1e-5 and the input
gradients under one random cotangent (``jax.vjp`` of the reference under
one ``jax.jit``) within 1e-4 of each gradient's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JT

from paddle_tpu_torch.nn import functional as TF

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _port_vjp(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(np.asarray(g)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_vjp(ref_fn, port_fn, arrays, seed=0):
    """The reference's output and its input gradients under one random
    cotangent (``jax.vjp``, under one ``jax.jit``: eagerly each new
    shape costs a second) against the port's."""
    arrays = [np.asarray(a) for a in arrays]

    def fwd(*vals):
        return ref_fn(*[JT(v) for v in vals])._value
    shape = jax.eval_shape(fwd, *arrays)
    g = np.asarray(np.random.RandomState(seed + 100).randn(*shape.shape),
                   np.float32)

    @jax.jit
    def out_and_grads(*vals):
        out, vjp = jax.vjp(fwd, *vals)
        return out, vjp(jnp.asarray(g, out.dtype))
    rout, rgrads = out_and_grads(*arrays)
    rout = np.asarray(rout)
    pout, pgrads = _port_vjp(port_fn, arrays, g)
    assert pout.shape == rout.shape
    np.testing.assert_allclose(pout, rout, rtol=FWD_TOL, atol=FWD_TOL)
    for i, (pg, rg) in enumerate(zip(pgrads, rgrads)):
        rg = np.asarray(rg)
        err = np.abs(pg - rg).max()
        assert err <= GRAD_TOL * max(np.abs(rg).max(), 1.0), (i, err)


INTERP = [
    dict(size=(7, 5), mode='nearest'),
    dict(scale_factor=2, mode='nearest'),
    dict(size=(7, 9), mode='bilinear', align_corners=True),
    dict(size=(7, 9), mode='bilinear', align_corners=False, align_mode=0),
    dict(size=(3, 2), mode='bilinear', align_corners=False, align_mode=1),
    dict(scale_factor=1.5, mode='bilinear'),
    dict(size=(8, 10), mode='bicubic'),
    dict(size=(2, 3), mode='bicubic'),
]

@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', range(len(INTERP)))
def test_interpolate_matches_reference(case, fmt):
    x = _rand(np.random.RandomState(14 + case), 2, 3, 4, 5)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    kw = INTERP[case]
    _assert_vjp(lambda v: JF.interpolate(v, data_format=fmt, **kw),
                lambda v: TF.interpolate(v, data_format=fmt, **kw), [x])

def test_interpolate_linear_and_trilinear_match_reference():
    rs = np.random.RandomState(15)
    x1, x3 = _rand(rs, 2, 3, 6), _rand(rs, 1, 2, 3, 4, 3)
    _assert_vjp(lambda v: JF.interpolate(v, size=9, mode='linear',
                                         data_format='NCW'),
                lambda v: TF.interpolate(v, size=9, mode='linear',
                                         data_format='NCW'), [x1])
    _assert_vjp(lambda v: JF.interpolate(v, size=(5, 3, 4), mode='trilinear',
                                         align_corners=True,
                                         data_format='NCDHW'),
                lambda v: TF.interpolate(v, size=(5, 3, 4), mode='trilinear',
                                         align_corners=True,
                                         data_format='NCDHW'), [x3])

@pytest.mark.parametrize('mode', ['constant', 'reflect', 'replicate',
                                  'circular'])
@pytest.mark.parametrize('pad', [[1, 2, 0, 1], [1, 0, 2, 1, 0, 1, 1, 2]])
def test_pad_matches_reference(mode, pad):
    x = _rand(np.random.RandomState(16), 2, 3, 4, 5)
    _assert_vjp(lambda v: JF.pad(v, pad, mode=mode, value=0.5),
                lambda v: TF.pad(v, pad, mode=mode, value=0.5), [x])
