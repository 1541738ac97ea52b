"""The port's convolutions and pooling against the JAX package's, on the
CPU, at small sizes: the same numpy inputs through
``paddle_tpu.nn.functional`` and ``paddle_tpu_torch.nn.functional``.
The rest of the vision ``nn`` is in ``test_torch_vision_norm.py``,
``test_torch_vision_functional.py`` and ``test_torch_vision_faults.py``.

- Convolutions (1-3 D, transposed too) in every padding form (an int,
  one per dim, ``(lo, hi)`` pairs, a 2n list, ``'SAME'`` at stride 2,
  ``'VALID'``), groups, dilation and both data formats: the output within
  1e-5 and the gradients of the input, weight and bias (``jax.vjp`` of
  the reference under one ``jax.jit``, ``backward`` of the port, under one
  random cotangent) within 1e-4 of each gradient's largest entry.
- Pooling: max and average, 1-3 D, every ``ceil_mode`` / ``exclusive`` /
  ``divisor_override`` / string-padding branch, both data formats, the
  adaptive pools, forward and gradient at the same tolerances; the max
  pools' argmax masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT

from paddle_tpu_torch import nn as tnn
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


# ---------------------------------------------------------------------------

CONV2D = [
    dict(padding=1),
    dict(padding=0, stride=2),
    dict(padding='SAME', stride=2),
    dict(padding='SAME', stride=1, dilation=2),
    dict(padding='VALID', stride=2),
    dict(padding=[1, 2], stride=1),
    dict(padding=[1, 2, 0, 1], stride=2),
    dict(padding=[(2, 0), (0, 1)], stride=1),
    dict(padding=1, groups=2, dilation=2),
]

@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', range(len(CONV2D)))
def test_conv2d_forward_and_gradients_match_reference(case, fmt):
    kw = CONV2D[case]
    rs = np.random.RandomState(case)
    x = _rand(rs, 2, 4, 9, 8)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    w = _rand(rs, 6, 4 // kw.get('groups', 1), 3, 3)
    b = _rand(rs, 6)
    _assert_vjp(lambda x, w, b: JF.conv2d(x, w, b, data_format=fmt, **kw),
                lambda x, w, b: TF.conv2d(x, w, b, data_format=fmt, **kw),
                [x, w, b], case)

@pytest.mark.parametrize('n,fmt', [(1, 'NCL'), (1, 'NLC'), (3, 'NCDHW'),
                                   (3, 'NDHWC')])
def test_conv1d_conv3d_match_reference(n, fmt):
    rs = np.random.RandomState(n)
    spatial = (7,) * n
    x = _rand(rs, 2, 3, *spatial)
    if fmt[-1] == 'C':
        x = np.moveaxis(x, 1, -1).copy()
    w = _rand(rs, 4, 3, *(3,) * n)
    b = _rand(rs, 4)
    name = f'conv{n}d'
    pad = 'SAME' if n == 1 else [1, 0] * n
    _assert_vjp(lambda x, w, b: getattr(JF, name)(
                    x, w, b, stride=2, padding=pad, data_format=fmt),
                lambda x, w, b: getattr(TF, name)(
                    x, w, b, stride=2, padding=pad, data_format=fmt),
                [x, w, b], n)

CONV_T = [
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=2, padding=0),
    dict(stride=1, padding=[1, 0, 2, 1]),
    dict(stride=2, padding=[(0, 1), (2, 0)]),
    dict(stride=2, padding=1, dilation=2),
]

@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', range(len(CONV_T)))
def test_conv2d_transpose_matches_reference(case, fmt):
    kw = CONV_T[case]
    rs = np.random.RandomState(10 + case)
    x = _rand(rs, 2, 4, 5, 6)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    w = _rand(rs, 4, 3, 3, 3)
    b = _rand(rs, 3)
    _assert_vjp(
        lambda x, w, b: JF.conv2d_transpose(x, w, b, data_format=fmt, **kw),
        lambda x, w, b: TF.conv2d_transpose(x, w, b, data_format=fmt, **kw),
        [x, w, b], case)

@pytest.mark.parametrize('n', [1, 3])
def test_conv1d_conv3d_transpose_match_reference(n):
    rs = np.random.RandomState(20 + n)
    x = _rand(rs, 2, 3, *(4,) * n)
    w = _rand(rs, 3, 2, *(3,) * n)
    name = f'conv{n}d_transpose'
    _assert_vjp(lambda x, w: getattr(JF, name)(x, w, stride=2, padding=1),
                lambda x, w: getattr(TF, name)(x, w, stride=2, padding=1),
                [x, w], n)

def test_conv_layers_initialise_as_the_reference():
    """KaimingUniform(negative_slope=sqrt(5)) weights and Uniform(+-1 /
    sqrt(fan_in)) biases: the same bound (the draws differ)."""
    gen = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(8, 16, 3, groups=2, device='cpu', generator=gen)
    ref = jnn.Conv2D(8, 16, 3, groups=2)
    bound = 1.0 / np.sqrt(4 * 9)
    for p, r in ((conv.weight, ref.weight), (conv.bias, ref.bias)):
        assert tuple(p.shape) == tuple(r.shape)
        assert float(p.abs().max()) <= bound
        assert float(np.abs(r.numpy()).max()) <= bound
        assert float(p.abs().max()) > 0.8 * bound
    t = tnn.Conv2DTranspose(8, 4, 3, groups=2, device='cpu', generator=gen)
    assert tuple(t.weight.shape) == (8, 2, 3, 3)
    assert tnn.Conv2D(3, 4, 3, bias_attr=False, device='cpu').bias is None

def test_conv_amp_o1_casts_input_and_weight():
    from paddle_tpu_torch import amp
    x = torch.randn(1, 3, 6, 6)
    conv = tnn.Conv2D(3, 4, 3, device='cpu')
    with amp.auto_cast(level='O1', dtype='bfloat16'):
        y = conv(x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().detach().numpy(),
                               conv(x).detach().numpy(), atol=0.1)

# ---------------------------------------------------------------------------

POOL2D = [
    ('max', dict(kernel_size=3, stride=2, padding=1)),
    ('max', dict(kernel_size=3, stride=2, padding=0, ceil_mode=True)),
    ('max', dict(kernel_size=2, stride=2, padding='SAME')),
    ('max', dict(kernel_size=3, stride=1, padding=[1, 0])),
    ('avg', dict(kernel_size=3, stride=2, padding=1)),
    ('avg', dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ('avg', dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ('avg', dict(kernel_size=2, stride=2, padding=0, ceil_mode=True)),
    ('avg', dict(kernel_size=3, stride=2, padding='SAME')),
    ('avg', dict(kernel_size=2, stride=1, padding=1, divisor_override=3)),
]

@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', range(len(POOL2D)))
def test_pool2d_forward_and_gradients_match_reference(case, fmt):
    kind, kw = POOL2D[case]
    rs = np.random.RandomState(30 + case)
    x = _rand(rs, 2, 3, 9, 8)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    name = f'{kind}_pool2d'
    _assert_vjp(lambda x: getattr(JF, name)(x, data_format=fmt, **kw),
                lambda x: getattr(TF, name)(x, data_format=fmt, **kw),
                [x], case)

@pytest.mark.parametrize('name,kw', [
    ('max_pool1d', dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ('avg_pool1d', dict(kernel_size=3, stride=2, padding=1)),
    ('avg_pool1d', dict(kernel_size=3, stride=2, padding=1,
                        exclusive=False)),
    ('max_pool3d', dict(kernel_size=2, stride=2, padding=1)),
    ('avg_pool3d', dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ('avg_pool3d', dict(kernel_size=2, stride=2, data_format='NDHWC')),
])
def test_pool1d_pool3d_match_reference(name, kw):
    rs = np.random.RandomState(len(name))
    shape = (2, 3, 9) if '1d' in name else (2, 3, 5, 6, 5)
    x = _rand(rs, *shape)
    _assert_vjp(lambda x: getattr(JF, name)(x, **kw),
                lambda x: getattr(TF, name)(x, **kw), [x])

@pytest.mark.parametrize('name,size,fmt', [
    ('adaptive_avg_pool2d', (3, 5), 'NCHW'),
    ('adaptive_avg_pool2d', 1, 'NHWC'),
    ('adaptive_avg_pool2d', (4, 2), 'NCHW'),
    ('adaptive_max_pool2d', (3, 4), None),
    ('adaptive_avg_pool1d', 4, None),
    ('adaptive_max_pool1d', 3, None),
    ('adaptive_avg_pool3d', (2, 3, 2), 'NCDHW'),
    ('adaptive_max_pool3d', 2, None),
])
def test_adaptive_pools_match_reference(name, size, fmt):
    rs = np.random.RandomState(7)
    shape = {'1d': (2, 3, 10), '2d': (2, 3, 7, 9), '3d': (2, 3, 5, 7, 6)}[
        name[-2:]]
    x = _rand(rs, *shape)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    kw = {} if fmt is None else {'data_format': fmt}
    _assert_vjp(lambda x: getattr(JF, name)(x, size, **kw),
                lambda x: getattr(TF, name)(x, size, **kw), [x])

@pytest.mark.parametrize('kind,fmt', [('avg', 'NCHW'), ('max', 'NHWC')])
def test_global_pool_matches_reference(kind, fmt):
    x = _rand(np.random.RandomState(3), 2, 5, 4, 3)
    _assert_vjp(lambda x: JF.global_pool(x, kind, fmt),
                lambda x: TF.global_pool(x, kind, fmt), [x])

def test_max_pool_mask_is_the_argmax():
    """``return_mask``: each output's flat argmax in its (unpadded) input
    plane, as upstream Paddle returns it; the values gathered back from
    the input are the pooled ones, in both formats."""
    x = torch.from_numpy(_rand(np.random.RandomState(5), 2, 3, 7, 6))
    for fmt in ('NCHW', 'NHWC'):
        v = x if fmt == 'NCHW' else x.permute(0, 2, 3, 1).contiguous()
        out, mask = TF.max_pool2d(v, 3, 2, 1, return_mask=True,
                                  ceil_mode=True, data_format=fmt)
        if fmt == 'NHWC':
            out, mask = out.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2)
        got = torch.gather(x.reshape(2, 3, -1), 2, mask.reshape(2, 3, -1))
        assert torch.equal(got.reshape(out.shape), out)
    out, mask = TF.adaptive_max_pool2d(x, (3, 2), return_mask=True)
    got = torch.gather(x.reshape(2, 3, -1), 2, mask.reshape(2, 3, -1))
    assert torch.equal(got.reshape(out.shape), out)
