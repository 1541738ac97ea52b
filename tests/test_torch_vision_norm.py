"""The port's normalisation functionals and layers against the JAX
package's, on the CPU, at small sizes.

- ``batch_norm`` in training: the output, the running statistics after
  it (momentum 0.9 on the old value, the unbiased variance) and the
  gradients of x, weight and bias, fp32 (1e-5 / 1e-4 of each gradient's
  largest entry) and bf16 (2e-2), NCHW and NHWC; in eval and with
  ``use_global_stats`` (the buffers unchanged).
- The BatchNorm layers' state names; ``instance_norm``, ``group_norm``,
  ``local_response_norm`` and ``normalize`` in both formats.
- ``SyncBatchNorm``: plain BatchNorm without a group; its in-group
  arithmetic against the reference's inside a one-device ``shard_map``.
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


@pytest.mark.parametrize('fmt,dtype', [('NCHW', 'float32'),
                                       ('NHWC', 'float32'),
                                       ('NHWC', 'bfloat16')])
def test_batch_norm_training_matches_reference(fmt, dtype):
    """Outputs, running statistics (momentum 0.9 on the old value, the
    unbiased variance) and the gradients of x, weight and bias; the batch
    mean sits far from zero and from the running mean (the shifted
    statistics' case)."""
    rs = np.random.RandomState(1)
    x = _rand(rs, 4, 5, 3, 3) * 2 + 7
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _rand(rs, 5), _rand(rs, 5)
    rm0, rv0 = _rand(rs, 5), np.abs(_rand(rs, 5)) + 0.5
    g = _rand(rs, *x.shape)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = getattr(torch, dtype)

    def ref(x, w, b):
        return JF.batch_norm(x, JT(jnp.asarray(rm_r)), JT(jnp.asarray(rv_r)),
                             w, b, training=True, data_format=fmt)
    rm_r, rv_r = rm0.copy(), rv0.copy()
    rm_t, rv_t = JT(jnp.asarray(rm0)), JT(jnp.asarray(rv0))
    rout = JF.batch_norm(JT(jnp.asarray(x, jdt)), rm_t, rv_t,
                         JT(jnp.asarray(w, jdt)), JT(jnp.asarray(b, jdt)),
                         training=True, data_format=fmt)

    def f(xv, wv, bv):
        out = JF.batch_norm(JT(xv), JT(jnp.asarray(rm0)),
                            JT(jnp.asarray(rv0)), JT(wv), JT(bv),
                            training=True, data_format=fmt)
        return jnp.sum(out._value.astype(jnp.float32) * g)
    rg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x, jdt),
                                        jnp.asarray(w, jdt),
                                        jnp.asarray(b, jdt))

    xt = torch.tensor(x).to(tdt).requires_grad_()
    wt = torch.tensor(w).to(tdt).requires_grad_()
    bt = torch.tensor(b).to(tdt).requires_grad_()
    rmt, rvt = torch.tensor(rm0), torch.tensor(rv0)
    out = TF.batch_norm(xt, rmt, rvt, wt, bt, training=True,
                        data_format=fmt)
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = 2e-2 if dtype == 'bfloat16' else FWD_TOL
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(rout._value, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(rmt.numpy(), np.asarray(rm_t._value),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rvt.numpy(), np.asarray(rv_t._value),
                               rtol=1e-5, atol=1e-6)
    gtol = 2e-2 if dtype == 'bfloat16' else GRAD_TOL
    for got, want in zip((xt.grad, wt.grad, bt.grad), rg):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= gtol * max(np.abs(want).max(), 1.0), err

def test_batch_norm_eval_and_global_stats_match_reference():
    rs = np.random.RandomState(2)
    x, w, b = _rand(rs, 3, 4, 5), _rand(rs, 4), _rand(rs, 4)
    rm, rv = _rand(rs, 4), np.abs(_rand(rs, 4)) + 0.5
    for training, ugs in ((False, None), (True, True)):
        r_rm, r_rv = JT(jnp.asarray(rm)), JT(jnp.asarray(rv))
        want = JF.batch_norm(JT(jnp.asarray(x)), r_rm, r_rv,
                             JT(jnp.asarray(w)), JT(jnp.asarray(b)),
                             training=training, use_global_stats=ugs)
        t_rm, t_rv = torch.tensor(rm), torch.tensor(rv)
        got = TF.batch_norm(torch.tensor(x), t_rm, t_rv, torch.tensor(w),
                            torch.tensor(b), training=training,
                            use_global_stats=ugs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert torch.equal(t_rm, torch.tensor(rm))
        assert torch.equal(t_rv, torch.tensor(rv))

def test_batchnorm_layers_keep_the_reference_state_names():
    bn = tnn.BatchNorm2D(6, device='cpu')
    ref = jnn.BatchNorm2D(6)
    assert sorted(bn.state_dict()) == sorted(ref.state_dict())
    assert sorted(bn.state_dict()) == ['_mean', '_variance', 'bias',
                                       'weight']
    assert tnn.BatchNorm1D(3, weight_attr=False, device='cpu').weight is None
    x = torch.randn(4, 3, 5)
    bn1 = tnn.BatchNorm1D(3, device='cpu')
    bn1(x)
    assert not torch.equal(bn1._mean, torch.zeros(3))
    bn1.eval()
    before = bn1._mean.clone()
    bn1(x)
    assert torch.equal(bn1._mean, before)

@pytest.mark.parametrize('name', ['instance_norm', 'group_norm',
                                  'local_response_norm', 'normalize'])
@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
def test_other_norms_match_reference(name, fmt):
    rs = np.random.RandomState(4)
    x = _rand(rs, 2, 6, 4, 3)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _rand(rs, 6), _rand(rs, 6)
    if name == 'instance_norm':
        args = ([x, w, b], lambda F: lambda x, w, b: F.instance_norm(
            x, weight=w, bias=b, data_format=fmt))
    elif name == 'group_norm':
        args = ([x, w, b], lambda F: lambda x, w, b: F.group_norm(
            x, 3, 1e-5, w, b, data_format=fmt))
    elif name == 'local_response_norm':
        args = ([x], lambda F: lambda x: F.local_response_norm(
            x, 3, alpha=0.1, data_format=fmt))
    else:
        args = ([x], lambda F: lambda x: F.normalize(
            x, p=2 if fmt == 'NCHW' else 3, axis=1))
    arrays, make = args
    _assert_vjp(make(JF), make(TF), arrays)

def test_sync_batch_norm_without_a_group_is_batch_norm():
    x = torch.randn(4, 3, 2, 2)
    sbn = tnn.SyncBatchNorm(3, device='cpu')
    bn = tnn.BatchNorm2D(3, device='cpu')
    assert torch.equal(sbn(x), bn(x))
    assert torch.equal(sbn._mean, bn._mean)
    net = tnn.Sequential(tnn.Conv2D(3, 3, 1, device='cpu'),
                         tnn.BatchNorm2D(3, device='cpu'))
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    assert conv[1]._mean is net[1]._mean or conv is net
    assert sorted(conv.state_dict()) == sorted(
        tnn.Sequential(tnn.Conv2D(3, 3, 1, device='cpu'),
                       tnn.BatchNorm2D(3, device='cpu')).state_dict())

def test_sync_batch_norm_arithmetic_matches_reference_inside_shard_map():
    """The reference's SyncBatchNorm under one data axis of one device
    (inside ``shard_map``): sums in the input's dtype, the biased variance
    into the running value; the port's formula in a one-rank group is the
    same function (``F.norm.sync_batch_norm``)."""
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from paddle_tpu.distributed import env as jenv
    rs = np.random.RandomState(6)
    x = _rand(rs, 4, 3, 2, 2) + 1.5
    ref = jnn.SyncBatchNorm(3)
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    rm0 = np.asarray(ref._mean._value)

    def body(v):
        jenv.set_current_data_axis('data')
        try:
            out = ref(JT(v))
        finally:
            jenv.set_current_data_axis(None)
        return out._value, ref._mean._value, ref._variance._value
    out, rm, rv = shard_map(body, mesh=mesh, in_specs=P(),
                            out_specs=(P(), P(), P()))(jnp.asarray(x))
    t_rm, t_rv = torch.tensor(rm0), torch.ones(3)
    got = TF.norm.sync_batch_norm(torch.tensor(x), t_rm, t_rv, None, None,
                                  0.9, 1e-5, 'NCHW')
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t_rv.numpy(), np.asarray(rv), rtol=1e-6)
