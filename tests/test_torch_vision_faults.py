"""The rest of the port's vision functionals against the JAX package's,
on the CPU, and the reference's faults.

- (``interpolate`` and ``pad`` are in ``test_torch_vision_resize.py``)
  the pixel shuffles, ``unfold`` / ``fold``,
  ``bilinear``, ``cosine_similarity``, ``affine_grid`` / ``grid_sample``,
  ``one_hot``, ``label_smooth``: the output within 1e-5 and the input
  gradients under one random cotangent within 1e-4 of each gradient's
  largest entry; the channel-wise dropouts, ``weight_norm`` and
  ``spectral_norm``.
- The reference's faults (ROADMAP.md, Queue 3), each a
  ``test_reference_fault_*`` that shows what the reference does and what
  the port does instead.
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


def test_other_functionals_match_reference():
    rs = np.random.RandomState(17)
    x = _rand(rs, 2, 8, 4, 6)
    for fmt in ('NCHW', 'NHWC'):
        v = x if fmt == 'NCHW' else x.transpose(0, 2, 3, 1).copy()
        _assert_vjp(lambda a: JF.pixel_shuffle(a, 2, fmt),
                    lambda a: TF.pixel_shuffle(a, 2, fmt), [v])
        _assert_vjp(lambda a: JF.pixel_unshuffle(a, 2, fmt),
                    lambda a: TF.pixel_unshuffle(a, 2, fmt), [v])
    _assert_vjp(lambda a: JF.unfold(a, [2, 3], 1, [1, 0, 0, 1], 1),
                lambda a: TF.unfold(a, [2, 3], 1, [1, 0, 0, 1], 1), [x])
    cols = _rand(rs, 2, 8 * 6, 15)
    _assert_vjp(lambda a: JF.fold(a, [4, 5], [2, 3], 1, [0, 1], 1),
                lambda a: TF.fold(a, [4, 5], [2, 3], 1, [0, 1], 1), [cols])
    a, b = _rand(rs, 3, 4), _rand(rs, 3, 5)
    w, bias = _rand(rs, 2, 4, 5), _rand(rs, 2)
    _assert_vjp(JF.bilinear, TF.bilinear, [a, b, w, bias])
    _assert_vjp(lambda p, q: JF.cosine_similarity(p, q, axis=1),
                lambda p, q: TF.cosine_similarity(p, q, axis=1),
                [a, _rand(rs, 3, 4)])
    theta = _rand(rs, 2, 2, 3) * 0.5
    for ac in (True, False):
        _assert_vjp(lambda t: JF.affine_grid(t, [2, 3, 4, 5], ac),
                    lambda t: TF.affine_grid(t, [2, 3, 4, 5], ac), [theta])
    grid = np.clip(_rand(rs, 2, 3, 4, 2) * 0.7, -1.2, 1.2)
    img = _rand(rs, 2, 3, 5, 6)
    for mode in ('bilinear', 'nearest'):
        for pm in ('zeros', 'border'):
            _assert_vjp(lambda v: JF.grid_sample(v, JT(jnp.asarray(grid)),
                                                 mode, pm, False),
                        lambda v: TF.grid_sample(v, torch.from_numpy(grid),
                                                 mode, pm, False), [img])
    lab = rs.randint(0, 4, 5)
    np.testing.assert_array_equal(
        TF.one_hot(torch.from_numpy(lab), 4).numpy(),
        np.asarray(JF.one_hot(JT(jnp.asarray(lab)), 4)._value))
    oh = np.eye(4, dtype=np.float32)[lab]
    _assert_vjp(lambda v: JF.label_smooth(v, epsilon=0.2),
                lambda v: TF.label_smooth(v, epsilon=0.2), [oh])

def test_dropout2d_drops_whole_channels_from_the_state():
    from paddle_tpu_torch.kernels.philox import DropoutState
    st = DropoutState(3)
    x = torch.ones(4, 6, 3, 3)
    y = TF.dropout2d(x, 0.5, True, dropout_state=st)
    per = y.reshape(4, 6, -1)
    assert torch.all((per == 0).all(-1) | (per == 2).all(-1))
    assert 0 < int((per[..., 0] == 0).sum()) < 24
    assert torch.equal(TF.dropout2d(x, 0.5, False), x)
    assert torch.equal(tnn.Dropout(0.3, mode='downscale_in_infer').eval()(x),
                       x * (1 - 0.3))
    a = TF.alpha_dropout(x, 0.2, True, dropout_state=st)
    assert a.shape == x.shape and len(torch.unique(a)) == 2

def test_weight_norm_and_spectral_norm_keep_the_reference_names():
    conv = tnn.Conv2D(3, 4, 3, device='cpu')
    w = conv.weight.detach().clone()
    tnn.weight_norm(conv, dim=0)
    assert sorted(n for n, _ in conv.named_parameters()) == \
        ['bias', 'weight_g', 'weight_v']
    x = torch.randn(1, 3, 5, 5)
    y = conv(x)
    y.sum().backward()
    assert conv.weight_g.grad is not None
    torch.testing.assert_close(conv.weight, w)
    tnn.remove_weight_norm(conv)
    torch.testing.assert_close(conv.weight.detach(), w)
    ref = jnn.Conv2D(3, 4, 3)
    from paddle_tpu.nn.utils import weight_norm as jwn
    jwn(ref)
    assert sorted(ref.state_dict()) == sorted(
        ['bias', 'weight_g', 'weight_v'])
    lin = tnn.Linear(4, 3, device='cpu')
    tnn.spectral_norm(lin, generator=torch.Generator().manual_seed(0))
    assert 'weight_orig' in dict(lin.named_parameters())
    assert sorted(dict(lin.named_buffers())) == ['weight_sn.weight_u',
                                                 'weight_sn.weight_v']
    out = lin(torch.randn(2, 4))
    assert out.shape == (2, 3)
    s = torch.linalg.matrix_norm(lin.weight, ord=2)
    assert float(s) < 1.5

def test_reference_fault_max_pool_mask_is_zeros():
    """The reference's ``return_mask`` returns zeros from every max pool
    (``paddle_tpu/nn/functional/pooling.py:109-113``, ``:162-163``); the
    port returns the argmax (``test_max_pool_mask_is_the_argmax``)."""
    x = _rand(np.random.RandomState(18), 1, 2, 4, 4)
    _, rmask = JF.max_pool2d(JT(jnp.asarray(x)), 2, 2, return_mask=True)
    assert not np.asarray(rmask._value).any()
    _, rmask = JF.adaptive_max_pool2d(JT(jnp.asarray(x)), 2,
                                      return_mask=True)
    assert not np.asarray(rmask._value).any()
    _, mask = TF.max_pool2d(torch.from_numpy(x), 2, 2, return_mask=True)
    assert mask.any()

def test_reference_fault_conv_padding_mode_is_ignored():
    """``Conv2D(padding_mode='reflect')`` pads with zeros in the
    reference (the mode is stored nowhere); the port reflects, as
    upstream Paddle does."""
    rs = np.random.RandomState(19)
    x = _rand(rs, 1, 2, 5, 5)
    ref = jnn.Conv2D(2, 3, 3, padding=1, padding_mode='reflect')
    zeros = jnn.Conv2D(2, 3, 3, padding=1)
    zeros.weight.set_value(ref.weight.numpy())
    zeros.bias.set_value(ref.bias.numpy())
    xr = JT(jnp.asarray(x))
    np.testing.assert_array_equal(ref(xr).numpy(), zeros(xr).numpy())
    port = tnn.Conv2D(2, 3, 3, padding=1, padding_mode='reflect',
                      device='cpu')
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(ref.weight.numpy()))
        port.bias.copy_(torch.from_numpy(ref.bias.numpy()))
    got = port(torch.from_numpy(x)).detach().numpy()
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x), (1, 1, 1, 1),
                                mode='reflect'),
        port.weight, port.bias).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got - ref(xr).numpy()).max() > 1e-3

def test_reference_fault_conv_transpose_ignores_output_size():
    """A transposed conv's ``output_size`` is a bare ``pass`` in the
    reference (``paddle_tpu/nn/functional/conv.py:92-94``); the port
    turns it into the output padding, as upstream Paddle does."""
    rs = np.random.RandomState(20)
    x, w = _rand(rs, 1, 2, 4, 4), _rand(rs, 2, 3, 3, 3)
    ref = JF.conv2d_transpose(JT(jnp.asarray(x)), JT(jnp.asarray(w)),
                              stride=2, padding=1, output_size=[8, 8])
    assert tuple(ref.shape) == (1, 3, 7, 7)
    got = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                              stride=2, padding=1, output_size=[8, 8])
    assert tuple(got.shape) == (1, 3, 8, 8)
    opad = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                               stride=2, padding=1, output_padding=1)
    assert torch.equal(got, opad)

def test_reference_fault_interpolate_area_runs_linear():
    """``interpolate(mode='area')`` is linear in the reference
    (``paddle_tpu/nn/functional/common.py:201``); the port averages the
    adaptive pooling bins, upstream Paddle's area."""
    x = _rand(np.random.RandomState(21), 1, 2, 6, 6)
    ref = JF.interpolate(JT(jnp.asarray(x)), size=(3, 3), mode='area')
    lin = JF.interpolate(JT(jnp.asarray(x)), size=(3, 3), mode='bilinear')
    np.testing.assert_array_equal(ref.numpy(), lin.numpy())
    got = TF.interpolate(torch.from_numpy(x), size=(3, 3), mode='area')
    want = x.reshape(1, 2, 3, 2, 3, 2).mean(axis=(3, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

def test_reference_fault_remove_weight_norm_uses_dim_0():
    """``remove_weight_norm`` renormalises over dim 0 in the reference
    whatever ``dim`` the norm was applied with
    (``paddle_tpu/nn/utils.py:42-48``): the weight comes back changed.
    The port folds it back over the same ``dim``."""
    from paddle_tpu.nn.utils import remove_weight_norm as jrm
    from paddle_tpu.nn.utils import weight_norm as jwn
    ref = jnn.Conv2D(3, 4, 3)
    w0 = ref.weight.numpy().copy()
    jwn(ref, dim=1)
    jrm(ref)
    # the folded parameter (the hook's last weight stays an attribute)
    assert np.abs(ref.state_dict()['weight'].numpy() - w0).max() > 1e-3
    port = tnn.Conv2D(3, 4, 3, device='cpu')
    p0 = port.weight.detach().clone()
    tnn.weight_norm(port, dim=1)
    tnn.remove_weight_norm(port)
    torch.testing.assert_close(port.weight.detach(), p0)

def test_reference_fault_grouped_conv_transpose_refuses_its_weight():
    """The reference's grouped transposed conv reads its (in, out /
    groups) weight with an ``'IO'`` spec and ``feature_group_count=
    groups`` (``paddle_tpu/nn/functional/conv.py:53``, ``:76``), which
    lax refuses; the port computes upstream's grouped transposed
    convolution (each group's channels to its own outputs)."""
    rs = np.random.RandomState(22)
    x, w = _rand(rs, 1, 4, 3, 3), _rand(rs, 4, 3, 2, 2)
    with pytest.raises(Exception):
        np.asarray(JF.conv2d_transpose(JT(jnp.asarray(x)),
                                       JT(jnp.asarray(w)), stride=2,
                                       groups=2)._value)
    got = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                              stride=2, groups=2)
    halves = [TF.conv2d_transpose(torch.from_numpy(x[:, 2 * i:2 * i + 2]),
                                  torch.from_numpy(w[2 * i:2 * i + 2]),
                                  stride=2) for i in range(2)]
    assert torch.allclose(got, torch.cat(halves, 1), atol=1e-6)

def test_reference_fault_conv_transpose_string_padding_raises():
    """A transposed conv with ``padding='SAME'`` or ``'VALID'`` raises in
    the reference (lax refuses a string padding with ``lhs_dilation``);
    the port pads as upstream Paddle: ``'VALID'`` nothing, ``'SAME'`` to
    an output of ``in * stride``."""
    rs = np.random.RandomState(23)
    x, w = _rand(rs, 1, 2, 4, 5), _rand(rs, 2, 3, 3, 3)
    for pad in ('SAME', 'VALID'):
        with pytest.raises(ValueError):
            JF.conv2d_transpose(JT(jnp.asarray(x)), JT(jnp.asarray(w)),
                                stride=2, padding=pad)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    same = TF.conv2d_transpose(xt, wt, stride=2, padding='SAME')
    assert tuple(same.shape) == (1, 3, 8, 10)
    assert torch.equal(same, TF.conv2d_transpose(xt, wt, stride=2,
                                                 padding=[0, 1, 0, 1]))
    assert torch.equal(TF.conv2d_transpose(xt, wt, stride=2, padding='VALID'),
                       TF.conv2d_transpose(xt, wt, stride=2, padding=0))


def test_spectral_norm_matches_reference_from_the_same_vectors():
    """``SpectralNorm`` on the reference's power-iteration vectors: the
    normalised weight and the advanced vectors within 1e-5 (the
    reference's layer writes its vectors in place, so it runs eagerly and
    is not differentiated here)."""
    rs = np.random.RandomState(24)
    w = _rand(rs, 4, 3, 2, 2)
    ref = jnn.SpectralNorm([4, 3, 2, 2], dim=1, power_iters=2)
    port = tnn.SpectralNorm([4, 3, 2, 2], dim=1, power_iters=2,
                            device='cpu')
    with torch.no_grad():
        port.weight_u.copy_(torch.from_numpy(np.array(ref.weight_u.numpy())))
        port.weight_v.copy_(torch.from_numpy(np.array(ref.weight_v.numpy())))
    want = np.asarray(ref(JT(jnp.asarray(w)))._value)
    wt = torch.tensor(w, requires_grad=True)
    got = port(wt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    got.sum().backward()
    assert torch.isfinite(wt.grad).all()
    for name in ('weight_u', 'weight_v'):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name).numpy()),
                                   rtol=1e-5, atol=1e-6)
