"""The port's RoI pools and deformable ops against the JAX package's, on
the CPU (each reference call under one ``jax.jit``,
``tests/_torch_detection.py``).

- ``roi_pool``, ``psroi_pool``, ``prroi_pool``, ``roi_perspective_transform``,
  ``deformable_roi_pooling``: within 1e-5.
- ``deformable_conv`` on the reference's parameters (an ``Assign``
  initializer on both sides), v2 and v1, grouped: the output within 1e-5
  and the gradients of the input, the offsets and the mask within 1e-4 of
  their largest entry against ``jax.grad``; ``_deform_one``'s weight
  gradient the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.initializer as jinit
import paddle_tpu.vision.detection_train as jdt
from _torch_detection import boxes, close, port, port_vjp, ref, ref_vjp
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch.nn.initializer as tinit
from paddle_tpu_torch.vision import detection_train as tdt

TOL = 1e-5
GRAD_TOL = 1e-4


def JT_(a):
    return Tensor(jnp.asarray(a))


def _rois_two_images(rs):
    """Rois inside the 8 x 9 map at scale 0.6, where the reference's
    ``roi_align`` (behind ``prroi_pool``) samples as upstream does."""
    return np.concatenate([boxes(rs, 3, 12.0, 0.1), boxes(rs, 2, 12.0, 0.1)])


@pytest.mark.parametrize('op', ['roi_pool', 'psroi_pool', 'prroi_pool'])
def test_roi_pools_match_reference(op):
    rs = np.random.RandomState(23)
    x = rs.randn(2, 8, 8, 9).astype(np.float32)
    rois = _rois_two_images(rs)
    num = np.array([3, 2], np.int32)
    if op == 'roi_pool':
        kw = dict(pooled_height=2, pooled_width=3, spatial_scale=0.6)
    elif op == 'psroi_pool':
        kw = dict(output_channels=2, spatial_scale=0.6, pooled_height=2,
                  pooled_width=2)
    else:
        kw = dict(spatial_scale=0.6, pooled_height=2, pooled_width=3)
    arg = 'batch_roi_nums' if op == 'prroi_pool' else 'rois_num'

    def jfn(xv, rv, n):
        return getattr(jdt, op)(xv, rv, **{arg: n}, **kw)

    def tfn(xv, rv, n):
        return getattr(tdt, op)(xv, rv, **{arg: n}, **kw)
    close(port(tfn, x, rois, num), ref(jfn, x, rois, num), TOL, op)
    cot = rs.randn(*port(tfn, x, rois, num).shape).astype(np.float32)
    _, (pg,) = port_vjp(tfn, [x, rois, num], cot, (0,))
    _, (rg,) = ref_vjp(jfn, [x, rois, num], cot, (0,))
    close(pg, rg, GRAD_TOL, f'{op} gradient')


def test_perspective_transform_and_deformable_roi_pooling_match_reference():
    rs = np.random.RandomState(24)
    x = rs.randn(1, 3, 10, 12).astype(np.float32)
    quad = np.array([[1, 1, 9, 2, 10, 8, 2, 7],
                     [3, 0, 11, 1, 11, 9, 0, 9]], np.float32)
    kw = dict(transformed_height=4, transformed_width=5, spatial_scale=0.9)
    close(port(tdt.roi_perspective_transform, x, quad, **kw),
          ref(jdt.roi_perspective_transform, x, quad, **kw), TOL,
          'roi_perspective_transform')
    rois = boxes(rs, 4, 10.0, 0.2)
    trans = (0.5 * rs.randn(4, 2, 2, 3)).astype(np.float32)
    for kw in (dict(spatial_scale=0.9, pooled_height=2, pooled_width=3,
                    sample_per_part=2, trans_std=0.2),
               dict(no_trans=True, pooled_height=2, pooled_width=3)):
        close(port(tdt.deformable_roi_pooling, x, rois, trans, **kw),
              ref(jdt.deformable_roi_pooling, x, rois, trans, **kw), TOL,
              'deformable_roi_pooling')


@pytest.mark.parametrize('case', ['v2', 'v1_groups'])
def test_deformable_conv_and_gradients_match_reference(case):
    rs = np.random.RandomState(25)
    B, C, H, W, F, k = 2, 4, 6, 7, 6, 3
    groups, dg, modulated = (1, 2, True) if case == 'v2' else (2, 1, False)
    stride, pad = (1, 1) if case == 'v2' else (2, 0)
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    x = rs.randn(B, C, H, W).astype(np.float32)
    off = (1.5 * rs.randn(B, 2 * dg * k * k, Ho, Wo)).astype(np.float32)
    mask = rs.rand(B, dg * k * k, Ho, Wo).astype(np.float32)
    w = (0.3 * rs.randn(F, C // groups, k, k)).astype(np.float32)
    b = rs.randn(F).astype(np.float32)
    kw = dict(num_filters=F, filter_size=k, stride=stride, padding=pad,
              groups=groups, deformable_groups=dg, modulated=modulated)

    def jfn(xv, ov, mv):
        return jdt.deformable_conv(
            xv, ov, mv if modulated else None,
            param_attr=jinit.ParamAttr(initializer=jinit.Assign(w)),
            bias_attr=jinit.ParamAttr(initializer=jinit.Assign(b)), **kw)

    def tfn(xv, ov, mv):
        return tdt.deformable_conv(
            xv, ov, mv if modulated else None,
            param_attr=tinit.ParamAttr(initializer=tinit.Assign(w)),
            bias_attr=tinit.ParamAttr(initializer=tinit.Assign(b)), **kw)
    cot = rs.randn(B, F, Ho, Wo).astype(np.float32)
    argnums = (0, 1, 2) if modulated else (0, 1)
    rout, rgrads = ref_vjp(jfn, [x, off, mask], cot, argnums)
    pout, pgrads = port_vjp(tfn, [x, off, mask], cot, argnums)
    close(pout, rout, TOL, 'deformable_conv')
    for what, g, r in zip(('input', 'offset', 'mask'), pgrads, rgrads):
        close(g, r, GRAD_TOL, f'deformable_conv {what} gradient')
    # the weight's gradient, through the per-image function
    args = (k, k, (stride, stride), (pad, pad), (1, 1), groups)
    m0 = mask[0] if modulated else None

    def jone(wv):
        return jdt._deform_one(jnp.asarray(x[0]), jnp.asarray(off[0]), wv,
                               None if m0 is None else jnp.asarray(m0),
                               *args)
    rw = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jone(v) * cot[0])))(
        jnp.asarray(w)))
    wt = torch.tensor(w, requires_grad=True)
    out = tdt._deform_one(torch.from_numpy(x[0]), torch.from_numpy(off[0]),
                          wt, None if m0 is None else torch.from_numpy(m0),
                          *args)
    (out * torch.from_numpy(cot[0])).sum().backward()
    close(wt.grad.numpy(), rw, GRAD_TOL, 'deformable weight gradient')
    gen = torch.Generator().manual_seed(0)
    drawn = tdt.deformable_conv(torch.from_numpy(x), torch.from_numpy(off),
                                torch.from_numpy(mask) if modulated
                                else None, generator=gen, **kw)
    assert drawn.shape == (B, F, Ho, Wo) and torch.isfinite(drawn).all()
