"""The port's ``vision/ops.py`` against the JAX package's, on the CPU, on
numpy inputs from a seed (each reference call under one ``jax.jit``,
``tests/_torch_detection.py``).

- IoU, ``box_coder`` (encode and decode on both axes, the variance as a
  tensor, 4 numbers or None), ``box_clip``, ``yolo_box``: within 1e-5 of
  each output's largest entry (at least 1).
- ``prior_box``, ``density_prior_box``, ``anchor_generator``: host numpy
  on both sides, equal bit for bit, on the device asked for.
- ``nms`` and ``multiclass_nms`` (``return_index``, a background class,
  ``keep_top_k`` past the candidates): kept indices equal, the rows within
  1e-6; the greedy result against a plain Python greedy loop; equal scores
  keep their index order (a stable sort).
- ``roi_align`` with a positive ``sampling_ratio`` on rois inside the map
  (where the reference follows upstream): the output within 1e-5 and the
  input gradient under one random cotangent within 1e-4 of its largest
  entry against ``jax.grad``, ``rois_num`` as a list and as a tensor.
- Every name of the reference's ``_FLUID_ALIASES`` that the port has
  resolves from ``nn.functional`` to the function in ``vision``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu.vision.detection_train as jdt
import paddle_tpu.vision.ops as jops
from _torch_detection import boxes, close, port, port_vjp, ref, ref_vjp
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.vision import detection_train as tdt
from paddle_tpu_torch.vision import ops as tops

TOL = 1e-5
GRAD_TOL = 1e-4


def JT_(a):
    return Tensor(jnp.asarray(a))


def test_iou_box_coder_and_clip_match_reference():
    rs = np.random.RandomState(0)
    a, b = boxes(rs, 5), boxes(rs, 7)
    for norm in (True, False):
        close(port(tops.iou_similarity, a * 9, b * 9, box_normalized=norm),
              ref(jops.iou_similarity, a * 9, b * 9, box_normalized=norm),
              TOL, 'iou')
    prior = boxes(rs, 6)
    var = (0.1 + 0.2 * rs.rand(6, 4)).astype(np.float32)
    target = boxes(rs, 4)
    for norm in (True, False):
        close(port(tops.box_coder, prior, var, target, box_normalized=norm),
              ref(jops.box_coder, prior, var, target, box_normalized=norm),
              TOL, 'encode, tensor variance')
        for v in ([0.1, 0.1, 0.2, 0.2], None):
            got = tops.box_coder(torch.from_numpy(prior), v,
                                 torch.from_numpy(target),
                                 box_normalized=norm).numpy()
            want = np.asarray(jops.box_coder(
                JT_(prior), v, JT_(target), box_normalized=norm)._value)
            close(got, want, TOL, f'encode, variance {v}')
    deltas = (0.5 * rs.randn(4, 6, 4)).astype(np.float32)
    for axis, pri, vv in ((0, prior, var), (1, prior[:4], var[:4])):
        close(port(tops.box_coder, pri, vv, deltas,
                   code_type='decode_center_size', axis=axis),
              ref(jops.box_coder, pri, vv, deltas,
                  code_type='decode_center_size', axis=axis),
              TOL, f'decode axis {axis}')
        for v in ([0.1, 0.1, 0.2, 0.2], None):
            got = tops.box_coder(torch.from_numpy(pri), v,
                                 torch.from_numpy(deltas),
                                 code_type='decode_center_size',
                                 axis=axis).numpy()
            want = np.asarray(jops.box_coder(
                JT_(pri), v, JT_(deltas), code_type='decode_center_size',
                axis=axis)._value)
            close(got, want, TOL, f'decode axis {axis}, variance {v}')
    big = (rs.randn(2, 5, 4) * 40 + 20).astype(np.float32)
    info = np.array([[30, 40, 1.0], [60, 50, 2.0]], np.float32)
    close(port(tops.box_clip, big, info), ref(jops.box_clip, big, info),
          TOL, 'box_clip')


@pytest.mark.parametrize('kw', [
    dict(min_sizes=[30.], aspect_ratios=[2.], flip=True),
    dict(min_sizes=[30., 60.], max_sizes=[60., 90.],
         aspect_ratios=[2., 3.], flip=True, clip=True),
    dict(min_sizes=[30.], max_sizes=[60.], aspect_ratios=[2.],
         min_max_aspect_ratios_order=True, steps=[8., 8.], offset=0.3),
])
def test_prior_box_is_the_reference_bit_for_bit(kw):
    feat, img = np.zeros((1, 2, 5, 4), np.float32), \
        np.zeros((1, 3, 40, 32), np.float32)
    got = tops.prior_box(torch.from_numpy(feat), torch.from_numpy(img),
                         device='cpu', **kw)
    want = jops.prior_box(JT_(feat), JT_(img), **kw)
    for g, w in zip(got, want):
        assert g.device.type == 'cpu'
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._value))


def test_density_prior_box_and_anchor_generator_bit_for_bit():
    feat, img = np.zeros((1, 2, 3, 4), np.float32), \
        np.zeros((1, 3, 24, 32), np.float32)
    for flat in (False, True):
        kw = dict(densities=[2, 1], fixed_sizes=[8., 16.],
                  fixed_ratios=[1., 2.], clip=True, flatten_to_2d=flat)
        got = tops.density_prior_box(feat, img, device='cpu', **kw)
        want = jops.density_prior_box(JT_(feat), JT_(img), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w._value))
    got = tops.anchor_generator(feat, anchor_sizes=[32., 64.],
                                aspect_ratios=[0.5, 1., 2.],
                                stride=[8., 8.], device='cpu')
    want = jops.anchor_generator(JT_(feat), anchor_sizes=[32., 64.],
                                 aspect_ratios=[0.5, 1., 2.],
                                 stride=[8., 8.])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._value))
    if not torch.cuda.is_available():      # the default device is CUDA
        with pytest.raises(RuntimeError, match='CUDA'):
            tops.prior_box(feat, img, [30.])


def test_yolo_box_matches_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 2 * (5 + 3), 4, 5).astype(np.float32)
    size = np.array([[128, 160], [96, 100]], np.int32)
    for clip, sxy in ((True, 1.0), (False, 1.2)):
        kw = dict(anchors=[10, 13, 16, 30], class_num=3, conf_thresh=0.4,
                  downsample_ratio=32, clip_bbox=clip, scale_x_y=sxy)
        for g, w in zip(port(tops.yolo_box, x, size, **kw),
                        ref(jops.yolo_box, x, size, **kw)):
            close(g, w, TOL, 'yolo_box')


def _greedy(bx, sc, thr, k, score_thr=-np.inf, off=0.0):
    """Plain Python greedy NMS over the ``k`` best candidates above
    ``score_thr`` (a stable order) -> kept original indices."""
    idx = [int(i) for i in np.argsort(-sc, kind='stable')
           if sc[i] > score_thr][:k]
    keep = []
    for i in idx:
        a = bx[i]
        ok = True
        for j in keep:
            b = bx[j]
            iw = max(min(a[2], b[2]) - max(a[0], b[0]) + off, 0)
            ih = max(min(a[3], b[3]) - max(a[1], b[1]) + off, 0)
            inter = iw * ih
            union = ((a[2] - a[0] + off) * (a[3] - a[1] + off)
                     + (b[2] - b[0] + off) * (b[3] - b[1] + off) - inter)
            if inter / union > thr:
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


def _clustered(rs, n, clusters=4):
    """Boxes around a few centers: long suppression chains."""
    c = rs.rand(clusters, 2) * 0.6 + 0.2
    pick = rs.randint(0, clusters, n)
    ctr = c[pick] + 0.03 * rs.randn(n, 2)
    wh = 0.15 + 0.05 * rs.rand(n, 2)
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def test_nms_is_the_greedy_result_and_the_reference():
    rs = np.random.RandomState(2)
    bx = _clustered(rs, 40)
    sc = rs.rand(40).astype(np.float32)
    sc[5] = sc[9] = sc[30] = 0.5                        # ties: index order
    for thr, k in ((0.3, 64), (0.5, 25), (0.7, 40)):
        order, alive = port(tops.nms, bx, sc, iou_threshold=thr, top_k=k,
                            score_threshold=0.1)
        rorder, ralive = ref(jops.nms, bx, sc, iou_threshold=thr, top_k=k,
                             score_threshold=0.1)
        np.testing.assert_array_equal(order, rorder)
        np.testing.assert_array_equal(alive, ralive)
        assert list(order[alive]) == _greedy(bx, sc, thr, k, 0.1)


def test_multiclass_nms_matches_reference():
    rs = np.random.RandomState(3)
    B, M, C = 2, 30, 4
    bb = np.stack([_clustered(rs, M) for _ in range(B)])
    sc = rs.rand(B, C, M).astype(np.float32)
    for kw in (dict(score_threshold=0.2, nms_top_k=20, keep_top_k=25,
                    nms_threshold=0.4, background_label=0),
               dict(score_threshold=0.0, nms_top_k=-1, keep_top_k=200,
                    nms_threshold=0.5, background_label=-1),
               dict(score_threshold=0.3, nms_top_k=8, keep_top_k=10,
                    nms_threshold=0.3, background_label=2,
                    normalized=False)):
        got = port(tops.multiclass_nms, bb, sc, return_index=True, **kw)
        want = ref(jops.multiclass_nms, bb, sc, return_index=True, **kw)
        np.testing.assert_array_equal(got[1], want[1])       # indices
        np.testing.assert_array_equal(got[2], want[2])       # counts
        close(got[0], want[0], 1e-6, 'rows')
        two = tops.multiclass_nms(torch.from_numpy(bb), torch.from_numpy(sc),
                                  **kw)
        assert len(two) == 2 and torch.equal(two[0],
                                             torch.from_numpy(got[0]))


@pytest.mark.parametrize('rois_num', [None, 'list', 'tensor'])
def test_roi_align_and_its_gradient_match_reference(rois_num):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.concatenate([boxes(rs, 3, 8.0), boxes(rs, 2, 8.0)])
    rois[:, 2] = np.minimum(rois[:, 2] * 1.2, 9.5)
    kw = dict(pooled_height=2, pooled_width=3, spatial_scale=1.1,
              sampling_ratio=2)
    arrays, rkw, pkw = [x, rois], dict(kw), dict(kw)
    if rois_num == 'list':
        rkw['rois_num'] = pkw['rois_num'] = [3, 2]
    elif rois_num == 'tensor':
        arrays.append(np.array([3, 2], np.int32))
    cot = rs.randn(5, 3, 2, 3).astype(np.float32)

    def jfn(xv, rv, *rest):
        return jops.roi_align(xv, rv, rois_num=rest[0] if rest else
                              rkw.get('rois_num'), **kw)

    def tfn(xv, rv, *rest):
        return tops.roi_align(xv, rv, rois_num=rest[0] if rest else
                              pkw.get('rois_num'), **kw)
    rout, (rg,) = ref_vjp(jfn, arrays, cot, (0,))
    pout, (pg,) = port_vjp(tfn, arrays, cot, (0,))
    close(pout, rout, TOL, 'roi_align')
    close(pg, rg, GRAD_TOL, 'roi_align input gradient')


def test_functional_aliases_resolve_to_the_vision_functions():
    det = sorted(n for n in JF._FLUID_ALIASES
                 if n in jops.__all__ or n in jdt.__all__)
    assert sorted(TF._FLUID_ALIASES) == det and len(det) == 29
    for name in det:
        fn = getattr(TF, name)
        assert fn is getattr(tops if name in tops.__all__ else tdt, name)
        assert name in TF.__all__
        if name in tdt.__all__:
            assert fn is getattr(tvision, name)
    assert set(tops.__all__) == set(jops.__all__)
    assert set(tdt.__all__) == set(jdt.__all__)
    for name in tops.__all__:
        assert callable(getattr(tvision.ops, name))
    for name in tdt.__all__:
        assert getattr(tvision, name) is getattr(tvision.detection_train,
                                                 name)
    with pytest.raises(AttributeError):
        TF.warpctc
