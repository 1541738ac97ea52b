"""The port's ``vision/detection_train.py`` against the JAX package's, on
the CPU: matching, the SSD loss and head, and YOLOv3 (the NMS forms, the
RPN / RetinaNet assigners and the focal loss are in
``test_torch_detection_nms.py``, the proposal, FPN and sampler ops in
``test_torch_detection_proposals.py``, the RoI and deformable ops in
``test_torch_detection_roi.py``). Each reference call
runs under one ``jax.jit`` (``tests/_torch_detection.py``).

- ``bipartite_match`` (greedy and per-prediction), ``target_assign``:
  indices equal, values within 1e-5.
- ``ssd_loss`` and ``yolov3_loss``: the loss within 1e-5, and the
  gradients of one random cotangent with respect to the location and
  confidence (SSD) and ``x`` (YOLOv3) within 1e-4 of their largest entry,
  against ``jax.grad``.
- ``multi_box_head``: priors bit for bit; the heads' outputs within 1e-5
  on the port's convolution weights carried into the reference's call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu.static.nn as jstatic_nn
import paddle_tpu.vision.detection_train as jdt
from _torch_detection import close, port, port_vjp, ref, ref_vjp, ssd_inputs
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.vision import detection_train as tdt

TOL = 1e-5
GRAD_TOL = 1e-4


def JT_(a):
    return Tensor(jnp.asarray(a))


def test_bipartite_match_and_target_assign_match_reference():
    rs = np.random.RandomState(10)
    dist = rs.rand(3, 4, 9).astype(np.float32)
    dist[1, 3] = 0.0                                    # a padded gt row
    dist[2, 0, 5] = dist[2, 1, 2] = 0.99                # tied maxima
    for kw in (dict(), dict(match_type='per_prediction', dist_threshold=0.6)):
        got = port(tdt.bipartite_match, dist, **kw)
        want = ref(jdt.bipartite_match, dist, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        close(got[1], want[1], TOL, 'matched distance')
    got2 = port(tdt.bipartite_match, dist[0])
    np.testing.assert_array_equal(got2[0], ref(jdt.bipartite_match,
                                               dist[0])[0])
    x = rs.randn(3, 4, 5).astype(np.float32)
    match = port(tdt.bipartite_match, dist)[0]
    neg = (rs.rand(3, 9) > 0.6).astype(np.int32)
    for args in ((x, match), (x, match, neg)):
        got = port(tdt.target_assign, *args, mismatch_value=7.0)
        want = ref(jdt.target_assign, *args, mismatch_value=7.0)
        for g, w in zip(got, want):
            close(g, w, TOL, 'target_assign')


@pytest.mark.parametrize('kw', [
    dict(),
    dict(match_type='bipartite', neg_pos_ratio=2.0, normalize=False,
         background_label=0, loc_loss_weight=0.5, sample_size=5),
])
def test_ssd_loss_and_gradients_match_reference(kw):
    rs = np.random.RandomState(11)
    arrays = list(ssd_inputs(rs))
    cot = rs.randn(2, 1).astype(np.float32)
    rout, rgrads = ref_vjp(jdt.ssd_loss, arrays, cot, (0, 1), **kw)
    pout, pgrads = port_vjp(tdt.ssd_loss, arrays, cot, (0, 1), **kw)
    close(pout, rout, TOL, 'ssd_loss')
    for what, g, w in zip(('location', 'confidence'), pgrads, rgrads):
        close(g, w, GRAD_TOL, what)
    nvar = port(tdt.ssd_loss, *arrays[:5])
    close(nvar, ref(jdt.ssd_loss, *arrays[:5]), TOL, 'no variance')


YOLO = dict(anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119],
            anchor_mask=[3, 4, 5], class_num=4, ignore_thresh=0.5,
            downsample_ratio=16)


@pytest.mark.parametrize('kw', [dict(), dict(use_label_smooth=False,
                                             scale_x_y=1.1)])
def test_yolov3_loss_and_gradient_match_reference(kw):
    rs = np.random.RandomState(15)
    B, G, H = 2, 5, 4
    x = rs.randn(B, 3 * (5 + 4), H, H).astype(np.float32)
    # gt centres off cell (0, 0), where a padded row points
    gt = np.concatenate([0.3 + 0.65 * rs.rand(B, G, 2),
                         0.1 + 0.5 * rs.rand(B, G, 2)], -1).astype(np.float32)
    gt[0, -1] = 0.0
    lab = rs.randint(0, 4, (B, G)).astype(np.int32)
    score = rs.rand(B, G).astype(np.float32)
    cot = rs.randn(B).astype(np.float32)
    for arrays in ([x, gt, lab], [x, gt, lab, score]):
        def jfn(*a):
            return jdt.yolov3_loss(*a[:3], gt_score=a[3] if len(a) > 3
                                   else None, **YOLO, **kw)

        def tfn(*a):
            return tdt.yolov3_loss(*a[:3], gt_score=a[3] if len(a) > 3
                                   else None, **YOLO, **kw)
        rout, (rg,) = ref_vjp(jfn, arrays, cot, (0,))
        pout, (pg,) = port_vjp(tfn, arrays, cot, (0,))
        close(pout, rout, TOL, 'yolov3 loss')
        close(pg, rg, GRAD_TOL, 'yolov3 gradient')


def test_multi_box_head_matches_reference_on_the_ports_weights(monkeypatch):
    rs = np.random.RandomState(18)
    feats = [rs.randn(2, 4, 4, 4).astype(np.float32),
             rs.randn(2, 6, 2, 2).astype(np.float32)]
    img = np.zeros((2, 3, 32, 32), np.float32)
    kw = dict(base_size=32, num_classes=3, aspect_ratios=[[2.], [2., 3.]],
              min_sizes=[6., 12.], max_sizes=[[], 20.], flip=True,
              kernel_size=3, pad=1)
    got = tdt.multi_box_head([torch.from_numpy(f) for f in feats],
                             torch.from_numpy(img),
                             generator=torch.Generator().manual_seed(5),
                             **kw)
    # the same draws, in the port's order: per map, the loc then the conf
    gen = torch.Generator().manual_seed(5)
    convs = []
    for f, n in zip(feats, (3, 6)):
        for width in (4, 3):
            c = tnn.Conv2D(f.shape[1], n * width, 3, padding=1,
                           device='cpu', generator=gen)
            convs.append((c.weight.detach().numpy(),
                          c.bias.detach().numpy()))
    calls = iter(convs)

    def conv2d(input, num_filters, filter_size, stride=1, padding=0, **_):
        w, b = next(calls)
        assert w.shape[0] == num_filters
        return JF.conv2d(input, JT_(w), JT_(b), stride=stride,
                         padding=padding)
    monkeypatch.setattr(jstatic_nn, 'conv2d', conv2d)
    want = jdt.multi_box_head([JT_(f) for f in feats], JT_(img), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w._value)
        if i < 2:
            close(g, w, TOL, 'heads')
        else:
            np.testing.assert_array_equal(g, w)
    assert got[2].shape == (4 * 4 * 3 + 2 * 2 * 6, 4)
