"""The port's NMS forms, anchor assigners and focal loss against the JAX
package's, on the CPU: ``detection_output``, ``matrix_nms``,
``locality_aware_nms`` (with ``polygon_box_transform``),
``retinanet_detection_output``, ``rpn_target_assign``,
``retinanet_target_assign`` and ``sigmoid_focal_loss``, each reference
call under one ``jax.jit`` (``tests/_torch_detection.py``).

- ``detection_output`` on logits against the reference on the same
  scores after the softmax (upstream's rule; the reference skips it:
  ``test_torch_detection_faults.py``): kept indices and counts equal, the
  rows within 1e-6.
- The other NMS forms: kept rows within 1e-6 and counts equal;
  ``polygon_box_transform`` within 1e-5.
- The RPN and RetinaNet assigners: sampled rows, labels and weights equal,
  targets within 1e-5.
- ``sigmoid_focal_loss`` within 1e-5 and its gradient under one random
  cotangent within 1e-4 of its largest entry, against ``jax.grad``.
"""
import numpy as np
import torch

import paddle_tpu.vision.detection_train as jdt
from _torch_detection import (boxes, close, port, port_vjp, ref, ref_vjp,
                              ssd_inputs)

from paddle_tpu_torch.vision import detection_train as tdt
from paddle_tpu_torch.vision import ops as tops

TOL = 1e-5
GRAD_TOL = 1e-4


def test_detection_output_applies_upstreams_softmax():
    rs = np.random.RandomState(12)
    loc, conf, _, _, prior, var = ssd_inputs(rs, B=2, P=40, C=4)
    conf = 3 * conf
    probs = torch.softmax(torch.from_numpy(conf), -1).numpy()
    kw = dict(nms_threshold=0.45, nms_top_k=20, keep_top_k=15,
              score_threshold=0.05, return_index=True)
    got = port(tdt.detection_output, loc, conf, prior, var, **kw)
    want = ref(jdt.detection_output, loc, probs, prior, var, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    close(got[0], want[0], 1e-6, 'rows')
    assert int(got[2].min()) > 0


def test_matrix_and_locality_aware_nms_match_reference():
    rs = np.random.RandomState(16)
    B, M, C = 2, 20, 3
    bb = np.stack([boxes(rs, M, min_size=0.2) for _ in range(B)])
    sc = rs.rand(B, C, M).astype(np.float32)
    for kw in (dict(score_threshold=0.1, post_threshold=0.05, nms_top_k=12,
                    keep_top_k=20),
               dict(score_threshold=0.2, nms_top_k=30, keep_top_k=10,
                    use_gaussian=True, gaussian_sigma=1.5,
                    background_label=-1)):
        got = port(tdt.matrix_nms, bb, sc, **kw)
        want = ref(jdt.matrix_nms, bb, sc, **kw)
        close(got[0], want[0], 1e-6, 'matrix_nms rows')
        np.testing.assert_array_equal(got[1], want[1])
    kw = dict(score_threshold=0.3, nms_top_k=15, keep_top_k=12,
              nms_threshold=0.4)
    got = port(tdt.locality_aware_nms, bb, sc, **kw)
    want = ref(jdt.locality_aware_nms, bb, sc, **kw)
    close(got[0], want[0], 1e-6, 'locality_aware_nms rows')
    np.testing.assert_array_equal(got[1], want[1])
    v = rs.randn(2, 8, 3, 4).astype(np.float32)
    close(port(tdt.polygon_box_transform, v),
          ref(jdt.polygon_box_transform, v), TOL, 'polygon_box_transform')


def test_retinanet_detection_output_matches_reference():
    rs = np.random.RandomState(17)
    ans = [boxes(rs, 12, 64.0, 0.1), boxes(rs, 6, 64.0, 0.2)]
    bbs = [(0.3 * rs.randn(2, len(a), 4)).astype(np.float32) for a in ans]
    scs = [rs.rand(2, len(a), 3).astype(np.float32) for a in ans]
    info = np.array([[64, 64, 1], [64, 64, 1]], np.float32)
    kw = dict(score_threshold=0.2, nms_top_k=10, keep_top_k=8,
              nms_threshold=0.4)

    def jfn(b1, b2, s1, s2, a1, a2, im):
        return jdt.retinanet_detection_output([b1, b2], [s1, s2], [a1, a2],
                                              im, **kw)

    def tfn(b1, b2, s1, s2, a1, a2, im):
        return tdt.retinanet_detection_output([b1, b2], [s1, s2], [a1, a2],
                                              im, **kw)
    arrays = [*bbs, *scs, *ans, info]
    got, want = port(tfn, *arrays), ref(jfn, *arrays)
    close(got[0], want[0], 1e-6, 'rows')
    np.testing.assert_array_equal(got[1], want[1])


def test_rpn_and_retinanet_target_assign_match_reference():
    rs = np.random.RandomState(14)
    feat = np.zeros((1, 1, 5, 6), np.float32)
    anchors, var = tops.anchor_generator(feat, anchor_sizes=[16., 32.],
                                         aspect_ratios=[0.5, 1., 2.],
                                         stride=[8., 8.], device='cpu')
    an = anchors.numpy().reshape(-1, 4)
    va = var.numpy().reshape(-1, 4)
    A = an.shape[0]
    gt = boxes(rs, 4, 48.0, min_size=0.2)
    gt[-1] = 0.0                                        # padding
    bp = rs.randn(A, 4).astype(np.float32)
    cl = rs.randn(A, 1).astype(np.float32)
    kw = dict(rpn_batch_size_per_im=32, rpn_positive_overlap=0.5,
              rpn_negative_overlap=0.3)
    got = port(tdt.rpn_target_assign, bp, cl, an, va, gt, **kw)
    want = ref(jdt.rpn_target_assign, bp, cl, an, va, gt, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, TOL, f'rpn output {i}')
    assert got[2].sum() > 0 and got[4].sum() > 0
    glab = np.array([[2], [5], [1], [0]], np.int32)
    got = port(tdt.retinanet_target_assign, bp, cl, an, va, gt, glab,
               num_classes=6)
    want = ref(jdt.retinanet_target_assign, bp, cl, an, va, gt, glab,
               num_classes=6)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, TOL, f'retinanet output {i}')


def test_sigmoid_focal_loss_and_gradient_match_reference():
    rs = np.random.RandomState(13)
    x = rs.randn(12, 4).astype(np.float32)
    lab = rs.randint(0, 5, (12, 1)).astype(np.int32)
    fg = np.array([3], np.int32)
    cot = rs.randn(12, 4).astype(np.float32)
    rout, (rg,) = ref_vjp(jdt.sigmoid_focal_loss, [x, lab, fg], cot, (0,),
                          gamma=1.5, alpha=0.3)
    pout, (pg,) = port_vjp(tdt.sigmoid_focal_loss, [x, lab, fg], cot, (0,),
                           gamma=1.5, alpha=0.3)
    close(pout, rout, TOL, 'focal loss')
    close(pg, rg, GRAD_TOL, 'focal gradient')
