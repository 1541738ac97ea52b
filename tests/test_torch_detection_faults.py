"""The reference's departures from upstream Paddle in the detection ops
(ROADMAP.md, Queue 3), each a ``test_reference_fault_*`` that shows what
the reference does and what the port does instead: upstream's rule, as
the reference's own docstrings cite it.

- (a) ``detection_output`` hands raw scores to the NMS; upstream
  (``fluid.layers.detection_output``) takes their softmax first.
- (b) ``generate_proposals`` runs its NMS over only the first
  ``post_nms_top_n`` of the ``pre_nms_top_n`` candidates and zeroes the
  removed ones in place; upstream runs it over all ``pre`` and keeps the
  first ``post`` survivors.
- (c) ``roi_align`` takes 2 samples a bin for ``sampling_ratio <= 0`` and
  clamps samples outside the map to its border; upstream
  (``roi_align_op``) takes ``ceil(roi / bins)`` and reads 0 outside
  (-1, H) x (-1, W).
- (d) ``multiclass_nms`` accepts ``nms_eta`` and never uses it; upstream's
  ``NMSFast`` shrinks the threshold by ``eta`` after each keep while it is
  above 0.5.
"""
import math

import numpy as np
import torch

import paddle_tpu.vision.detection_train as jdt
import paddle_tpu.vision.ops as jops
from _torch_detection import close, port, ref, ssd_inputs

from paddle_tpu_torch.vision import detection_train as tdt
from paddle_tpu_torch.vision import ops as tops


def _iou(a, b, off=0.0):
    iw = max(min(a[2], b[2]) - max(a[0], b[0]) + off, 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]) + off, 0.0)
    inter = iw * ih
    union = ((a[2] - a[0] + off) * (a[3] - a[1] + off)
             + (b[2] - b[0] + off) * (b[3] - b[1] + off) - inter)
    return inter / union if union > 0 else 0.0


def _nms_fast(bx, sc, thr, eta=1.0, off=0.0):
    """Upstream's ``NMSFast`` over candidates in the order given: a
    candidate is kept when it overlaps every kept one by at most the
    threshold, which shrinks by ``eta`` after a keep while above 0.5."""
    keep = []
    for i in range(len(bx)):
        if not np.isfinite(sc[i]):
            continue
        if all(_iou(bx[i], bx[j], off) <= thr for j in keep):
            keep.append(i)
            if eta < 1 and thr > 0.5:
                thr *= eta
    return keep


def test_reference_fault_detection_output_skips_the_softmax():
    rs = np.random.RandomState(30)
    loc, conf, _, _, prior, var = ssd_inputs(rs, B=2, P=30, C=4)
    kw = dict(nms_threshold=0.45, nms_top_k=20, keep_top_k=15,
              score_threshold=0.2, return_index=True)
    raw = ref(jdt.detection_output, loc, conf, prior, var, **kw)
    probs = torch.softmax(torch.from_numpy(conf), -1).numpy()
    soft = ref(jdt.detection_output, loc, probs, prior, var, **kw)
    got = port(tdt.detection_output, loc, conf, prior, var, **kw)
    # the reference ranks and thresholds logits: other boxes kept
    assert not np.array_equal(raw[1], soft[1])
    assert raw[0][..., 1].max() > 1.0                # scores past 1
    np.testing.assert_array_equal(got[1], soft[1])
    np.testing.assert_array_equal(got[2], soft[2])
    assert got[0][..., 1].max() <= 1.0


def test_reference_fault_generate_proposals_nms_over_post_candidates():
    rs = np.random.RandomState(31)
    feat = np.zeros((1, 1, 4, 5), np.float32)
    an, va = (t.numpy() for t in tops.anchor_generator(
        feat, anchor_sizes=[16., 32.], aspect_ratios=[1., 2.],
        stride=[8., 8.], device='cpu'))
    A = an.shape[2]
    sc = rs.randn(1, A, 4, 5).astype(np.float32)
    deltas = (0.3 * rs.randn(1, 4 * A, 4, 5)).astype(np.float32)
    info = np.array([[32, 40, 1.0]], np.float32)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5,
              min_size=2.0)
    rrois, rprobs, rnum = ref(jdt.generate_proposals, sc, deltas, info, an,
                              va, **kw)
    rois, probs, num = port(tdt.generate_proposals, sc, deltas, info, an,
                            va, **kw)
    # the reference: removed candidates zeroed in place among the first 20
    zero_rows = np.nonzero(rprobs[0, :int(rnum[0]) + 1, 0] == 0)[0]
    assert int(rnum[0]) < 20 and len(zero_rows) > 0
    assert (rprobs[0, int(rnum[0]):, 0] != 0).any()   # rows past the count
    # the port: NMS over all 60, the first 20 survivors packed in front
    every = ref(jdt.generate_proposals, sc, deltas, info, an, va,
                **dict(kw, post_nms_top_n=60))
    kept = np.nonzero(every[1][0, :, 0] != 0)[0][:20]
    n = int(num[0])
    assert n == len(kept) > int(rnum[0])
    close(rois[0, :n], every[0][0, kept], 1e-5, 'the first survivors')
    close(probs[0, :n, 0], every[1][0, kept, 0], 1e-5, 'their scores')
    assert not probs[0, n:].any()
    boxes_in_order = every[0][0]
    assert _nms_fast(boxes_in_order[every[1][0, :, 0] != 0],
                     every[1][0, every[1][0, :, 0] != 0, 0], 0.5, off=1.0) \
        == list(range(int(every[2][0])))


def test_reference_fault_roi_align_samples_two_and_clamps_outside():
    x = np.ones((1, 2, 6, 6), np.float32)
    x[0, :, 2:4, 2:4] = 3.0
    # 4.9 x 4.9 pixels over 2 x 2 bins: upstream takes ceil(2.45) = 3
    inside = np.array([[0.35, 0.14, 5.25, 5.04]], np.float32)
    kw = dict(pooled_height=2, pooled_width=2, spatial_scale=1.0)
    r_default = ref(jops.roi_align, x, inside, sampling_ratio=-1, **kw)
    np.testing.assert_array_equal(
        r_default, ref(jops.roi_align, x, inside, sampling_ratio=2, **kw))
    got = port(tops.roi_align, x, inside, sampling_ratio=-1, **kw)
    np.testing.assert_array_equal(
        got, port(tops.roi_align, x, inside, sampling_ratio=3, **kw))
    assert np.abs(got - r_default).max() > 1e-3
    # a roi whose first bins lie past the map's edge (below -1)
    outside = np.array([[-8.0, -8.0, 4.0, 4.0]], np.float32)
    kw = dict(pooled_height=2, pooled_width=2, sampling_ratio=2)
    r_out = ref(jops.roi_align, x, outside, **kw)
    p_out = port(tops.roi_align, x, outside, **kw)
    assert r_out[0, 0, 0, 0] == 1.0                  # the clamped border
    assert p_out[0, 0, 0, 0] == 0.0                  # upstream's zeros
    np.testing.assert_allclose(p_out[0, :, 1, 1], r_out[0, :, 1, 1])


def test_reference_fault_multiclass_nms_ignores_nms_eta():
    rs = np.random.RandomState(33)
    M = 40
    c = rs.rand(3, 2) * 0.5 + 0.25
    ctr = c[rs.randint(0, 3, M)] + 0.05 * rs.randn(M, 2)
    bx = np.concatenate([ctr - 0.12, ctr + 0.12], 1).astype(np.float32)
    sc = rs.rand(1, 2, M).astype(np.float32)
    kw = dict(score_threshold=0.05, nms_top_k=M, keep_top_k=2 * M,
              nms_threshold=0.7, background_label=-1, return_index=True)
    plain = ref(jops.multiclass_nms, bx[None], sc, **kw)
    eta = ref(jops.multiclass_nms, bx[None], sc, nms_eta=0.8, **kw)
    for a, b in zip(plain, eta):
        np.testing.assert_array_equal(a, b)
    got = port(tops.multiclass_nms, bx[None], sc, nms_eta=0.8, **kw)
    got1 = port(tops.multiclass_nms, bx[None], sc, **kw)
    np.testing.assert_array_equal(got1[1], plain[1])
    assert got[2][0] < got1[2][0]                    # fewer kept
    want = []
    for cls in range(2):
        s = sc[0, cls]
        order = [int(i) for i in np.argsort(-s, kind='stable')
                 if s[i] > 0.05]
        kept = _nms_fast(bx[order], s[order], 0.7, eta=0.8)
        want += [(float(s[order[k]]), order[k]) for k in kept]
    want.sort(key=lambda t: -t[0])
    n = int(got[2][0])
    assert n == len(want)
    np.testing.assert_array_equal(got[1][0, :n], [i for _, i in want])
    assert math.isclose(float(got[0][0, 0, 1]), want[0][0])
