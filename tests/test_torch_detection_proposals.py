"""The port's proposal ops against the JAX package's, on the CPU:
``generate_proposals``, FPN routing, ``box_decoder_and_assign`` and the
host samplers (each reference call under one ``jax.jit`` where it has no
host step, ``tests/_torch_detection.py``).

- ``generate_proposals`` with ``pre_nms_top_n == post_nms_top_n`` (so the
  reference's NMS sees upstream's candidates): the reference's kept rows,
  compacted in score order, within 1e-5 (the port keeps upstream's
  layout; the difference is in ``test_torch_detection_faults.py``).
- ``distribute_fpn_proposals`` / ``collect_fpn_proposals``,
  ``box_decoder_and_assign``: equal indices, values within 1e-5.
- ``generate_proposal_labels`` at ``use_random=False`` and
  ``generate_mask_labels``: equal; a ``use_random`` call draws from its
  ``rng``.
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.vision.detection_train as jdt
from _torch_detection import boxes, close, port, ref
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch.vision import detection_train as tdt
from paddle_tpu_torch.vision import ops as tops

TOL = 1e-5


def JT_(a):
    return Tensor(jnp.asarray(a))


def test_generate_proposals_keeps_upstreams_survivors():
    rs = np.random.RandomState(20)
    feat = np.zeros((1, 1, 4, 5), np.float32)
    anchors, var = tops.anchor_generator(feat, anchor_sizes=[16., 32.],
                                         aspect_ratios=[1., 2.],
                                         stride=[8., 8.], device='cpu')
    an, va = anchors.numpy(), var.numpy()
    A = an.shape[2]
    sc = rs.randn(2, A, 4, 5).astype(np.float32)
    deltas = (0.3 * rs.randn(2, 4 * A, 4, 5)).astype(np.float32)
    info = np.array([[32, 40, 1.0], [30, 36, 1.0]], np.float32)
    kw = dict(pre_nms_top_n=50, post_nms_top_n=50, nms_thresh=0.5,
              min_size=2.0)
    rois, probs, num = port(tdt.generate_proposals, sc, deltas, info, an,
                            va, **kw)
    rrois, rprobs, rnum = ref(jdt.generate_proposals, sc, deltas, info, an,
                              va, **kw)
    np.testing.assert_array_equal(num, rnum)
    assert 0 < num.min() and num.max() < 50            # NMS removed some
    for b in range(2):
        kept = np.nonzero(rprobs[b, :, 0] != 0)[0]     # in score order
        n = len(kept)
        assert n == num[b]
        close(rois[b, :n], rrois[b, kept], TOL, 'rois')
        close(probs[b, :n], rprobs[b, kept], TOL, 'probs')
        assert not rois[b, n:].any() and not probs[b, n:].any()
    two = tdt.generate_proposals(*(torch.from_numpy(a) for a in
                                   (sc, deltas, info, an, va)),
                                 return_rois_num=False, **kw)
    assert len(two) == 2


def test_fpn_routing_and_box_decoder_and_assign_match_reference():
    rs = np.random.RandomState(21)
    rois = boxes(rs, 30, 400.0, 0.02)
    got = port(tdt.distribute_fpn_proposals, rois, min_level=2, max_level=5,
               refer_level=4, refer_scale=224, rois_num=True)
    want = jdt.distribute_fpn_proposals(JT_(rois), 2, 5, 4, 224,
                                        rois_num=True)
    for g, w in zip(got[0], want[0]):
        close(g, np.asarray(w._value), TOL, 'level rois')
    np.testing.assert_array_equal(got[1], np.asarray(want[1]._value))
    assert [int(c) for c in got[2]] == [int(c._value) for c in want[2]]
    assert len(port(tdt.distribute_fpn_proposals, rois, 2, 5, 4, 224)) == 2
    multi = [boxes(rs, n, 100.0) for n in (6, 4, 5)]
    scores = [rs.rand(len(m), 1).astype(np.float32) for m in multi]

    def jfn(*a):
        return jdt.collect_fpn_proposals(list(a[:3]), list(a[3:]), 2, 4, 9)

    def tfn(*a):
        return tdt.collect_fpn_proposals(list(a[:3]), list(a[3:]), 2, 4, 9)
    for g, w in zip(port(tfn, *multi, *scores), ref(jfn, *multi, *scores)):
        close(g, w, TOL, 'collect')
    prior = boxes(rs, 7, 50.0)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (7, 1))
    deltas = rs.randn(7, 4 * 3).astype(np.float32)
    score = rs.rand(7, 3).astype(np.float32)
    for g, w in zip(port(tdt.box_decoder_and_assign, prior, pvar, deltas,
                         score, box_clip=4.135),
                    ref(jdt.box_decoder_and_assign, prior, pvar, deltas,
                        score, box_clip=4.135)):
        close(g, w, TOL, 'box_decoder_and_assign')


def test_host_samplers_match_reference():
    rs = np.random.RandomState(22)
    gt = boxes(rs, 3, 60.0, 0.2)
    rois = np.concatenate([gt + rs.randn(3, 4).astype(np.float32),
                           boxes(rs, 12, 60.0, 0.1)])
    gtc = np.array([[3], [1], [0]], np.int32)
    gt_pad = np.concatenate([gt, np.zeros((1, 4), np.float32)])
    gtc_pad = np.concatenate([gtc, [[0]]]).astype(np.int32)
    info = np.array([60, 60, 1.0], np.float32)
    kw = dict(batch_size_per_im=8, fg_fraction=0.5, class_nums=4,
              use_random=False)
    got = tdt.generate_proposal_labels(
        torch.from_numpy(rois), gtc_pad, None, gt_pad, info, **kw)
    want = jdt.generate_proposal_labels(JT_(rois), JT_(gtc_pad), None,
                                        JT_(gt_pad), JT_(info), **kw)
    for g, w in zip(got, want):
        assert g.device.type == 'cpu'
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    drawn = [tdt.generate_proposal_labels(
        torch.from_numpy(rois), gtc_pad, None, gt_pad, info,
        **dict(kw, use_random=True), rng=np.random.RandomState(s))[0]
        for s in (1, 1, 2)]
    assert torch.equal(drawn[0], drawn[1])
    sampled, labels = got[0], got[1].numpy()
    segs = np.full((3, 5, 2), np.nan, np.float32)
    segs[:, :4] = [[10, 10], [40, 12], [35, 45], [12, 40]]
    segs[2, :3] = [[0, 0], [60, 0], [30, 60]]
    got = tdt.generate_mask_labels(info, gtc, None, segs, sampled, labels,
                                   num_classes=4, resolution=6)
    want = jdt.generate_mask_labels(JT_(info), JT_(gtc), None, JT_(segs),
                                    JT_(sampled.numpy()), JT_(labels),
                                    num_classes=4, resolution=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert got[2].numpy().any()
