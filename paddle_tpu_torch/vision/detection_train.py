"""The detection training ops (SSD, YOLOv3, Faster R-CNN, RetinaNet).
Counterpart of ``paddle_tpu/vision/detection_train.py`` (upstream
``fluid/layers/detection.py`` and ``operators/detection/``).

The reference's dense contract throughout: ground-truth batches are
padded (B, G, ...) tensors (a row is valid when its label is >= 0, or its
box has a positive area, as ``yolov3_loss_op.h``'s GtValid), and
dynamic-size outputs (sampled RoIs, FPN splits) are fixed-size padded
tensors with counts or weights. The ops are plain PyTorch on the device
of their tensor inputs, batched over images where the reference
``vmap``s: the greedy matcher retires one ground-truth row a step for
every image at once, the NMS one candidate a step (``ops._nms``), with no
host sync in either loop. Sorts are stable (equal keys keep their index
order, as ``jnp.argsort``) and ``argmax`` returns the first maximum.

The host samplers ``generate_proposal_labels`` / ``generate_mask_labels``
run in numpy as in the reference (upstream pins them to the CPU), drawing
from an explicit ``rng=``; ``multi_box_head`` and ``deformable_conv``
create their parameters at each call from an explicit ``generator=``.
``detection_output`` applies the softmax to its scores and
``generate_proposals`` runs NMS over all ``pre_nms_top_n`` candidates and
keeps the first ``post_nms_top_n`` survivors, as upstream does, where the
reference departs (ROADMAP.md, Queue 3).
"""
import math

import numpy as np
import torch

from ..device import resolve_device
from ..nn.initializer import create_parameter
from .ops import (_nms, _pairwise_iou, _roi_batch_index, _t, box_coder,
                  multiclass_nms)
from .ops import prior_box as _prior_box

__all__ = [
    'bipartite_match', 'target_assign', 'ssd_loss', 'detection_output',
    'rpn_target_assign', 'retinanet_target_assign', 'sigmoid_focal_loss',
    'yolov3_loss', 'matrix_nms', 'locality_aware_nms', 'polygon_box_transform',
    'generate_proposals', 'generate_proposal_labels', 'generate_mask_labels',
    'retinanet_detection_output', 'distribute_fpn_proposals',
    'collect_fpn_proposals', 'box_decoder_and_assign', 'multi_box_head',
    'roi_perspective_transform', 'roi_pool', 'psroi_pool', 'prroi_pool',
    'deformable_conv', 'deformable_roi_pooling',
]


def _full(like, value, dtype=None):
    return torch.full((), value, dtype=dtype or like.dtype,
                      device=like.device)


def _rank(order):
    """The inverse permutation of ``order`` along its last axis (the
    reference's ``.at[order].set(arange)``)."""
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def _center_size(b, eps=1e-9):
    """xyxy -> (cx, cy, w, h) with the widths floored at ``eps``."""
    w = (b[..., 2] - b[..., 0]).clamp(min=eps)
    h = (b[..., 3] - b[..., 1]).clamp(min=eps)
    return (b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5, w, h


def _encode(anchor, gt):
    """Unweighted center-size targets of ``gt`` against ``anchor``."""
    ax, ay, aw, ah = _center_size(anchor)
    gx, gy, gw, gh = _center_size(gt)
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


# ---------------------------------------------------------------------------
# matching / target assignment
# ---------------------------------------------------------------------------

def _bipartite_match_single(dist, valid_rows):
    """Greedy bipartite match (bipartite_match_op.cc BipartiteMatch): pick
    the global max repeatedly, retiring its row and column. dist: (B, G,
    P); valid_rows: (B, G) bool. Returns (match (B, P) int32,
    matched_dist (B, P)); one ground-truth row a step for every image."""
    B, G, P = dist.shape
    neg = -1e30
    d = torch.where(valid_rows[..., None], dist, _full(dist, neg))
    match = torch.full((B, P), -1, dtype=torch.int32, device=dist.device)
    mdist = torch.zeros((B, P), dtype=dist.dtype, device=dist.device)
    rows = torch.arange(G, device=dist.device)
    cols = torch.arange(P, device=dist.device)
    for _ in range(G):
        flat = d.reshape(B, -1).argmax(-1)          # the first maximum
        best = d.reshape(B, -1).gather(1, flat[:, None])[:, 0]
        g, p = flat // P, flat % P
        ok = best > neg / 2
        hit = ok[:, None] & (cols[None, :] == p[:, None])          # (B, P)
        match = torch.where(hit, g[:, None].to(torch.int32), match)
        picked = dist.gather(1, g[:, None, None].expand(B, 1, P))[:, 0]
        mdist = torch.where(hit, picked, mdist)
        retire = ok[:, None, None] & ((rows[None, :, None] == g[:, None, None])
                                      | (cols[None, None, :]
                                         == p[:, None, None]))
        d = torch.where(retire, _full(d, neg), d)
    return match, mdist


def _per_prediction(dist, valid, match, mdist, thr):
    """Match every unmatched column to its best valid row when that
    distance is >= ``thr``."""
    masked = torch.where(valid[..., None], dist, _full(dist, -math.inf))
    best_val, _ = masked.max(1)
    best_row = masked.argmax(1)
    extra = (match < 0) & (best_val >= thr)
    return (torch.where(extra, best_row.to(torch.int32), match),
            torch.where(extra, best_val, mdist))


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (detection.py:1317). dist_matrix:
    (B, G, P) or (G, P) similarity; returns (match_indices (B, P) int32
    with -1 for unmatched, matched_distance (B, P)). match_type
    'per_prediction' additionally matches any unmatched column to its
    argmax row when that distance >= dist_threshold (default 0.5)."""
    d = _t(dist_matrix).detach()
    if d.dim() == 2:
        d = d[None]
    thr = 0.5 if dist_threshold is None else float(dist_threshold)
    valid = (d > 0).any(2)
    match, mdist = _bipartite_match_single(d, valid)
    if match_type == 'per_prediction':
        match, mdist = _per_prediction(d, valid, match, mdist, thr)
    return match, mdist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Gather targets by match indices (detection.py:1402). input:
    (B, G, K) per-image candidate rows; matched_indices: (B, P) row index
    or -1. out[b, p] = input[b, match[b, p]] (mismatch_value rows where
    unmatched), weight 1.0 where matched else 0.0. negative_indices
    (B, P) bool/0-1 mask (dense replacement of upstream's LoD neg-index
    list) forces weight 1 with mismatch_value content."""
    x = _t(input).detach()
    midx = _t(matched_indices, x).long()
    mm = 0.0 if mismatch_value is None else float(mismatch_value)
    matched = midx >= 0
    safe = midx.clamp(min=0)
    out = x.gather(1, safe[..., None].expand(*safe.shape, x.shape[-1]))
    out = torch.where(matched[..., None], out, _full(x, mm))
    w = matched.to(x.dtype)[..., None]
    if negative_indices is not None:
        neg = _t(negative_indices, x) != 0
        w = torch.maximum(w, neg.to(x.dtype)[..., None])
    return out, w


# ---------------------------------------------------------------------------
# SSD loss
# ---------------------------------------------------------------------------

def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type='per_prediction',
             mining_type='max_negative', normalize=True, sample_size=None):
    """Full SSD multibox loss (detection.py:1517): IoU -> bipartite match ->
    hard-negative mining (mine_hard_examples_op.cc max_negative) -> smooth-L1
    loc + softmax conf, normalized by the number of matched priors.

    Dense contract: gt_box (B, G, 4) normalized xyxy padded with zero-area
    rows; gt_label (B, G) or (B, G, 1) padded with -1. location
    (B, P, 4), confidence (B, P, C), prior_box (P, 4). Returns (B, 1),
    differentiable in ``location`` and ``confidence``."""
    if mining_type != 'max_negative':
        raise ValueError("Only mining_type='max_negative' is supported "
                         "(same restriction as upstream)")
    loc = _t(location)
    conf = _t(confidence, loc)
    gt = _t(gt_box, loc).to(loc.dtype)
    pb = _t(prior_box, loc).to(loc.dtype)
    var = None if prior_box_var is None else \
        _t(prior_box_var, loc).to(loc.dtype)
    thr = overlap_threshold if overlap_threshold is not None else 0.5
    B, P, C = conf.shape
    lab = _t(gt_label, loc).reshape(B, -1).long()
    area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    valid = (lab >= 0) & (area > 0)

    with torch.no_grad():
        iou = torch.where(valid[..., None], _pairwise_iou(gt, pb[None]),
                          _full(gt, 0.0))                       # (B, G, P)
        match, mdist = _bipartite_match_single(iou, valid)
        if match_type == 'per_prediction':
            match, mdist = _per_prediction(iou, valid, match, mdist, thr)
    pos = match >= 0
    n_pos = pos.sum(1)

    # conf loss vs target labels (background where unmatched)
    safe = match.clamp(min=0).long()
    t_label = torch.where(pos, lab.gather(1, safe),
                          _full(lab, background_label))
    logp = torch.log_softmax(conf, dim=-1)
    conf_l = -logp.gather(-1, t_label[..., None])[..., 0]       # (B, P)

    # hard negative mining: candidates are unmatched priors with
    # matched_dist < neg_overlap, ranked by conf loss
    with torch.no_grad():
        neg_cand = ~pos & (mdist < neg_overlap)
        n_neg = torch.minimum((n_pos * neg_pos_ratio).to(torch.int32),
                              neg_cand.sum(1, dtype=torch.int32))
        if sample_size is not None:
            n_neg = n_neg.clamp(max=int(sample_size))
        cand_loss = torch.where(neg_cand, conf_l.detach(),
                                _full(conf_l, -math.inf))
        rank = _rank(torch.argsort(-cand_loss, dim=-1, stable=True))
        neg_sel = neg_cand & (rank < n_neg[:, None])
    conf_w = pos.to(loc.dtype) + neg_sel.to(loc.dtype)

    # loc loss: smooth-L1 vs encoded gt offsets on positives
    gt_m = gt.gather(1, safe[..., None].expand(B, P, 4))          # (B, P, 4)
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    px = (pb[:, 0] + pb[:, 2]) * 0.5
    py = (pb[:, 1] + pb[:, 3]) * 0.5
    gx, gy, gw, gh = _center_size(gt_m)
    v = var if var is not None else torch.ones_like(pb)
    t0 = (gx - px) / pw.clamp(min=1e-9) / v[:, 0]
    t1 = (gy - py) / ph.clamp(min=1e-9) / v[:, 1]
    t2 = torch.log(gw / pw.clamp(min=1e-9)) / v[:, 2]
    t3 = torch.log(gh / ph.clamp(min=1e-9)) / v[:, 3]
    target = torch.stack([t0, t1, t2, t3], dim=-1)
    diff = loc - target
    ad = diff.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5).sum(-1)
    loc_w = pos.to(loc.dtype)

    total = (conf_loss_weight * conf_l * conf_w +
             loc_loss_weight * sl1 * loc_w)
    loss = total.sum(1)
    if normalize:
        loss = loss / loc_w.sum(1).clamp(min=1.0)
    return loss[:, None]


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """Decode + softmax + multiclass NMS (detection.py:620). loc: (B, P, 4)
    deltas; scores: (B, P, C) logits; returns the padded (B, keep_top_k,
    6) NMS output and the counts (``multiclass_nms``'s contract). Upstream
    normalises ``scores`` with a softmax over the classes before the NMS;
    the reference hands them raw (ROADMAP.md, Queue 3)."""
    loc = _t(loc)
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type='decode_center_size', axis=0)
    sc = torch.softmax(_t(scores, loc), dim=-1).transpose(1, 2)  # (B, C, P)
    return multiclass_nms(decoded, sc, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label,
                          nms_eta=nms_eta, return_index=return_index)


# ---------------------------------------------------------------------------
# focal loss + RPN / RetinaNet target assign
# ---------------------------------------------------------------------------

def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """Per-element focal loss (sigmoid_focal_loss_op.h): x (N, C) logits,
    label (N, 1) in [0, C] (0 = background; class c hits column c-1),
    normalized by fg_num. Returns (N, C)."""
    xv = _t(x)
    N, C = xv.shape
    lab = _t(label, xv).reshape(-1).long()
    c_idx = torch.arange(1, C + 1, device=xv.device)[None, :]
    t = (lab[:, None] == c_idx).to(xv.dtype)
    p = torch.sigmoid(xv)
    ce = xv.clamp(min=0.0) - xv * t + torch.log1p(torch.exp(-xv.abs()))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    a_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = a_t * ((1.0 - p_t) ** gamma) * ce
    fg = _t(fg_num, xv).to(xv.dtype).reshape(())
    return loss / fg.clamp(min=1.0)


def _label_anchors(anchors, gt, valid_gt, pos_thr, neg_thr):
    """Shared anchor labeling: 1 fg / 0 bg / -1 ignore, plus matched gt
    index. Every valid gt's best anchor is forced fg (the rpn_target_assign
    rule; anchors shared by several gts are fg if any of them is valid)."""
    iou = torch.where(valid_gt[:, None], _pairwise_iou(gt, anchors),
                      _full(anchors, 0.0))
    best_iou, _ = iou.max(0)
    best_gt = iou.argmax(0)                            # per anchor
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(best_iou < neg_thr, 0, labels)
    labels = torch.where(best_iou >= pos_thr, 1, labels)
    gt_best_anchor = iou.argmax(1)                     # (G,)
    force = torch.zeros(anchors.shape[0], dtype=torch.int32,
                        device=anchors.device).scatter_reduce(
        0, gt_best_anchor, valid_gt.to(torch.int32), 'amax')
    labels = torch.where(force > 0, 1, labels)
    return labels, best_gt.to(torch.int32), best_iou


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """RPN anchor target assignment (detection.py:310). Dense contract:
    one image — bbox_pred (A, 4), cls_logits (A, 1), anchor_box (A, 4),
    gt_boxes (G, 4) zero-area-padded. Returns fixed-size
    (score_pred (S, 1), loc_pred (S, 4), score_target (S, 1),
    loc_target (S, 4), bbox_inside_weight (S, 4)) with
    S = rpn_batch_size_per_im; rows beyond the sampled count have zero
    weight. Sampling is the reference's deterministic top-ranked choice
    (fg by IoU descending, bg ascending; ``use_random`` is accepted and
    does not draw)."""
    bpv = _t(bbox_pred)
    clv = _t(cls_logits, bpv)
    anv = _t(anchor_box, bpv).to(bpv.dtype)
    gbv = _t(gt_boxes, bpv).to(bpv.dtype)
    S = int(rpn_batch_size_per_im)
    A = anv.shape[0]
    area = (gbv[:, 2] - gbv[:, 0]) * (gbv[:, 3] - gbv[:, 1])
    valid = area > 0
    labels, matched, best_iou = _label_anchors(
        anv, gbv, valid, rpn_positive_overlap, rpn_negative_overlap)
    n_fg_cap = int(rpn_fg_fraction * S)
    fg = labels == 1
    bg = labels == 0
    fg_order = torch.argsort(-torch.where(fg, best_iou,
                                          _full(best_iou, -math.inf)),
                             stable=True)
    n_fg = torch.clamp(fg.sum(dtype=torch.int32), max=n_fg_cap)
    bg_order = torch.argsort(torch.where(bg, best_iou,
                                         _full(best_iou, math.inf)),
                             stable=True)
    n_bg = torch.minimum(bg.sum(dtype=torch.int32), S - n_fg)
    slots = torch.arange(S, device=bpv.device)
    take_fg = slots < n_fg
    idx = torch.where(take_fg, fg_order[slots.clamp(max=A - 1)],
                      bg_order[(slots - n_fg).clamp(0, A - 1)])
    used = slots < (n_fg + n_bg)
    score_tgt = take_fg.to(torch.int32)[:, None]
    g = gbv[matched[idx].long().clamp(0, gbv.shape[0] - 1)]
    loc_tgt = _encode(anv[idx], g)
    w = (take_fg & used).to(bpv.dtype)[:, None]
    return (clv[idx], bpv[idx], score_tgt, loc_tgt * w,
            w.expand(S, 4).contiguous())


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None, im_info=None,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet target assignment (detection.py:110): every anchor is
    used (no subsample); returns (score_pred, loc_pred, score_target,
    loc_target, bbox_inside_weight, fg_num). score_target is the CLASS id
    (0 bg, 1..K fg); all A rows are kept (dense) with the inside weights
    zeroed for non-fg."""
    bpv = _t(bbox_pred)
    clv = _t(cls_logits, bpv)
    anv = _t(anchor_box, bpv).to(bpv.dtype)
    gbv = _t(gt_boxes, bpv).to(bpv.dtype)
    glv = _t(gt_labels, bpv).reshape(-1)
    A = anv.shape[0]
    area = (gbv[:, 2] - gbv[:, 0]) * (gbv[:, 3] - gbv[:, 1])
    valid = area > 0
    labels, matched, _ = _label_anchors(anv, gbv, valid, positive_overlap,
                                        negative_overlap)
    fg = labels == 1
    m = matched.long()
    cls_t = torch.where(fg, glv[m.clamp(0, glv.numel() - 1)].to(torch.int32),
                        0)
    loc_t = _encode(anv, gbv[m.clamp(0, gbv.shape[0] - 1)])
    w = fg.to(bpv.dtype)[:, None]
    fg_num = fg.sum(dtype=torch.int32).reshape(1, 1)
    return (clv, bpv, cls_t[:, None], loc_t * w, w.expand(A, 4).contiguous(),
            fg_num)


# ---------------------------------------------------------------------------
# YOLOv3 loss (vectorized port of yolov3_loss_op.h)
# ---------------------------------------------------------------------------

def _sce(z, t):
    return z.clamp(min=0.0) - z * t + torch.log1p(torch.exp(-z.abs()))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (yolov3_loss_op.h, its algorithm):
    x (B, M*(5+K), H, W); gt_box (B, G, 4) cxcywh normalized, zero-area
    padded; gt_label (B, G) int. Returns the per-image loss (B,),
    differentiable in ``x``. Two responsible ground truths in one cell:
    the later one's score marks the objectness, as upstream's loop."""
    xv = _t(x)
    gbv = _t(gt_box, xv).to(xv.dtype)
    anchors = [int(a) for a in anchors]
    anchor_mask = [int(a) for a in anchor_mask]
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    K = int(class_num)
    B, _, H, W = xv.shape
    input_size = downsample_ratio * H
    scale = scale_x_y
    bias = -0.5 * (scale - 1.0)
    G = gbv.shape[1]
    dev, dt = xv.device, xv.dtype
    score = torch.ones((B, G), dtype=dt, device=dev) if gt_score is None \
        else _t(gt_score, xv).to(dt)
    x5 = xv.reshape(B, mask_num, 5 + K, H, W)
    glv = _t(gt_label, xv).reshape(B, G).long()

    anc = torch.tensor(anchors, dtype=dt, device=dev).reshape(an_num, 2)
    mask_anc = anc[anchor_mask]                           # (M, 2)
    if use_label_smooth:
        sw = min(1.0 / K, 1.0 / 40)
        pos_l, neg_l = 1.0 - sw, sw
    else:
        pos_l, neg_l = 1.0, 0.0

    valid = (gbv[..., 2] > 1e-6) & (gbv[..., 3] > 1e-6)    # (B, G)
    with torch.no_grad():
        # decode every predicted box (B, M, H, W)
        gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
        gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
        xd = x5.detach()
        px = (gx + torch.sigmoid(xd[:, :, 0]) * scale + bias) / W
        py = (gy + torch.sigmoid(xd[:, :, 1]) * scale + bias) / H
        pw = torch.exp(xd[:, :, 2]) * mask_anc[:, 0][None, :, None, None] \
            / input_size
        ph = torch.exp(xd[:, :, 3]) * mask_anc[:, 1][None, :, None, None] \
            / input_size
        # IoU of every prediction with every gt (cxcywh): (B, G, M, H, W)
        e = (slice(None), None, slice(None), slice(None), slice(None))
        g = [gbv[:, :, i][:, :, None, None, None] for i in range(4)]
        iw = torch.minimum(px[e] + pw[e] / 2, g[0] + g[2] / 2) - \
            torch.maximum(px[e] - pw[e] / 2, g[0] - g[2] / 2)
        ih = torch.minimum(py[e] + ph[e] / 2, g[1] + g[3] / 2) - \
            torch.maximum(py[e] - ph[e] / 2, g[1] - g[3] / 2)
        inter = torch.where((iw < 0) | (ih < 0), _full(iw, 0.0), iw * ih)
        ious = inter / (pw[e] * ph[e] + g[2] * g[3] - inter).clamp(min=1e-10)
        ious = torch.where(valid[:, :, None, None, None], ious,
                           _full(ious, 0.0))
        best_iou, _ = ious.max(1)                           # (B, M, H, W)
        ignore = best_iou > ignore_thresh

        # per-gt best anchor over ALL anchors (shifted IoU)
        inter_w = torch.minimum(anc[None, None, :, 0] / input_size,
                                gbv[:, :, None, 2])
        inter_h = torch.minimum(anc[None, None, :, 1] / input_size,
                                gbv[:, :, None, 3])
        inter = inter_w * inter_h
        union = (anc[None, None, :, 0] * anc[None, None, :, 1]
                 / input_size ** 2
                 + (gbv[..., 2] * gbv[..., 3])[..., None] - inter)
        best_n = (inter / union.clamp(min=1e-10)).argmax(-1)  # (B, G)
        lookup = [-1] * an_num
        for mi, a in enumerate(anchor_mask):
            lookup[a] = mi
        mask_idx = torch.tensor(lookup, device=dev)[best_n]
        resp = valid & (mask_idx >= 0)
        gi = (gbv[..., 0] * W).to(torch.int32).long().clamp(0, W - 1)
        gj = (gbv[..., 1] * H).to(torch.int32).long().clamp(0, H - 1)
        mi_safe = mask_idx.clamp(0, mask_num - 1)

    # predictions at the responsible cells (B, G, 5+K)
    bi = torch.arange(B, device=dev)[:, None]
    pred = x5[bi, mi_safe, :, gj, gi]
    tx = gbv[..., 0] * W - gi
    ty = gbv[..., 1] * H - gj
    tw = torch.log((gbv[..., 2] * input_size).clamp(min=1e-9) /
                   anc[best_n.clamp(0, an_num - 1), 0])
    th = torch.log((gbv[..., 3] * input_size).clamp(min=1e-9) /
                   anc[best_n.clamp(0, an_num - 1), 1])
    lscale = (2.0 - gbv[..., 2] * gbv[..., 3]) * score
    loc = (_sce(pred[..., 0], tx) + _sce(pred[..., 1], ty) +
           (pred[..., 2] - tw).abs() + (pred[..., 3] - th).abs())
    zero = _full(loc, 0.0)
    loc_loss = torch.where(resp, loc * lscale, zero).sum(1)

    cls_t = (torch.arange(K, device=dev)[None, None, :] ==
             glv[..., None]).to(dt)
    cls_t = cls_t * pos_l + (1 - cls_t) * neg_l
    cls = _sce(pred[..., 5:], cls_t).sum(-1)
    cls_loss = torch.where(resp, cls * score, zero).sum(1)

    # objectness target: the responsible gt's score (the last one in a
    # shared cell), -1 on ignored cells, else 0
    with torch.no_grad():
        cells = mask_num * H * W
        cell = (mi_safe * H + gj) * W + gi
        cell = torch.where(resp, cell, torch.full_like(cell, cells))
        gidx = torch.arange(G, device=dev).expand(B, G)
        last = torch.full((B, cells + 1), -1, dtype=torch.long,
                          device=dev).scatter_reduce(1, cell, gidx, 'amax')
        last = last[:, :cells]
        obj_score = score.gather(1, last.clamp(min=0))
        obj = torch.where(ignore.reshape(B, cells), _full(score, -1.0),
                          _full(score, 0.0))
        obj = torch.where(last >= 0, obj_score, obj).reshape(B, mask_num,
                                                            H, W)
    po = x5[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _sce(po, 1.0) * obj,
        torch.where(obj > -0.5, _sce(po, 0.0), _full(po, 0.0)))
    obj_loss = obj_loss.reshape(B, -1).sum(1)
    return loc_loss + cls_loss + obj_loss


# ---------------------------------------------------------------------------
# matrix / locality-aware NMS, polygon transform
# ---------------------------------------------------------------------------

def _flat_top(scores, boxes, labels, keep_top_k, dtype):
    """The ``keep_top_k`` best of the flattened (B, N) ``scores`` -> the
    padded (B, kk, 6) rows and the counts."""
    kk = min(keep_top_k, scores.shape[1])
    top = torch.argsort(-scores, dim=-1, stable=True)[:, :kk]
    s = scores.gather(1, top)
    ok = torch.isfinite(s)
    minus = torch.full((), -1.0, dtype=dtype, device=s.device)
    out = torch.cat([
        torch.where(ok, labels[top].to(dtype), minus)[..., None],
        torch.where(ok, s, minus)[..., None],
        torch.where(ok[..., None],
                    boxes.gather(1, top[..., None].expand(*top.shape, 4)),
                    minus)], dim=-1)
    return out, ok.sum(-1, dtype=torch.int32)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (matrix_nms_op.cc / SOLOv2): per class, sort by score,
    decay_j = min_i f(iou_ij)/f(max-overlap_i); suppression is a score
    decay instead of a hard drop. bboxes (B, M, 4); scores (B, C, M).
    Returns padded (B, keep_top_k, 6) [label, score, x1 y1 x2 y2] with -1
    pad rows, plus valid counts (B,). As the reference, IoUs are taken on
    normalized boxes and ``normalized`` / ``return_index`` are accepted
    only."""
    bv = _t(bboxes)
    sv = _t(scores, bv)
    B, M, _ = bv.shape
    C = sv.shape[1]
    k = min(nms_top_k, M)
    ninf = _full(sv, -math.inf)
    if background_label >= 0:
        is_bg = torch.arange(C, device=sv.device) == background_label
        sv = torch.where(is_bg[None, :, None], ninf, sv)
    order = torch.argsort(-sv, dim=-1, stable=True)[..., :k]   # (B, C, k)
    s = sv.gather(-1, order)
    b = bv[:, None].expand(B, C, M, 4).gather(
        2, order[..., None].expand(B, C, k, 4))
    live = s > score_threshold
    iou = _pairwise_iou(b, b)
    upper = torch.ones((k, k), dtype=torch.bool, device=bv.device).triu_(1)
    zero = _full(iou, 0.0)
    iou = torch.where(upper, iou, zero)                  # iou[i, j], i < j
    # per i: its own max overlap with any higher-scored box
    iou_cmax, _ = torch.where(upper.T, iou.transpose(-1, -2), zero).max(-1)
    if use_gaussian:
        decay = torch.exp(-(iou ** 2 - iou_cmax[..., None] ** 2)
                          / gaussian_sigma)
    else:
        decay = (1.0 - iou) / (1.0 - iou_cmax[..., None]).clamp(min=1e-10)
    decay = torch.where(upper, decay, _full(decay, math.inf))
    decay_j, _ = decay.min(-2)
    decay_j = torch.where(torch.isinf(decay_j), _full(decay_j, 1.0), decay_j)
    new_s = torch.where(live, s * decay_j, ninf)
    new_s = torch.where(new_s > post_threshold, new_s, ninf)
    labels = torch.arange(C, device=bv.device).repeat_interleave(k)
    out, counts = _flat_top(new_s.reshape(B, C * k), b.reshape(B, C * k, 4),
                            labels, keep_top_k, bv.dtype)
    if return_rois_num:
        return out, counts
    return out


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """Locality-aware NMS (EAST text detection, detection.py:3438): boxes
    overlapping above the threshold are first MERGED by score-weighted
    average, then standard multiclass NMS runs. Dense form: each box is
    merged with all boxes it overlaps (one pass), then NMS."""
    bv = _t(bboxes)
    sv = _t(scores, bv)
    return multiclass_nms(_locality_merge(bv, sv, nms_threshold,
                                          score_threshold), sv,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, normalized=normalized,
                          nms_eta=nms_eta, background_label=background_label)


def _locality_merge(bv, sv, nms_threshold, score_threshold):
    """Each box replaced by the score-weighted mean of the boxes it
    overlaps by at least the threshold (boxes scoring <= 0 kept)."""
    s, _ = sv.max(1)                                      # (B, M)
    iou = _pairwise_iou(bv, bv)
    near = (iou >= nms_threshold) & (s[:, None, :] > score_threshold)
    w = torch.where(near, s[:, None, :], _full(s, 0.0))
    denom = w.sum(-1, keepdim=True).clamp(min=1e-10)
    merged = (w @ bv) / denom
    return torch.where(s[..., None] <= 0, bv, merged)


def polygon_box_transform(input, name=None):
    """Offset-to-coordinate transform (polygon_box_transform_op.cc): for
    channel c at (h, w): out = (w if c even else h) * 4 - in."""
    v = _t(input)
    B, C, H, W = v.shape
    widx = torch.arange(W, dtype=v.dtype, device=v.device)[None, None, None]
    hidx = torch.arange(H, dtype=v.dtype, device=v.device)[None, None, :,
                                                          None]
    even = (torch.arange(C, device=v.device) % 2 == 0)[None, :, None, None]
    return torch.where(even, widx * 4.0, hidx * 4.0) - v


# ---------------------------------------------------------------------------
# proposal generation (RPN) + FPN routing
# ---------------------------------------------------------------------------

def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=True, name=None):
    """RPN proposal generation (detection.py:2887): decode anchor deltas,
    clip to image, drop tiny boxes, top ``pre_nms_top_n``, NMS over all of
    them (``eta`` as upstream's adaptive threshold), keep the first
    ``post_nms_top_n`` survivors. Dense contract: scores (B, A, H, W);
    bbox_deltas (B, 4A, H, W); anchors/variances (H, W, A, 4) or (A', 4).
    Returns (rois (B, post, 4), roi_probs (B, post, 1)[, rois_num (B,)]),
    each image's survivors first in score order and zero rows past its
    count, with post = min(post_nms_top_n, pre)."""
    tb, ts = _proposal_candidates(scores, bbox_deltas, im_info, anchors,
                                  variances, pre_nms_top_n, min_size)
    rois, probs, counts = _proposal_nms(tb, ts, post_nms_top_n, nms_thresh,
                                        eta)
    if return_rois_num:
        return rois, probs, counts
    return rois, probs


def _proposal_candidates(scores, bbox_deltas, im_info, anchors, variances,
                         pre_nms_top_n, min_size):
    """``generate_proposals`` before its NMS -> the ``pre`` best decoded,
    clipped boxes (B, pre, 4) and their scores (B, pre), -inf for the
    boxes under ``min_size``, in score order."""
    sv = _t(scores)
    dv = _t(bbox_deltas, sv)
    imv = _t(im_info, sv).to(sv.dtype)
    A4 = _t(anchors, sv).to(sv.dtype).reshape(-1, 4)
    V4 = _t(variances, sv).to(sv.dtype).reshape(-1, 4)
    B = sv.shape[0]
    pre = min(pre_nms_top_n, A4.shape[0])
    s = sv.permute(0, 2, 3, 1).reshape(B, -1)           # (B, H*W*A)
    d = dv.permute(0, 2, 3, 1).reshape(B, -1, 4)
    # decode center-size with variances
    aw = A4[:, 2] - A4[:, 0] + 1.0
    ah = A4[:, 3] - A4[:, 1] + 1.0
    ax = A4[:, 0] + aw * 0.5
    ay = A4[:, 1] + ah * 0.5
    cx = V4[:, 0] * d[..., 0] * aw + ax
    cy = V4[:, 1] * d[..., 1] * ah + ay
    cap = math.log(1000.0 / 16)
    w = torch.exp((V4[:, 2] * d[..., 2]).clamp(max=cap)) * aw
    h = torch.exp((V4[:, 3] * d[..., 3]).clamp(max=cap)) * ah
    zero = _full(sv, 0.0)
    im_h, im_w = imv[:, 0, None], imv[:, 1, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - w / 2, zero), im_w - 1),
        torch.minimum(torch.maximum(cy - h / 2, zero), im_h - 1),
        torch.minimum(torch.maximum(cx + w / 2, zero), im_w - 1),
        torch.minimum(torch.maximum(cy + h / 2, zero), im_h - 1)], dim=-1)
    ms = min_size * imv[:, 2, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms) &
            (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    s = torch.where(keep, s, _full(s, -math.inf))
    top = torch.argsort(-s, dim=-1, stable=True)[:, :pre]
    return boxes.gather(1, top[..., None].expand(B, pre, 4)), s.gather(1, top)


def _proposal_nms(tb, ts, post_nms_top_n, nms_thresh, eta):
    """``generate_proposals``' NMS over all its candidates and the first
    ``post`` survivors, compacted in score order."""
    B, pre = ts.shape
    post = min(post_nms_top_n, pre)
    order, alive = _nms(tb, ts, nms_thresh, pre, -math.inf, False, eta)
    rank = torch.cumsum(alive.to(torch.long), -1) - 1
    slot = torch.where(alive & (rank < post), rank,
                       torch.full_like(rank, post))
    rb = torch.zeros((B, post + 1, 4), dtype=ts.dtype, device=ts.device)
    rs = torch.zeros((B, post + 1), dtype=ts.dtype, device=ts.device)
    rb.scatter_(1, slot[..., None].expand(B, pre, 4),
                tb.gather(1, order[..., None].expand(B, pre, 4)))
    rs.scatter_(1, slot, ts.gather(1, order))
    counts = alive.sum(-1, dtype=torch.int32).clamp(max=post)
    return rb[:, :post], rs[:, :post, None], counts


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Route RoIs to FPN levels by scale (detection.py:3857):
    level = floor(log2(sqrt(area) / refer_scale + 1e-6)) + refer_level,
    clipped to [min_level, max_level]. Dense: returns one (R, 4) tensor per
    level with non-member rows zeroed, a per-level count list, and the
    restore index (R, 1) mapping sorted-by-level order back to input."""
    rv = _t(fpn_rois)
    area = ((rv[:, 2] - rv[:, 0]) * (rv[:, 3] - rv[:, 1])).clamp(min=0.0)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / refer_scale + 1e-6)) \
        + refer_level
    lvl = lvl.clamp(min_level, max_level).to(torch.int32)
    multi_rois, counts = [], []
    for level in range(min_level, max_level + 1):
        m = lvl == level
        multi_rois.append(torch.where(m[:, None], rv, _full(rv, 0.0)))
        counts.append(m.sum(dtype=torch.int32))
    restore = _rank(torch.argsort(lvl, stable=True)).to(torch.int32)
    if rois_num is not None:
        return multi_rois, restore[:, None], counts
    return multi_rois, restore[:, None]


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """Concat per-level RoIs and keep the global top-k by score
    (detection.py:3954). Dense: returns (post_nms_top_n, 4) and the
    scores (post_nms_top_n, 1)."""
    rv = torch.cat([_t(r) for r in multi_rois], dim=0)
    sv = torch.cat([_t(s, rv).reshape(-1) for s in multi_scores], dim=0)
    k = min(post_nms_top_n, sv.shape[0])
    top = torch.argsort(-sv, stable=True)[:k]
    return rv[top], sv[top][:, None]


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    """Per-class box decode + best-class assignment (detection.py:3790).
    prior_box (P, 4); target_box (P, 4*C) per-class deltas; box_score
    (P, C). Returns (decoded (P, 4*C), assigned (P, 4))."""
    p = _t(prior_box)
    v = _t(prior_box_var, p)
    t = _t(target_box, p)
    s = _t(box_score, p)
    P, C = s.shape
    pw = p[:, 2] - p[:, 0] + 1.0
    ph = p[:, 3] - p[:, 1] + 1.0
    px = p[:, 0] + pw * 0.5
    py = p[:, 1] + ph * 0.5
    d = t.reshape(P, C, 4)
    cx = v[:, None, 0] * d[..., 0] * pw[:, None] + px[:, None]
    cy = v[:, None, 1] * d[..., 1] * ph[:, None] + py[:, None]
    w = torch.exp((v[:, None, 2] * d[..., 2]).clamp(max=box_clip)) \
        * pw[:, None]
    h = torch.exp((v[:, None, 3] * d[..., 3]).clamp(max=box_clip)) \
        * ph[:, None]
    dec = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1,
                       cy + h / 2 - 1], dim=2)
    best = s[:, 1:].argmax(1) + 1          # skip background column 0
    assigned = dec.gather(1, best[:, None, None].expand(P, 1, 4))[:, 0]
    return dec.reshape(P, 4 * C), assigned


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet inference output (detection.py:3679): decode each FPN
    level's deltas vs its anchors, concat levels, class-wise NMS. bboxes /
    scores / anchors are per-level lists; returns the padded multiclass_nms
    output."""
    decoded = [box_coder(an, [1.0, 1.0, 1.0, 1.0], bb,
                         code_type='decode_center_size', axis=0)
               for bb, an in zip(bboxes, anchors)]
    all_boxes = torch.cat(decoded, dim=1)                  # (B, sumA, 4)
    all_scores = torch.cat([_t(s, all_boxes) for s in scores], dim=1)
    return multiclass_nms(all_boxes, all_scores.transpose(1, 2),
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=-1)


# ---------------------------------------------------------------------------
# host-side sampling generators (upstream pins these to the CPU too)
# ---------------------------------------------------------------------------

def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _out_device(x, device):
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(None)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             rng=None, device=None):
    """Fast R-CNN training ROI sampling (detection.py:2464), on the host
    (upstream's generate_proposal_labels_op is CPU-only as well). One
    image: rpn_rois (R, 4), gt_* dense padded. ``use_random`` permutes the
    fg and bg candidates with ``rng`` (a ``numpy.random.RandomState``;
    by default one seeded 0). Returns fixed-size (rois (S, 4),
    labels_int32 (S, 1), bbox_targets (S, 4*class_nums),
    bbox_inside_weights, bbox_outside_weights) with S = batch_size_per_im,
    unused rows zero, on ``device`` (by default the rois')."""
    dev = _out_device(rpn_rois, device)
    rois = _host(rpn_rois)
    gtc = _host(gt_classes).reshape(-1)
    gtb = _host(gt_boxes).reshape(-1, 4)
    valid = (gtb[:, 2] - gtb[:, 0]) * (gtb[:, 3] - gtb[:, 1]) > 0
    gtb, gtc = gtb[valid], gtc[valid]
    S = int(batch_size_per_im)
    rng = rng if rng is not None else np.random.RandomState(0)

    allr = np.concatenate([rois, gtb], axis=0) if len(gtb) else rois
    if len(gtb):
        x11, y11 = allr[:, 0:1], allr[:, 1:2]
        x12, y12 = allr[:, 2:3], allr[:, 3:4]
        x21, y21 = gtb[:, 0], gtb[:, 1]
        x22, y22 = gtb[:, 2], gtb[:, 3]
        iw = np.minimum(x12, x22[None, :]) - np.maximum(x11, x21[None, :])
        ih = np.minimum(y12, y22[None, :]) - np.maximum(y11, y21[None, :])
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        a1 = (x12 - x11) * (y12 - y11)
        a2 = ((x22 - x21) * (y22 - y21))[None, :]
        iou = inter / np.maximum(a1 + a2 - inter, 1e-10)
        max_iou = iou.max(axis=1)
        argmax = iou.argmax(axis=1)
    else:
        max_iou = np.zeros(len(allr))
        argmax = np.zeros(len(allr), np.int64)

    fg = np.where(max_iou >= fg_thresh)[0]
    bg = np.where((max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo))[0]
    n_fg = min(int(fg_fraction * S), len(fg))
    n_bg = min(S - n_fg, len(bg))
    if use_random:
        fg = rng.permutation(fg)
        bg = rng.permutation(bg)
    sel = np.concatenate([fg[:n_fg], bg[:n_bg]])

    out_rois = np.zeros((S, 4), np.float32)
    labels = np.zeros((S, 1), np.int32)
    targets = np.zeros((S, 4 * class_nums), np.float32)
    in_w = np.zeros_like(targets)
    for i, r in enumerate(sel):
        out_rois[i] = allr[r]
        if i < n_fg and len(gtb):
            g = argmax[r]
            cls = int(gtc[g]) if not is_cls_agnostic else 1
            labels[i] = cls
            rw = max(allr[r, 2] - allr[r, 0], 1e-9)
            rh = max(allr[r, 3] - allr[r, 1], 1e-9)
            rx = allr[r, 0] + rw * 0.5
            ry = allr[r, 1] + rh * 0.5
            gw = max(gtb[g, 2] - gtb[g, 0], 1e-9)
            gh = max(gtb[g, 3] - gtb[g, 1], 1e-9)
            gx = gtb[g, 0] + gw * 0.5
            gy = gtb[g, 1] + gh * 0.5
            t = np.array([(gx - rx) / rw / bbox_reg_weights[0],
                          (gy - ry) / rh / bbox_reg_weights[1],
                          np.log(gw / rw) / bbox_reg_weights[2],
                          np.log(gh / rh) / bbox_reg_weights[3]],
                         np.float32)
            targets[i, 4 * cls:4 * cls + 4] = t
            in_w[i, 4 * cls:4 * cls + 4] = 1.0
    out_w = (in_w > 0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (out_rois, labels, targets, in_w, out_w))


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution, device=None):
    """Mask R-CNN mask-target rasterization (detection.py:2606), on the
    host. gt_segms: (G, P, 2) polygon points (dense-padded; non-finite
    rows ignored). Returns (mask_rois (S, 4), roi_has_mask_int32 (S, 1),
    mask_int32 (S, num_classes * resolution**2)) on ``device`` (by default
    the rois')."""
    dev = _out_device(rois, device)
    rois_np = _host(rois)
    labs = _host(labels_int32).reshape(-1)
    segs = _host(gt_segms)
    S = len(rois_np)
    res = int(resolution)
    masks = np.zeros((S, num_classes * res * res), np.int32)
    has = np.zeros((S, 1), np.int32)
    for i in range(S):
        c = int(labs[i])
        if c <= 0:
            continue
        has[i] = 1
        x1, y1, x2, y2 = rois_np[i]
        if x2 <= x1 or y2 <= y1 or len(segs) == 0:
            continue
        poly = segs[min(i, len(segs) - 1)].reshape(-1, 2)
        poly = poly[np.isfinite(poly).all(axis=1)]
        if len(poly) < 3:
            continue
        ys = (np.arange(res) + 0.5) / res * (y2 - y1) + y1
        xs = (np.arange(res) + 0.5) / res * (x2 - x1) + x1
        gx, gy = np.meshgrid(xs, ys)
        inside = _points_in_poly(gx.ravel(), gy.ravel(), poly)
        masks[i, c * res * res:(c + 1) * res * res] = \
            inside.astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (rois_np, has, masks))


def _points_in_poly(px, py, poly):
    """Even-odd rule point-in-polygon (host)."""
    n = len(poly)
    inside = np.zeros(len(px), bool)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > py) != (yj > py)) & \
            (px < (xj - xi) * (py - yi) / (yj - yi + 1e-12) + xi)
        inside ^= crosses
        j = i
    return inside


# ---------------------------------------------------------------------------
# SSD head
# ---------------------------------------------------------------------------

def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False, generator=None):
    """SSD multibox head (detection.py:2042): per feature map, a prior_box
    and two convolutions (loc, then conf) built at this call on the
    inputs' device from ``generator`` (as the reference builds its convs
    at each call); outputs concatenated across maps. Returns
    (mbox_locs (B, P, 4), mbox_confs (B, P, C), boxes (P, 4),
    variances (P, 4))."""
    from ..nn import Conv2D
    dev = inputs[0].device
    n_layer = len(inputs)
    if min_sizes is None:
        # upstream's ratio interpolation (detection.py:2198)
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) /
                              max(n_layer - 2, 1)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        mn = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        box, var = _prior_box(
            feat, image, [mn] if not isinstance(mn, list) else mn,
            [mx] if (mx and not isinstance(mx, list)) else mx,
            ar, variance, flip, clip,
            steps=[steps[i], steps[i]] if steps else [0.0, 0.0],
            offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order,
            device=dev)
        n_per_cell = box.shape[2]
        B, cin = feat.shape[0], feat.shape[1]
        for width, out in ((4, locs), (num_classes, confs)):
            conv = Conv2D(cin, n_per_cell * width, kernel_size,
                          stride=stride, padding=pad, device=dev,
                          generator=generator)
            y = conv(feat)
            out.append(y.permute(0, 2, 3, 1).reshape(B, -1, width))
        boxes_l.append(box.reshape(-1, 4))
        vars_l.append(var.reshape(-1, 4))
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1),
            torch.cat(boxes_l, dim=0), torch.cat(vars_l, dim=0))


# ---------------------------------------------------------------------------
# RoI pooling family + deformable ops
# ---------------------------------------------------------------------------

def _per_roi_images(xv, rv, rois_num):
    """Each roi's feature map (R, C, H, W)."""
    return xv[_roi_batch_index(rois_num, rv.shape[0], xv.device)]


def _bin_edges(start, size, pooled, length, quantized):
    """Integer [lo, hi) edges of each bin along one axis -> (R, pooled)
    each, clipped to [0, length]."""
    p = torch.arange(pooled, device=start.device)
    if quantized:                      # roi_pool: integer sizes, as upstream
        lo = start[:, None] + (p[None] * size[:, None]) // pooled
        hi = start[:, None] + ((p[None] + 1) * size[:, None] + pooled - 1) \
            // pooled
    else:
        lo = torch.floor(start[:, None] + p[None] * size[:, None] / pooled)
        hi = torch.ceil(start[:, None] + (p[None] + 1) * size[:, None]
                        / pooled)
    return lo.long().clamp(0, length), hi.long().clamp(0, length)


def _inside(lo, hi, length):
    """(R, pooled, length) membership of each position in each bin."""
    pos = torch.arange(length, device=lo.device)
    return (pos >= lo[..., None]) & (pos < hi[..., None])


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    """RoI MAX pooling (nn.py:6860 / roi_pool_op): input (B, C, H, W);
    rois (R, 4) absolute xyxy; rois_num (B,) rois per image. Quantized bin
    edges (rounded), max within each bin — the Fast R-CNN original; an
    empty bin is 0. Returns (R, C, ph, pw)."""
    xv = _t(input)
    rv = _t(rois, xv)
    ph, pw = int(pooled_height), int(pooled_width)
    B, C, H, W = xv.shape
    img = _per_roi_images(xv, rv, rois_num)               # (R, C, H, W)
    q = torch.round(rv * spatial_scale).long()
    x1, y1, x2, y2 = q.unbind(-1)
    rw = (x2 - x1 + 1).clamp(min=1)
    rh = (y2 - y1 + 1).clamp(min=1)
    in_y = _inside(*_bin_edges(y1, rh, ph, H, True), H)   # (R, ph, H)
    in_x = _inside(*_bin_edges(x1, rw, pw, W, True), W)   # (R, pw, W)
    ninf = _full(xv, -math.inf)
    cols = torch.stack([torch.where(in_x[:, q, None, None, :], img,
                                    ninf).amax(-1) for q in range(pw)],
                       dim=-1)                            # (R, C, H, pw)
    out = torch.stack([torch.where(in_y[:, p, None, :, None], cols,
                                   ninf).amax(2) for p in range(ph)],
                      dim=2)                              # (R, C, ph, pw)
    empty = ~(in_y.any(-1)[:, :, None] & in_x.any(-1)[:, None, :])
    return torch.where(empty[:, None], _full(xv, 0.0), out)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    """Position-sensitive RoI AVG pooling (nn.py:13732 / R-FCN): input
    channels = output_channels * ph * pw; bin (i, j) of output channel c
    averages input channel c*ph*pw + i*pw + j over that bin. Returns
    (R, output_channels, ph, pw)."""
    xv = _t(input)
    rv = _t(rois, xv).to(xv.dtype)
    ph, pw = int(pooled_height), int(pooled_width)
    oc = int(output_channels)
    B, C, H, W = xv.shape
    img = _per_roi_images(xv, rv, rois_num)               # (R, C, H, W)
    x1 = torch.round(rv[:, 0]) * spatial_scale
    y1 = torch.round(rv[:, 1]) * spatial_scale
    x2 = torch.round(rv[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(rv[:, 3] + 1.0) * spatial_scale
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    in_y = _inside(*_bin_edges(y1, rh, ph, H, False), H).to(xv.dtype)
    in_x = _inside(*_bin_edges(x1, rw, pw, W, False), W).to(xv.dtype)
    cnt = (in_y.sum(-1)[:, :, None] * in_x.sum(-1)[:, None, :]).clamp(min=1)
    planes = img[:, :oc * ph * pw].reshape(-1, oc, ph, pw, H, W)
    tot = torch.einsum('rph,rcpqhw,rqw->rcpq', in_y, planes, in_x)
    return tot / cnt[:, None]


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    """Precise RoI pooling (nn.py prroi_pool): the bilinear-integral
    average per bin, computed as the reference does with a dense 4 x 4
    sampling grid a bin (``roi_align``, ``sampling_ratio=4``), fully
    differentiable."""
    from .ops import roi_align
    return roi_align(input, rois, pooled_height, pooled_width,
                     spatial_scale, sampling_ratio=4,
                     rois_num=batch_roi_nums)


def _bilinear_at(img, yy, xx):
    """Bilinear samples of img (C, H, W) at points yy, xx (any equal
    shapes), clamped to the border -> (C, *shape)."""
    C, H, W = img.shape
    yy = yy.clamp(0.0, H - 1.0)
    xx = xx.clamp(0.0, W - 1.0)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    y0, x0 = y0.long(), x0.long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    flat = img.reshape(C, H * W)

    def g(yi, xi):
        return flat[:, (yi * W + xi).reshape(-1)].reshape(C, *yi.shape)
    return (g(y0, x0) * ((1 - wy) * (1 - wx)) + g(y0, x1) * ((1 - wy) * wx)
            + g(y1, x0) * (wy * (1 - wx)) + g(y1, x1) * (wy * wx))


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              name=None):
    """Perspective-warp quadrilateral rois to a fixed rectangle
    (detection.py:3100, OCR east): rois (R, 8) four corner points
    (tl, tr, br, bl), sampled bilinearly on the bilinear map of the output
    rectangle onto the quad, from image 0, as the reference. Returns
    (R, C, th, tw) (the mask and matrix outputs omitted, as the
    reference)."""
    xv = _t(input)
    rv = _t(rois, xv).to(xv.dtype)
    th, tw = int(transformed_height), int(transformed_width)
    pts = rv.reshape(-1, 4, 2) * spatial_scale              # (R, 4, 2)
    u = (torch.arange(tw, dtype=xv.dtype, device=xv.device) + 0.5) / tw
    v = (torch.arange(th, dtype=xv.dtype, device=xv.device) + 0.5) / th
    vv, uu = torch.meshgrid(v, u, indexing='ij')             # (th, tw)
    uu, vv = uu[None, ..., None], vv[None, ..., None]
    top = pts[:, None, None, 0] * (1 - uu) + pts[:, None, None, 1] * uu
    bot = pts[:, None, None, 3] * (1 - uu) + pts[:, None, None, 2] * uu
    p = top * (1 - vv) + bot * vv                            # (R, th, tw, 2)
    out = _bilinear_at(xv[0], p[..., 1], p[..., 0])          # (C, R, th, tw)
    return out.permute(1, 0, 2, 3)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None,
                    generator=None):
    """Deformable convolution v1/v2 (nn.py:14234) as a dense offset-gather:
    for each output position and kernel tap, bilinear-sample the input at
    (base + dilation*tap + offset), multiply by the modulation mask (v2),
    then contract with the weights. Its weight (XavierUniform unless
    ``param_attr`` names an initializer) and bias (zeros; none with
    ``bias_attr=False``) are created at each call on the input's device,
    drawn from ``generator``.

    input (B, Cin, H, W); offset (B, 2*dg*kh*kw, Hout, Wout) packed
    [y0, x0, y1, x1, ...]; mask (B, dg*kh*kw, Hout, Wout) (modulated=True).
    """
    x = _t(input)
    off = _t(offset, x)
    kh, kw = (int(k) for k in _pair(filter_size))
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    cin = x.shape[1]
    w = create_parameter([num_filters, cin // groups, kh, kw], param_attr,
                         device=x.device, generator=generator)
    b = create_parameter([num_filters], bias_attr, device=x.device,
                         generator=generator, is_bias=True)
    if modulated and mask is None:
        raise ValueError("modulated deformable_conv (v2) needs mask")
    msk = _t(mask, x) if modulated else None
    out = _deform(x, off, w.to(x.dtype), msk, kh, kw, s, p, d, groups)
    if b is not None:
        out = out + b.to(x.dtype)[None, :, None, None]
    return out


def _deform_one(img, off, wv, msk, kh, kw, s, p, d, groups):
    """Deformable conv for ONE image (the reference's per-image form)."""
    return _deform(img[None], off[None], wv,
                   None if msk is None else msk[None], kh, kw, s, p, d,
                   groups)[0]


def _deform(img, off, wv, msk, kh, kw, s, p, d, groups):
    """Deformable conv over a batch: img (B, C, H, W), off (B, 2*dg*kh*kw,
    Ho, Wo) (authoritative for the output size), msk (B, dg*kh*kw, Ho, Wo)
    or None -> (B, F, Ho, Wo)."""
    B, C, H, W = img.shape
    Ho, Wo = off.shape[-2], off.shape[-1]
    dg = off.shape[1] // (2 * kh * kw)
    cpg = C // dg
    dev, dt = img.device, img.dtype
    oy = torch.arange(Ho, device=dev) * s[0] - p[0]
    ox = torch.arange(Wo, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    off = off.reshape(B, dg, kh, kw, 2, Ho, Wo)
    base_y = (ky[:, None] + oy[None, :]).to(dt).reshape(1, 1, kh, 1, Ho, 1)
    base_x = (kx[:, None] + ox[None, :]).to(dt).reshape(1, 1, 1, kw, 1, Wo)
    sy = base_y + off[:, :, :, :, 0]                     # (B, dg, kh, kw,
    sx = base_x + off[:, :, :, :, 1]                     #  Ho, Wo)
    inb = (sy > -1.0) & (sy < H) & (sx > -1.0) & (sx < W)
    syc = sy.clamp(0.0, H - 1.0)
    sxc = sx.clamp(0.0, W - 1.0)
    y0 = torch.floor(syc)
    x0 = torch.floor(sxc)
    wy = syc - y0
    wx = sxc - x0
    y0, x0 = y0.long(), x0.long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    flat = img.reshape(B, dg, cpg, H * W)
    taps = kh * kw * Ho * Wo

    def sample(yi, xi):
        idx = (yi * W + xi).reshape(B, dg, 1, taps)
        return flat.gather(3, idx.expand(B, dg, cpg, taps)).reshape(
            B, C, kh, kw, Ho, Wo)

    def rep(a):
        return a[:, :, None].expand(B, dg, cpg, kh, kw, Ho, Wo).reshape(
            B, C, kh, kw, Ho, Wo)

    v = (sample(y0, x0) * rep((1 - wy) * (1 - wx)) +
         sample(y0, x1) * rep((1 - wy) * wx) +
         sample(y1, x0) * rep(wy * (1 - wx)) +
         sample(y1, x1) * rep(wy * wx))
    v = v * rep(inb.to(dt))
    if msk is not None:
        v = v * rep(msk.reshape(B, dg, kh, kw, Ho, Wo))
    if groups == 1:
        return torch.einsum('bcklhw,fckl->bfhw', v, wv)
    fg = wv.shape[0] // groups
    vg = v.reshape(B, groups, C // groups, kh, kw, Ho, Wo)
    wg = wv.reshape(groups, fg, C // groups, kh, kw)
    return torch.einsum('bgcklhw,gfckl->bgfhw', vg, wg).reshape(
        B, -1, Ho, Wo)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """Deformable RoI pooling (nn.py:14391): average-pool each bin at
    trans-shifted positions via bilinear sampling, from image 0, as the
    reference (``group_size``, ``part_size`` and ``position_sensitive``
    are accepted only). input (B, C, H, W); rois (R, 4); trans (R, 2, ph,
    pw) normalized bin shifts. Returns (R, C, ph, pw)."""
    xv = _t(input)
    rv = _t(rois, xv).to(xv.dtype)
    tv = _t(trans, xv).to(xv.dtype)
    ph, pw = int(pooled_height), int(pooled_width)
    spp = max(int(sample_per_part), 1)
    x1 = rv[:, 0] * spatial_scale - 0.5
    y1 = rv[:, 1] * spatial_scale - 0.5
    x2 = (rv[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (rv[:, 3] + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    if no_trans:
        dy = dx = torch.zeros((rv.shape[0], ph, pw), dtype=xv.dtype,
                              device=xv.device)
    else:
        dy = tv[:, 0] * trans_std * rh[:, None, None]
        dx = tv[:, 1] * trans_std * rw[:, None, None]
    sub = (torch.arange(spp, dtype=xv.dtype, device=xv.device) + 0.5) / spp
    py = torch.arange(ph, dtype=xv.dtype, device=xv.device)
    px = torch.arange(pw, dtype=xv.dtype, device=xv.device)
    # samples (R, ph, pw, spp) along each axis, then their outer grid
    yy = y1[:, None, None, None] + (py[None, :, None, None] + sub) \
        * (rh / ph)[:, None, None, None] + dy[..., None]
    xx = x1[:, None, None, None] + (px[None, None, :, None] + sub) \
        * (rw / pw)[:, None, None, None] + dx[..., None]
    yy = yy[..., :, None].expand(*yy.shape, spp)
    xx = xx[..., None, :].expand(*xx.shape[:-1], spp, spp)
    v = _bilinear_at(xv[0], yy, xx)              # (C, R, ph, pw, spp, spp)
    return v.mean(dim=(-2, -1)).permute(1, 0, 2, 3)
