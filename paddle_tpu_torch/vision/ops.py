"""Detection box ops. Counterpart of ``paddle_tpu/vision/ops.py``
(upstream ``fluid/layers/detection.py``: ``iou_similarity``, ``box_coder``,
``yolo_box``, ``prior_box``, ``density_prior_box``, ``anchor_generator``,
``multiclass_nms``, ``box_clip``; ``roi_align_op``).

Every op keeps the reference's fixed-shape contract: variable-length
results (NMS keep lists) are padded top-k tensors with a valid count. The
ops run as plain PyTorch on the device of their tensor inputs; the prior
and anchor generators are host numpy (their contents are functions of the
shapes alone) and return tensors on ``device`` (CUDA unless the caller
passes ``device='cpu'``).

Greedy NMS (``_nms``) runs one candidate a step for all images and classes
at once, on the device: no host sync in the loop, and exactly the greedy
result. Where the reference departs from upstream Paddle, the port
computes upstream's rule (ROADMAP.md, Queue 3): ``multiclass_nms`` honours
``nms_eta``, and ``roi_align`` samples ``ceil(roi / bins)`` points a bin
when ``sampling_ratio <= 0`` and reads 0 for a sample outside (-1, H) x
(-1, W).
"""
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = ['iou_similarity', 'box_coder', 'prior_box', 'density_prior_box',
           'anchor_generator', 'yolo_box', 'multiclass_nms', 'roi_align',
           'box_clip', 'nms']


def _t(x, like=None):
    """``x`` as a tensor: a tensor as it is, anything else on ``like``'s
    device (the CUDA device when ``like`` is not a tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else \
        resolve_device(None)
    return torch.as_tensor(np.asarray(x), device=dev)


# ---------------------------------------------------------------------------
# IoU / box coding
# ---------------------------------------------------------------------------

def _pairwise_iou(x, y, box_normalized=True):
    """x: (..., N, 4), y: (..., M, 4) xyxy -> (..., N, M) IoU."""
    off = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = x.unbind(-1)
    bx1, by1, bx2, by2 = y.unbind(-1)
    area_x = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_y = (bx2 - bx1 + off) * (by2 - by1 + off)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = (ix2 - ix1 + off).clamp(min=0.0)
    ih = (iy2 - iy1 + off).clamp(min=0.0)
    inter = iw * ih
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-10),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU of (N, 4) vs (M, 4) xyxy boxes -> (N, M).

    Parity: fluid.layers.iou_similarity (detection.py:763)."""
    x = _t(x)
    return _pairwise_iou(x, _t(y, x), box_normalized)


def _variance(var, like):
    """A box coder's variance: None, a tensor, or 4 numbers (kept as Python
    floats: no host-to-device copy)."""
    if var is None:
        return None
    if isinstance(var, (list, tuple)):
        return [float(v) for v in var]
    return _t(var, like)


def _var_col(v, i):
    return v[i] if isinstance(v, list) else v[..., i]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    """Encode/decode target boxes against priors.

    Parity: fluid.layers.box_coder (detection.py:817). encode: target (N, 4),
    prior (M, 4) -> (N, M, 4). decode: target (N, M, 4), prior (N|M, 4)
    broadcast along ``axis`` -> (N, M, 4). ``prior_box_var``: None, an
    (M, 4) tensor or 4 numbers."""
    t = _t(target_box)
    p = _t(prior_box, t)
    v = _variance(prior_box_var, t)
    off = 0.0 if box_normalized else 1.0
    encode = code_type.lower() in ("encode_center_size", "encode")

    def centers(b):
        w = b[..., 2] - b[..., 0] + off
        h = b[..., 3] - b[..., 1] + off
        return b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w, h

    pcx, pcy, pw, ph = centers(p)                     # (M,)
    if encode:
        tcx, tcy, tw, th = centers(t)                 # (N,)
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)   # (N, M, 4)
        if v is None:
            return out
        if isinstance(v, list):
            return torch.stack([out[..., i] / v[i] for i in range(4)], -1)
        v = v.reshape(1, -1, 4) if v.dim() == 2 else v.reshape(1, 1, 4)
        return out / v
    # decode: t is (N, M, 4) offsets, p broadcasts along axis
    if axis == 0:
        pcx, pcy, pw, ph = (a[None, :] for a in (pcx, pcy, pw, ph))
        if isinstance(v, torch.Tensor) and v.dim() == 2:
            v = v[None, :, :]
    else:
        pcx, pcy, pw, ph = (a[:, None] for a in (pcx, pcy, pw, ph))
        if isinstance(v, torch.Tensor) and v.dim() == 2:
            v = v[:, None, :]
    if v is None:
        v = [1.0] * 4
    elif isinstance(v, torch.Tensor) and v.dim() == 1:
        v = v.reshape(1, 1, 4)
    dcx = _var_col(v, 0) * t[..., 0] * pw + pcx
    dcy = _var_col(v, 1) * t[..., 1] * ph + pcy
    dw = torch.exp(_var_col(v, 2) * t[..., 2]) * pw
    dh = torch.exp(_var_col(v, 3) * t[..., 3]) * ph
    return torch.stack([dcx - dw / 2, dcy - dh / 2,
                        dcx + dw / 2 - off, dcy + dh / 2 - off], dim=-1)


def box_clip(input, im_info, name=None):
    """Clip xyxy boxes to image bounds.

    Parity: fluid.layers.box_clip (detection.py:3037). im_info: (B, 3)
    [h, w, scale]; boxes are clipped to [0, w/scale - 1] x [0, h/scale - 1].
    """
    b = _t(input)
    info = _t(im_info, b)
    im_h = info[..., 0] / info[..., 2] - 1.0
    im_w = info[..., 1] / info[..., 2] - 1.0
    while im_h.dim() < b.dim() - 1:
        im_h = im_h[..., None]
        im_w = im_w[..., None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), im_w)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), im_h)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), im_w)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), im_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


# ---------------------------------------------------------------------------
# prior / anchor generation (host numpy: shapes and contents are functions
# of the feature-map geometry alone)
# ---------------------------------------------------------------------------

def _expand_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _hw(x):
    shape = x.shape if hasattr(x, 'shape') else np.shape(x)
    return int(shape[2]), int(shape[3])


def _on(device, *arrays):
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False, device=None):
    """SSD prior boxes for one feature map.

    Parity: fluid.layers.prior_box (detection.py:1768). input: (B, C, H, W)
    feature map; image: (B, C, IH, IW) (only their shapes are read).
    Returns (boxes, variances), each (H, W, num_priors, 4) on ``device``;
    boxes are normalized xyxy."""
    fh, fw = _hw(input)
    ih, iw = _hw(image)
    min_sizes = [float(s) for s in _expand_list(min_sizes)]
    max_sizes = [float(s) for s in _expand_list(max_sizes)] if max_sizes \
        else []
    ars = [1.0]
    for ar in _expand_list(aspect_ratios):
        ar = float(ar)
        if any(abs(ar - e) < 1e-6 for e in ars):
            continue
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)

    step_w = float(steps[0]) if steps[0] else iw / fw
    step_h = float(steps[1]) if steps[1] else ih / fh

    whs = []  # (w, h) per prior, in pixels
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                big = math.sqrt(ms * max_sizes[min_sizes.index(ms)])
                whs.append((big, big))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                big = math.sqrt(ms * max_sizes[min_sizes.index(ms)])
                whs.append((big, big))
    whs = np.asarray(whs, np.float32)            # (P, 2)

    cx = (np.arange(fw, dtype=np.float32) + offset) * step_w
    cy = (np.arange(fh, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)               # (H, W)
    boxes = np.empty((fh, fw, len(whs), 4), np.float32)
    boxes[..., 0] = (cxg[..., None] - whs[None, None, :, 0] / 2) / iw
    boxes[..., 1] = (cyg[..., None] - whs[None, None, :, 1] / 2) / ih
    boxes[..., 2] = (cxg[..., None] + whs[None, None, :, 0] / 2) / iw
    boxes[..., 3] = (cyg[..., None] + whs[None, None, :, 1] / 2) / ih
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    variances = np.broadcast_to(np.asarray(variance, np.float32),
                                boxes.shape)
    return _on(device, boxes, variances)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None, device=None):
    """Densified prior boxes (face-detection SSD variant).

    Parity: fluid.layers.density_prior_box (detection.py:1930). For each
    (density, fixed_size) pair and each fixed_ratio, lays a density x density
    grid of shifted centers inside each step cell. Returns (boxes,
    variances) on ``device``."""
    fh, fw = _hw(input)
    ih, iw = _hw(image)
    densities = [int(d) for d in _expand_list(densities)]
    fixed_sizes = [float(s) for s in _expand_list(fixed_sizes)]
    fixed_ratios = [float(r) for r in _expand_list(fixed_ratios)]
    step_w = float(steps[0]) if steps[0] else iw / fw
    step_h = float(steps[1]) if steps[1] else ih / fh

    all_boxes = []
    cx = (np.arange(fw, dtype=np.float32) + offset) * step_w
    cy = (np.arange(fh, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    for density, fs in zip(densities, fixed_sizes):
        for ratio in fixed_ratios:
            w = fs * math.sqrt(ratio)
            h = fs / math.sqrt(ratio)
            shift_w = step_w / density
            shift_h = step_h / density
            for di in range(density):
                for dj in range(density):
                    ccx = cxg - step_w / 2. + shift_w / 2. + dj * shift_w
                    ccy = cyg - step_h / 2. + shift_h / 2. + di * shift_h
                    all_boxes.append(np.stack([
                        (ccx - w / 2.) / iw, (ccy - h / 2.) / ih,
                        (ccx + w / 2.) / iw, (ccy + h / 2.) / ih], axis=-1))
    boxes = np.stack(all_boxes, axis=2).astype(np.float32)  # (H, W, P, 4)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    variances = np.broadcast_to(np.asarray(variance, np.float32),
                                boxes.shape)
    if flatten_to_2d:
        boxes = boxes.reshape(-1, 4)
        variances = variances.reshape(-1, 4)
    return _on(device, boxes, variances)


def anchor_generator(input, anchor_sizes=(64., 128., 256., 512.),
                     aspect_ratios=(0.5, 1.0, 2.0),
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None, device=None):
    """RPN anchors for one feature map.

    Parity: fluid.layers.anchor_generator (detection.py:2403). Returns
    (anchors, variances), each (H, W, num_anchors, 4) on ``device``,
    anchors in ABSOLUTE xyxy pixels."""
    fh, fw = _hw(input)
    sizes = [float(s) for s in _expand_list(anchor_sizes)]
    ars = [float(r) for r in _expand_list(aspect_ratios)]
    sw, sh = float(stride[0]), float(stride[1])

    # upstream's recipe (anchor_generator_op.h): snap a stride-area cell to
    # the aspect ratio, then scale to anchor_size
    whs = []
    for ar in ars:
        for s in sizes:
            base_w = round(math.sqrt(sw * sh / ar))
            base_h = round(base_w * ar)
            whs.append((s / sw * base_w, s / sh * base_h))
    whs = np.asarray(whs, np.float32)  # (A, 2): (w, h)

    cx = np.arange(fw, dtype=np.float32) * sw + offset * (sw - 1)
    cy = np.arange(fh, dtype=np.float32) * sh + offset * (sh - 1)
    cxg, cyg = np.meshgrid(cx, cy)
    anchors = np.empty((fh, fw, len(whs), 4), np.float32)
    anchors[..., 0] = cxg[..., None] - 0.5 * (whs[None, None, :, 0] - 1)
    anchors[..., 1] = cyg[..., None] - 0.5 * (whs[None, None, :, 1] - 1)
    anchors[..., 2] = cxg[..., None] + 0.5 * (whs[None, None, :, 0] - 1)
    anchors[..., 3] = cyg[..., None] + 0.5 * (whs[None, None, :, 1] - 1)
    variances = np.broadcast_to(np.asarray(variance, np.float32),
                                anchors.shape)
    return _on(device, anchors, variances)


# ---------------------------------------------------------------------------
# YOLO decode
# ---------------------------------------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode YOLOv3 head output into boxes + per-class scores.

    Parity: fluid.layers.yolo_box (detection.py:1133). x: (B, A*(5+C), H, W);
    img_size: (B, 2) [h, w]. Returns boxes (B, H*W*A, 4) absolute xyxy and
    scores (B, H*W*A, C). Low-confidence boxes are zeroed (upstream's
    conf_thresh gating) so shapes stay static."""
    xv = _t(x)
    imgs = _t(img_size, xv)
    anchors = [float(a) for a in anchors]
    na = len(anchors) // 2
    cnum = int(class_num)
    b, _, h, w = xv.shape
    xv = xv.reshape(b, na, 5 + cnum, h, w)
    f32 = dict(dtype=xv.dtype, device=xv.device)
    grid_x = torch.arange(w, **f32)[None, None, None, :]
    grid_y = torch.arange(h, **f32)[None, None, :, None]
    aw = torch.tensor(anchors[0::2], **f32)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], **f32)[None, :, None, None]

    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(xv[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(xv[:, :, 1]) * alpha + beta + grid_y) / h
    bw = torch.exp(xv[:, :, 2]) * aw / (w * downsample_ratio)
    bh = torch.exp(xv[:, :, 3]) * ah / (h * downsample_ratio)
    conf = torch.sigmoid(xv[:, :, 4])
    probs = torch.sigmoid(xv[:, :, 5:]) * conf[:, :, None]  # (B,A,C,H,W)

    im_h = imgs[:, 0].to(xv.dtype)[:, None, None, None]
    im_w = imgs[:, 1].to(xv.dtype)[:, None, None, None]
    x1 = (bx - bw / 2.) * im_w
    y1 = (by - bh / 2.) * im_h
    x2 = (bx + bw / 2.) * im_w
    y2 = (by + bh / 2.) * im_h
    if clip_bbox:
        zero = torch.zeros((), **f32)
        x1 = torch.minimum(torch.maximum(x1, zero), im_w - 1.)
        y1 = torch.minimum(torch.maximum(y1, zero), im_h - 1.)
        x2 = torch.minimum(torch.maximum(x2, zero), im_w - 1.)
        y2 = torch.minimum(torch.maximum(y2, zero), im_h - 1.)
    keep = (conf >= conf_thresh).to(xv.dtype)
    boxes = torch.stack([x1, y1, x2, y2], dim=2) * keep[:, :, None]
    # (B, A, 4, H, W) -> (B, H*W*A, 4): row-major HW x A, as upstream
    boxes = boxes.permute(0, 3, 4, 1, 2).reshape(b, -1, 4)
    probs = probs * keep[:, :, None]
    scores = probs.permute(0, 3, 4, 1, 2).reshape(b, -1, cnum)
    return boxes, scores


# ---------------------------------------------------------------------------
# NMS — fixed-shape padded formulation
# ---------------------------------------------------------------------------

def _greedy(iou, alive, threshold, eta=1.0):
    """Greedy hard NMS over candidates already in score order: iou (..., k,
    k), alive (..., k) bool (the finite candidates) -> the kept mask.

    One candidate a step for every leading index at once, on the device
    (two launches a step, no host sync). With ``eta < 1`` upstream's
    adaptive threshold (``NMSFast``): a candidate is kept when its overlap
    with every kept one is at most the threshold, which shrinks by ``eta``
    after each keep while it is above 0.5."""
    k = alive.shape[-1]
    if k == 0:
        return alive
    if eta >= 1.0:
        upper = torch.ones((k, k), dtype=torch.bool,
                           device=iou.device).triu_(1)
        over = ((iou > threshold) & upper).to(iou.dtype)
        keep = alive.to(iou.dtype)
        one = torch.ones((), dtype=iou.dtype, device=iou.device)
        for i in range(k - 1):
            # a kept candidate i removes every later one it overlaps
            keep.mul_(torch.addcmul(one, over[..., i, :], keep[..., i:i + 1],
                                    value=-1.0))
        return keep > 0
    kept = torch.zeros_like(alive)
    thr = torch.full(alive.shape[:-1], float(threshold), dtype=iou.dtype,
                     device=iou.device)
    for j in range(k):
        viol = ((iou[..., :j, j] > thr[..., None]) & kept[..., :j]).any(-1)
        kj = alive[..., j] & ~viol
        kept[..., j] = kj
        thr = torch.where(kj & (thr > 0.5), thr * eta, thr)
    return kept


def _nms(boxes, scores, iou_threshold, top_k, score_threshold,
         normalized=True, eta=1.0):
    """boxes (..., M, 4) (broadcast against scores' leading dims), scores
    (..., M) -> (order (..., k), alive (..., k)): the ``k = min(top_k, M)``
    best candidates above ``score_threshold`` (a stable sort: equal scores
    keep their index order) and the greedy NMS keep mask over them."""
    m = scores.shape[-1]
    k = min(top_k, m)
    neg = torch.full((), -math.inf, dtype=scores.dtype, device=scores.device)
    s = torch.where(scores > score_threshold, scores, neg)
    order = torch.argsort(-s, dim=-1, stable=True)[..., :k]
    cand_scores = s.gather(-1, order)
    boxes = boxes.expand(*s.shape, 4)
    cand_boxes = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    iou = _pairwise_iou(cand_boxes, cand_boxes, normalized)
    return order, _greedy(iou, torch.isfinite(cand_scores), iou_threshold,
                          eta)


def nms(boxes, scores, iou_threshold=0.3, top_k=64, score_threshold=-1e30,
        normalized=True):
    """Single-class NMS: returns (indices, valid_mask) both shaped (top_k,)
    (``min(top_k, M)``); ``indices[i]`` is only meaningful where
    ``valid_mask[i]``. Leading dims batch."""
    b = _t(boxes)
    return _nms(b, _t(scores, b), iou_threshold, top_k, score_threshold,
                normalized)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None,
                   return_index=False):
    """Multi-class NMS with FIXED-shape padded output.

    Parity: fluid.layers.multiclass_nms (detection.py:3257): returns ``out``
    of shape (B, keep_top_k, 6) [label, score, x1, y1, x2, y2], sorted by
    score, padded with -1 rows, plus ``valid_counts`` (B,) — instead of
    upstream's LoD tensor. bboxes: (B, M, 4); scores: (B, C, M). With
    ``return_index`` also the selected per-image box row indices
    (B, keep_top_k) int32, -1 where padded (the multiclass_nms2 contract).
    ``nms_eta < 1`` shrinks the threshold after each keep, as upstream."""
    bb = _t(bboxes)
    sc = _t(scores, bb)
    B, M, _ = bb.shape
    C = sc.shape[1]
    k = min(nms_top_k, M) if nms_top_k > 0 else M
    neg = torch.full((), -math.inf, dtype=sc.dtype, device=sc.device)
    if background_label >= 0:
        # exclude background by sinking its scores below the threshold
        is_bg = torch.arange(C, device=sc.device) == background_label
        sc = torch.where(is_bg[None, :, None], neg, sc)
    order, alive = _nms(bb[:, None], sc, nms_threshold, k, score_threshold,
                        normalized, nms_eta)              # (B, C, k)
    s = torch.where(alive, sc.gather(-1, order), neg)
    bsel = bb[:, None].expand(B, C, M, 4).gather(
        2, order[..., None].expand(B, C, k, 4))
    osel = torch.where(alive, order, torch.full_like(order, -1))
    labels = torch.arange(C, dtype=bb.dtype, device=bb.device)[:, None] \
        .expand(B, C, k)
    allc = torch.cat([labels[..., None], s[..., None], bsel],
                     dim=-1).reshape(B, C * k, 6)
    flat_idx = osel.reshape(B, C * k)
    kk = min(keep_top_k, C * k)
    top = torch.argsort(-allc[..., 1], dim=-1, stable=True)[:, :kk]
    sel = allc.gather(1, top[..., None].expand(B, kk, 6))
    idx = flat_idx.gather(1, top)
    valid = torch.isfinite(sel[..., 1])
    sel = torch.where(valid[..., None], sel, torch.full_like(sel, -1.0))
    idx = torch.where(valid, idx, torch.full_like(idx, -1)).to(torch.int32)
    counts = valid.sum(-1, dtype=torch.int32)
    pad = keep_top_k - kk
    if pad > 0:
        sel = torch.cat([sel, sel.new_full((B, pad, 6), -1.0)], dim=1)
        idx = torch.cat([idx, idx.new_full((B, pad), -1)], dim=1)
    if return_index:
        return sel, idx, counts
    return sel, counts


# ---------------------------------------------------------------------------
# RoI align
# ---------------------------------------------------------------------------

def _roi_batch_index(rois_num, R, device):
    """The image of each of ``R`` rois: ``rois_num`` None (all on image
    0), a list (host) or a tensor of counts (cumsum + searchsorted on the
    device)."""
    if rois_num is None:
        return torch.zeros((R,), dtype=torch.long, device=device)
    if isinstance(rois_num, (list, tuple, np.ndarray)):
        idx = np.repeat(np.arange(len(rois_num)),
                        np.asarray(rois_num, np.int64))
        return torch.from_numpy(idx).to(device)
    bounds = torch.cumsum(rois_num.to(device).long(), 0)
    return torch.searchsorted(bounds, torch.arange(R, device=device),
                              right=True)


def _sample_weights(start, size, pooled, grid, length, zero_outside):
    """Bilinear sampling weights along one axis, averaged over each bin's
    samples: start, size (R,) in feature-map units, ``grid`` samples a bin
    (an int, or (R,) ints) -> (R, pooled, length), so that a bin's value
    is ``w_y @ plane @ w_x^T``. Sample t of bin p sits at ``start + (p *
    g + t + 0.5) * size / (pooled * g)``; a sample outside (-1, length)
    reads 0 with ``zero_outside`` (upstream), else the clamped border."""
    dev, dt = start.device, start.dtype
    per_roi = isinstance(grid, torch.Tensor)
    g_max = int(grid.max()) if per_roi else int(grid)      # one host read
    g = grid.to(dt)[:, None, None] if per_roi else float(grid)
    p = torch.arange(pooled, device=dev, dtype=dt)[None, :, None]
    t = torch.arange(g_max, device=dev, dtype=dt)[None, None, :]
    pos = start[:, None, None] + (p * g + t + 0.5) * (
        size[:, None, None] / (pooled * g))                # (R, P, G)
    weight = torch.ones_like(pos) / g
    if per_roi:
        weight = weight * (t < g).to(dt)
    if zero_outside:
        weight = weight * ((pos >= -1.0) & (pos <= length)).to(dt)
    c = pos.clamp(0.0, length - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=length - 1)
    onehot = torch.nn.functional.one_hot
    w = (onehot(lo, length).to(dt) * ((1.0 - frac) * weight)[..., None]
         + onehot(hi, length).to(dt) * (frac * weight)[..., None])
    return w.sum(2)                                        # (R, P, length)


def _roi_bins(x, batch_idx, wy, wx):
    """out[r, c, p, q] = sum_hw wy[r, p, h] x[b_r, c, h, w] wx[r, q, w]:
    the rows first, through the image's one-hot block of ``wy`` (no
    per-roi copy of the feature map)."""
    B, C, H, W = x.shape
    R, P, _ = wy.shape
    onehot = torch.nn.functional.one_hot(batch_idx, B).to(x.dtype)  # (R, B)
    wyb = (onehot[:, None, :, None] * wy[:, :, None, :]).reshape(R * P,
                                                                 B * H)
    rows = wyb @ x.permute(0, 2, 1, 3).reshape(B * H, C * W)
    rows = rows.reshape(R, P, C, W)
    return torch.einsum('rpcw,rqw->rcpq', rows, wx)


def roi_align(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
              sampling_ratio=-1, rois_num=None, name=None):
    """RoI align (Mask R-CNN) with bilinear sampling.

    Parity: paddle/fluid/operators/roi_align_op.* (upstream's rules, where
    the reference departs from them: ``sampling_ratio <= 0`` takes
    ``ceil(roi_h / pooled_h)`` x ``ceil(roi_w / pooled_w)`` samples a bin,
    one host read for their maximum; a sample outside (-1, H) x (-1, W)
    reads 0). input: (B, C, H, W); rois: (R, 4) absolute xyxy in
    input-image coordinates; rois_num: (B,) rois per image (a list or a
    tensor; by default all rois on image 0). Returns (R, C, pooled_height,
    pooled_width). Differentiable in ``input`` (the backward is two
    products, no scatter)."""
    x = _t(input)
    r = _t(rois, x).to(x.dtype)
    R = r.shape[0]
    ph, pw = int(pooled_height), int(pooled_width)
    H, W = x.shape[2], x.shape[3]
    if R == 0:
        return x.new_zeros((0, x.shape[1], ph, pw))
    bidx = _roi_batch_index(rois_num, R, x.device)
    x1, y1, x2, y2 = (r * spatial_scale).unbind(-1)
    rw = (x2 - x1).clamp(min=1.0)
    rh = (y2 - y1).clamp(min=1.0)
    if sampling_ratio > 0:
        gy = gx = int(sampling_ratio)
    else:
        gy = torch.ceil(rh / ph).long().clamp(min=1)
        gx = torch.ceil(rw / pw).long().clamp(min=1)
    wy = _sample_weights(y1, rh, ph, gy, H, True)
    wx = _sample_weights(x1, rw, pw, gx, W, True)
    return _roi_bins(x, bidx, wy, wx)
