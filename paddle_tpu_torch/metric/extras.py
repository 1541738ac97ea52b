"""fluid.metrics extras and the host ops feeding them. The port's own copy
of ``paddle_tpu/metric/extras.py`` (``EditDistance``, ``ChunkEvaluator``,
``DetectionMAP``, ``CompositeMetric``; ``edit_distance``, ``chunk_eval``,
``auc``, ``detection_map``).

The reference computes these on the host in numpy and Python over padded
arrays (the Paddle ops they follow run on the CPU inside its executor),
so the port keeps the same numpy code: inputs may be torch tensors (on any
device) or arrays, and the ops return CPU tensors where the reference
returns its ``Tensor``.
"""
import numpy as np
import torch

from . import Metric, _np

__all__ = ['EditDistance', 'DetectionMAP', 'ChunkEvaluator',
           'CompositeMetric', 'edit_distance', 'chunk_eval', 'auc',
           'detection_map']


def _t(array):
    return torch.from_numpy(np.asarray(array))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _levenshtein(a, b):
    """Classic O(len(a)*len(b)) DP (plain lists — numpy scalar boxing makes
    the per-cell loop several times slower)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        ai = a[i - 1]
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ai != b[j - 1]))
        prev = cur
    return prev[lb]


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance between each hyp/ref id sequence pair.

    input/label: [B, T] padded int ids; *_length: [B] valid lengths
    (default: full width). ``normalized`` divides by the reference length.
    Returns ([B, 1] float32 distances, [1] sequence count), the reference
    op's two outputs.
    """
    inp, lab = _np(input), _np(label)
    B = inp.shape[0]
    in_len = _np(input_length).astype(int) if input_length is not None \
        else np.full(B, inp.shape[1], int)
    lb_len = _np(label_length).astype(int) if label_length is not None \
        else np.full(B, lab.shape[1], int)
    ignored = set(ignored_tokens or ())
    out = np.empty((B, 1), np.float32)
    for i in range(B):
        a = [t for t in inp[i, :in_len[i]].tolist() if t not in ignored]
        b = [t for t in lab[i, :lb_len[i]].tolist() if t not in ignored]
        d = _levenshtein(a, b)
        if normalized:
            d = d / max(len(b), 1)
        out[i, 0] = d
    return _t(out), _t(np.array([B], np.int64))


def _extract_chunks(tags, scheme, num_chunk_types, excluded=()):
    """(begin, end, type) chunks from a tag sequence.

    Tag encoding follows the reference chunk_eval op: for IOB each chunk
    type t owns tags (2t: B-t, 2t+1: I-t); IOE uses (I-t, E-t); IOBES uses
    4 tags per type (B, I, E, S); 'plain' gives each type a single tag.
    """
    chunks = []
    start, ctype = None, None

    def close(end):
        nonlocal start, ctype
        if start is not None and ctype not in excluded:
            chunks.append((start, end, ctype))
        start, ctype = None, None

    for pos, tag in enumerate(tags):
        tag = int(tag)
        if scheme == 'plain':
            t, kind = tag, 'S'
        elif scheme == 'IOB':
            t, kind = divmod(tag, 2)
            kind = 'B' if kind == 0 else 'I'
        elif scheme == 'IOE':
            t, kind = divmod(tag, 2)
            kind = 'I' if kind == 0 else 'E'
        elif scheme == 'IOBES':
            t, kind = divmod(tag, 4)
            kind = 'BIES'[kind]
        else:
            raise ValueError("unknown chunk scheme %r" % scheme)
        if t >= num_chunk_types:         # outside tag
            close(pos)
            continue
        if scheme == 'plain':
            if ctype != t:
                close(pos)
                start, ctype = pos, t
            continue
        if kind in ('B', 'S') or ctype != t:
            close(pos)
            start, ctype = pos, t
        if kind in ('E', 'S'):
            close(pos + 1)
    close(len(tags))
    return set(chunks)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision/recall/F1 between inferred and label tags.

    input/label: [B, T] padded tag ids; seq_length: [B]. Returns the
    reference op's six outputs: (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks).
    """
    inf, lab = _np(input), _np(label)
    B = inf.shape[0]
    lens = _np(seq_length).astype(int) if seq_length is not None \
        else np.full(B, inf.shape[1], int)
    excluded = tuple(excluded_chunk_types or ())
    n_inf = n_lab = n_cor = 0
    for i in range(B):
        ci = _extract_chunks(inf[i, :lens[i]], chunk_scheme,
                             num_chunk_types, excluded)
        cl = _extract_chunks(lab[i, :lens[i]], chunk_scheme,
                             num_chunk_types, excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    mk = lambda v, dt: _t(np.array([v], dt))
    return (mk(p, np.float32), mk(r, np.float32), mk(f1, np.float32),
            mk(n_inf, np.int64), mk(n_lab, np.int64), mk(n_cor, np.int64))


def auc(input, label, curve='ROC', num_thresholds=4095, topk=1,
        slide_steps=1):
    """ROC-AUC of positive-class scores via threshold buckets (the
    reference metric_op.py auc accumulates the same histogram state).

    input: [B, 2] class probabilities (positive = column 1) or [B] scores;
    label: [B] / [B, 1] binary. Returns a 0-dim float32 tensor.
    Only curve='ROC' is implemented; topk/slide_steps are accepted for
    signature parity but this computes one-shot (non-windowed) AUC.
    """
    if curve != 'ROC':
        raise NotImplementedError(
            "auc: only curve='ROC' is implemented (got %r)" % curve)
    x, y = _np(input), _np(label).reshape(-1)
    scores = x[:, 1] if x.ndim == 2 else x
    idx = np.clip((scores * num_thresholds).astype(int), 0, num_thresholds)
    pos = y.astype(bool)
    stat_pos = np.bincount(idx[pos], minlength=num_thresholds + 1) \
        .astype(np.float64)
    stat_neg = np.bincount(idx[~pos], minlength=num_thresholds + 1) \
        .astype(np.float64)
    # integrate TPR/FPR from the highest threshold down (trapezoid rule)
    tot_pos = stat_pos.sum()
    tot_neg = stat_neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return _t(np.array(0.0, np.float32))
    area = 0.0
    tp = fp = 0.0
    for i in range(num_thresholds, -1, -1):
        new_tp = tp + stat_pos[i]
        new_fp = fp + stat_neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    return _t(np.array(area / (tot_pos * tot_neg), np.float32))


def detection_map(detect_res, gt_label, gt_box, class_num,
                  overlap_threshold=0.5, ap_version='integral',
                  evaluate_difficult=True):
    """mAP over one batch of detections (reference detection_map_op.cc).

    detect_res: list (per image) of [k, 6] arrays (label, score, x1, y1,
    x2, y2); gt_label/gt_box: lists of [m] labels and [m, 4] boxes.
    Returns the scalar mAP. There is no difficult-flag input here, so only
    evaluate_difficult=True (count every GT) is supported.
    """
    if not evaluate_difficult:
        raise NotImplementedError(
            "detection_map: no difficult-flag input exists in this API; "
            "only evaluate_difficult=True is supported")
    # gather per-class scored matches
    tps = {c: [] for c in range(class_num)}
    n_gt = {c: 0 for c in range(class_num)}
    for det, labs, boxes in zip(detect_res, gt_label, gt_box):
        det = _np(det).reshape(-1, 6)
        labs = _np(labs).reshape(-1).astype(int)
        boxes = _np(boxes).reshape(-1, 4)
        for c in labs:
            if 0 <= int(c) < class_num:   # e.g. background ids are skipped
                n_gt[int(c)] += 1
        matched = set()
        order = np.argsort(-det[:, 1])
        for j in order:
            c, score = int(det[j, 0]), det[j, 1]
            if not 0 <= c < class_num:   # incl. the -1 padding rows that
                continue                 # multiclass_nms emits
            best_iou, best_g = 0.0, -1
            for g in range(len(labs)):
                if labs[g] != c or g in matched:
                    continue
                iou = _iou(det[j, 2:6], boxes[g])
                if iou > best_iou:
                    best_iou, best_g = iou, g
            if best_iou >= overlap_threshold and best_g >= 0:
                matched.add(best_g)
                tps[c].append((score, 1))
            else:
                tps[c].append((score, 0))
    aps = []
    for c in range(class_num):
        if n_gt[c] == 0:
            continue
        pairs = sorted(tps[c], key=lambda p: -p[0])
        tp_cum = np.cumsum([p[1] for p in pairs]) if pairs else np.array([])
        if len(tp_cum) == 0:
            aps.append(0.0)
            continue
        fp_cum = np.arange(1, len(pairs) + 1) - tp_cum
        recall = tp_cum / n_gt[c]
        precision = tp_cum / (tp_cum + fp_cum)
        if ap_version == '11point':
            ap = np.mean([precision[recall >= r].max(initial=0.0)
                          for r in np.linspace(0, 1, 11)])
        else:   # integral
            ap = 0.0
            prev_r = 0.0
            for p, r in zip(precision, recall):
                ap += p * (r - prev_r)
                prev_r = r
        aps.append(float(ap))
    return _t(np.array(np.mean(aps) if aps else 0.0, np.float32))


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1]) +
          (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


# ---------------------------------------------------------------------------
# metric accumulators
# ---------------------------------------------------------------------------

class EditDistance(Metric):
    """Accumulates average edit distance + instance error rate
    (reference fluid/metrics.py EditDistance)."""

    def __init__(self, name='edit_distance'):
        self._name = name
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        d = _np(distances).reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num if seq_num is not None else len(d))
        self.instance_error += int((d > 0).sum())

    def accumulate(self):
        """Returns (avg_distance, instance_error_rate)."""
        if self.seq_num == 0:
            return 0.0, 0.0
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)

    def name(self):
        return self._name


class ChunkEvaluator(Metric):
    """Accumulates chunk counts -> corpus precision/recall/F1
    (reference fluid/metrics.py ChunkEvaluator)."""

    def __init__(self, name='chunk'):
        self._name = name
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(_np(num_infer_chunks).sum())
        self.num_label_chunks += int(_np(num_label_chunks).sum())
        self.num_correct_chunks += int(_np(num_correct_chunks).sum())

    def accumulate(self):
        """Returns (precision, recall, f1)."""
        p = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        r = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1

    def name(self):
        return self._name


class DetectionMAP(Metric):
    """Accumulates detection batches -> mAP (reference DetectionMAP wraps
    the detection_map op per batch; here batches are appended and the map
    recomputed over everything seen)."""

    def __init__(self, class_num, overlap_threshold=0.5,
                 ap_version='integral', name='mAP'):
        self.class_num = class_num
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self._name = name
        self.reset()

    def reset(self):
        self._det, self._lab, self._box = [], [], []

    def update(self, detect_res, gt_label, gt_box):
        self._det.extend(detect_res)
        self._lab.extend(gt_label)
        self._box.extend(gt_box)

    def accumulate(self):
        return float(detection_map(
            self._det, self._lab, self._box, self.class_num,
            self.overlap_threshold, self.ap_version))

    def name(self):
        return self._name


class CompositeMetric(Metric):
    """Bundle of metrics updated together (reference CompositeMetric)."""

    def __init__(self, name='composite'):
        self._name = name
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args, **kwargs):
        for m in self._metrics:
            m.update(*args, **kwargs)

    def accumulate(self):
        return [m.accumulate() for m in self._metrics]

    def name(self):
        return self._name
