"""Metrics. Counterpart of ``paddle_tpu/metric/__init__.py`` (``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc``, the functional
``accuracy``) and, through ``extras``, the fluid metrics.

``Accuracy`` runs on the predictions' device: ``compute`` takes the top
``maxk`` classes with ``torch.topk`` and hands back only the (..., maxk)
correctness tensor, and ``update`` adds its column sums to device totals
(float64), so no step copies the logits, or waits for the device, for the
metric; ``update`` returns the running top-1 accuracy as a 0-dim device
tensor and ``accumulate`` reads the totals once. The reference instead
pulls the predictions to numpy and sorts the whole class axis, and
counts only the first dimension of the correctness matrix
(``paddle_tpu/metric/__init__.py:62``), so on (batch, positions, classes)
predictions its accuracy can exceed 1; the port counts every position
(ROADMAP.md, Queue 3). The rest are host metrics, as in the reference:
they take tensors or arrays and count in numpy.
"""
import abc

import numpy as np
import torch

__all__ = ['Metric', 'Accuracy', 'Precision', 'Recall', 'Auc', 'accuracy',
           'EditDistance', 'ChunkEvaluator', 'DetectionMAP',
           'CompositeMetric', 'edit_distance', 'chunk_eval', 'auc',
           'detection_map']


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy over every position of the predictions' leading
    dimensions."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or 'acc'
        self.reset()

    @torch.no_grad()
    def compute(self, pred, label, *args):
        """-> float (..., maxk) tensor on ``pred``'s device: 1 where the
        j-th largest score's class is the label. ``label`` holds class ids
        (``pred``'s shape without the class axis, or with a 1 there) or
        one-hot rows."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        idx = torch.topk(pred.detach(), self.maxk, dim=-1).indices
        if label.dim() == pred.dim():
            if label.shape[-1] == pred.shape[-1]:
                label = torch.argmax(label, dim=-1)
            else:
                label = label.squeeze(-1)
        return (idx == label[..., None].to(idx.dtype)).to(torch.float32)

    @torch.no_grad()
    def update(self, correct, *args):
        """Add a ``compute`` result -> the running top-1 accuracy (a 0-dim
        tensor on the result's device)."""
        c = torch.as_tensor(correct)
        num = int(np.prod(c.shape[:-1]))
        # the hits at rank j summed over the positions, then cumulated:
        # entry k - 1 is the top-k count
        cum = torch.cumsum(c.reshape(-1, c.shape[-1]).sum(
            0, dtype=torch.float64), 0)
        hits = torch.stack([cum[k - 1] for k in self.topk])
        self._total = hits if self._total is None else self._total + hits
        for i in range(len(self.topk)):
            self.count[i] += num
        return self._total[0] / max(self.count[0], 1)

    @property
    def total(self):
        """The hit counts of each k (read from the device)."""
        if self._total is None:
            return [0.] * len(self.topk)
        return self._total.tolist()

    def reset(self):
        self._total = None
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name='precision', *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        y = _np(labels).reshape(-1)
        pred_pos = (p > 0.5)
        self.tp += int(np.sum(pred_pos & (y == 1)))
        self.fp += int(np.sum(pred_pos & (y == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name='recall', *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).reshape(-1)
        y = _np(labels).reshape(-1)
        pred_pos = (p > 0.5)
        self.tp += int(np.sum(pred_pos & (y == 1)))
        self.fn += int(np.sum(~pred_pos & (y == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve='ROC', num_thresholds=4095, name='auc', *args,
                 **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        y = _np(labels).reshape(-1)
        idx = np.clip((p * self._num_thresholds).astype(int), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx[y == 1], 1)
        np.add.at(self._stat_neg, idx[y != 1], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1)
        self._stat_neg = np.zeros(self._num_thresholds + 1)

    def accumulate(self):
        tot_pos = np.cumsum(self._stat_pos[::-1])
        tot_neg = np.cumsum(self._stat_neg[::-1])
        auc = np.sum(self._stat_neg[::-1] *
                     (np.concatenate([[0], tot_pos[:-1]]) +
                      self._stat_pos[::-1] / 2.))
        denom = tot_pos[-1] * tot_neg[-1]
        return float(auc / denom) if denom else 0.

    def name(self):
        return self._name


@torch.no_grad()
def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows of ``input`` (N, classes) whose top ``k`` classes
    hold the row's label -> a 0-dim float32 tensor on ``input``'s device
    (the reference's ``fluid/layers/metric_op.py:accuracy``)."""
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device)
    idx = torch.topk(input, k, dim=-1).indices
    hit = (idx == label.reshape(-1, 1).to(idx.dtype)).any(dim=-1)
    return hit.to(torch.float32).mean()


from .extras import (EditDistance, ChunkEvaluator, DetectionMAP,  # noqa: E402
                     CompositeMetric, edit_distance, chunk_eval, auc,
                     detection_map)
from . import metrics  # noqa: E402,F401  (the metric.metrics module path)
