"""The ``metric.metrics`` module path (the reference's implementation
module, re-exported as ``paddle_tpu/metric/metrics.py`` does). One
implementation in :mod:`paddle_tpu_torch.metric`, two import paths."""
from . import Accuracy, Auc, Metric, Precision, Recall  # noqa: F401

__all__ = ['Metric', 'Accuracy', 'Precision', 'Recall', 'Auc']
