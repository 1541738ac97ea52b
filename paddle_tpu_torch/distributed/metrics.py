"""Distributed metric reductions. Counterpart of
``paddle_tpu/distributed/metrics.py`` (the reference's fleet metrics,
``fleet/metrics/metric.py``): each helper reduces its statistic over the
ranks and returns a Python float.

In a process group the statistic is all-reduced (float64, on the CPU:
the group's gloo side). Without one, a ``PADDLE_TRAINERS_NUM`` above 1
takes the reference's closed form for workers that all hold this
process's value (a sum scales by the worker count; max and min are the
value), and otherwise the statistic is this process's own.
"""
import builtins
import os

import numpy as np
import torch

__all__ = ['acc', 'auc', 'mae', 'mse', 'rmse', 'sum', 'max', 'min']


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _allreduce(value, op='sum'):
    from . import env
    if env.is_initialized():
        from .collective import all_reduce
        t = torch.as_tensor(np.asarray(value, np.float64))
        return all_reduce(t.clone(), op=op).numpy()
    n_workers = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
    v = np.asarray(value)
    if n_workers > 1 and op == 'sum':
        return v * n_workers
    return v


def sum(input, scope=None, util=None):
    return float(_allreduce(_np(input).sum()))


def max(input, scope=None, util=None):
    return float(_allreduce(_np(input).max(), op='max'))


def min(input, scope=None, util=None):
    return float(_allreduce(_np(input).min(), op='min'))


def acc(correct, total, scope=None, util=None):
    c = _allreduce(_np(correct).sum())
    t = _allreduce(_np(total).sum())
    return float(c) / builtins.max(float(t), 1.0)


def mae(abserr, total_ins_num, scope=None, util=None):
    e = _allreduce(_np(abserr).sum())
    n = _allreduce(_np(total_ins_num).sum())
    return float(e) / builtins.max(float(n), 1.0)


def mse(sqrerr, total_ins_num, scope=None, util=None):
    e = _allreduce(_np(sqrerr).sum())
    n = _allreduce(_np(total_ins_num).sum())
    return float(e) / builtins.max(float(n), 1.0)


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from the positive and negative prediction histograms
    (the buckets all-reduced, then the ROC integrated)."""
    pos = _allreduce(_np(stat_pos).astype(np.float64))
    neg = _allreduce(_np(stat_neg).astype(np.float64))
    tot_pos = new_pos = 0.0
    tot_neg = new_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))
