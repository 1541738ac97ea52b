"""Loss layers. Counterpart of ``paddle_tpu/nn/layer/loss.py``: each calls
its functional with the arguments it was built with."""
from torch import nn

from .. import functional as F

__all__ = ['CrossEntropyLoss', 'MSELoss', 'L1Loss', 'NLLLoss', 'BCELoss',
           'BCEWithLogitsLoss', 'KLDivLoss', 'SmoothL1Loss',
           'MarginRankingLoss', 'CTCLoss', 'HingeEmbeddingLoss',
           'CosineEmbeddingLoss', 'TripletMarginLoss']


class _Loss(nn.Module):
    _fname = None

    def __init__(self, **kwargs):
        super().__init__()
        self._kwargs = {k: v for k, v in kwargs.items() if k != 'name'}

    def forward(self, *inputs):
        return getattr(F, self._fname)(*inputs, **self._kwargs)


class CrossEntropyLoss(_Loss):
    _fname = 'cross_entropy'

    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax)


class MSELoss(_Loss):
    _fname = 'mse_loss'

    def __init__(self, reduction='mean'):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _fname = 'l1_loss'

    def __init__(self, reduction='mean', name=None):
        super().__init__(reduction=reduction)


class NLLLoss(_Loss):
    _fname = 'nll_loss'

    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    _fname = 'binary_cross_entropy'

    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _fname = 'binary_cross_entropy_with_logits'

    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    _fname = 'kl_div'

    def __init__(self, reduction='mean'):
        super().__init__(reduction=reduction)


class SmoothL1Loss(_Loss):
    _fname = 'smooth_l1_loss'

    def __init__(self, reduction='mean', delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class MarginRankingLoss(_Loss):
    _fname = 'margin_ranking_loss'

    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__(margin=margin, reduction=reduction)


class CTCLoss(_Loss):
    _fname = 'ctc_loss'

    def __init__(self, blank=0, reduction='mean'):
        super().__init__(blank=blank, reduction=reduction)

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          norm_by_times=norm_by_times, **self._kwargs)


class HingeEmbeddingLoss(_Loss):
    _fname = 'hinge_embedding_loss'

    def __init__(self, margin=1.0, reduction='mean', name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _fname = 'cosine_embedding_loss'

    def __init__(self, margin=0, reduction='mean', name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _fname = 'triplet_margin_loss'

    def __init__(self, margin=1.0, p=2., epsilon=1e-6, swap=False,
                 reduction='mean', name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)
