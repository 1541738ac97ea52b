"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``, ``RMSNorm``)."""
import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ['LayerNorm', 'RMSNorm']


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight ones,
    bias zeros."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"


class RMSNorm(nn.Module):
    """RMSNorm over the last axis, ``hidden_size`` wide, weight ones (the
    reference's ``Constant(1.0)``). ``weight_attr=False`` builds it without
    a weight, as in the reference; other parameter attributes are not
    ported."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None):
        super().__init__()
        if weight_attr not in (None, False):
            raise NotImplementedError(
                "RMSNorm: weight_attr takes None or False; ParamAttr is not "
                "ported")
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(hidden_size, device=device)))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"hidden_size={self.hidden_size}, epsilon={self.epsilon}"
