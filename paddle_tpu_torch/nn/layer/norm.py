"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``)."""
import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ['LayerNorm']


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
