"""Activation layers. Counterpart of ``paddle_tpu/nn/layer/activation.py``;
only ``GELU``, which GPT's MLP names."""
from torch import nn

from .. import functional as F

__all__ = ['GELU']


class GELU(nn.Module):
    """``F.gelu``: the exact erf form, the reference's default."""

    def forward(self, x):
        return F.gelu(x)
