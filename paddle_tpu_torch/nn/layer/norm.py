"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``, ``RMSNorm``)."""
import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import create_parameter

__all__ = ['LayerNorm', 'RMSNorm']


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight ones,
    bias zeros (or the global bias initializer). ``weight_attr`` /
    ``bias_attr``: a ``ParamAttr`` (with an initializer or not), an
    ``Initializer``, a name, None, or False for no weight / no bias, as in
    the reference; ``generator`` feeds a random initializer."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(self.normalized_shape, weight_attr,
                                       default=lambda w: w.fill_(1.0), **kw)
        self.bias = create_parameter(self.normalized_shape, bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, " \
               f"epsilon={self.epsilon}"


class RMSNorm(nn.Module):
    """RMSNorm over the last axis, ``hidden_size`` wide, weight ones (the
    reference's ``Constant(1.0)``). ``weight_attr``: a ``ParamAttr`` (its
    initializer, learning rate, regularizer, ``trainable``, ``need_clip``),
    an ``Initializer``, a name, None, or False for no weight, as in the
    reference; ``generator`` feeds a random initializer."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = create_parameter(
            (hidden_size,), weight_attr, device=device, generator=generator,
            default=lambda w: w.fill_(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"hidden_size={self.hidden_size}, epsilon={self.epsilon}"
