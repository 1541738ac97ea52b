"""Pooling layers. Counterpart of ``paddle_tpu/nn/layer/pooling.py``: each
calls its functional with the arguments it was built with."""
from torch import nn

from .. import functional as F

__all__ = ['MaxPool1D', 'MaxPool2D', 'MaxPool3D', 'AvgPool1D', 'AvgPool2D',
           'AvgPool3D', 'AdaptiveAvgPool1D', 'AdaptiveAvgPool2D',
           'AdaptiveAvgPool3D', 'AdaptiveMaxPool1D', 'AdaptiveMaxPool2D',
           'AdaptiveMaxPool3D']


class _Pool(nn.Module):
    _fname = None

    def __init__(self, **kwargs):
        super().__init__()
        self._kwargs = {k: v for k, v in kwargs.items() if k != 'name'}

    def forward(self, x):
        return getattr(F, self._fname)(x, **self._kwargs)

    def extra_repr(self):
        return ', '.join(f'{k}={v}' for k, v in self._kwargs.items())


class MaxPool1D(_Pool):
    _fname = 'max_pool1d'

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    _fname = 'max_pool2d'

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format='NCHW', name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    _fname = 'max_pool3d'

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format='NCDHW', name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    _fname = 'avg_pool1d'

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    _fname = 'avg_pool2d'

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format='NCHW',
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    _fname = 'avg_pool3d'

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format='NCDHW',
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    _fname = 'adaptive_avg_pool1d'

    def __init__(self, output_size, name=None):
        super().__init__(output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    _fname = 'adaptive_avg_pool2d'

    def __init__(self, output_size, data_format='NCHW', name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    _fname = 'adaptive_avg_pool3d'

    def __init__(self, output_size, data_format='NCDHW', name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class AdaptiveMaxPool1D(_Pool):
    _fname = 'adaptive_max_pool1d'

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)


class AdaptiveMaxPool2D(_Pool):
    _fname = 'adaptive_max_pool2d'

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    _fname = 'adaptive_max_pool3d'

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)
