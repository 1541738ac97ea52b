"""Convolution layers. Counterpart of ``paddle_tpu/nn/layer/conv.py``
(``Conv1D/2D/3D`` and ``Conv1D/2D/3DTranspose``).

The weight is (out, in / groups, k...) for a convolution and (in, out /
groups, k...) for a transposed one, Paddle's layouts and torch's, so
``interop`` moves it untransposed. Without an initializer the weight is
the reference's ``KaimingUniform(negative_slope=sqrt(5))`` of ``fan_in =
in / groups * prod(k)`` (U(+-1/sqrt(fan_in))) and the bias ``Uniform(-1 /
sqrt(fan_in), 1 / sqrt(fan_in))``, drawn from ``generator``.

``padding_mode`` other than ``'zeros'`` (``'reflect'``, ``'replicate'``,
``'circular'``) pads the input by ``padding`` in that mode before a
convolution without padding, as upstream Paddle does; the reference
accepts it and stores it nowhere (ROADMAP.md, Queue 3).
"""
import math

import torch.nn.functional as TF
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..functional.conv import (norm_padding, to_channels_first,
                               to_channels_last, torch_pad)
from ..initializer import create_parameter

__all__ = ['Conv1D', 'Conv2D', 'Conv3D', 'Conv1DTranspose',
           'Conv2DTranspose', 'Conv3DTranspose']


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, transposed,
                 dims, stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, padding_mode='zeros', weight_attr=None,
                 bias_attr=None, data_format='NCHW', *, device=None,
                 generator=None):
        super().__init__()
        if groups <= 0 or in_channels % groups or out_channels % groups:
            raise ValueError("invalid groups for conv")
        if padding_mode not in ('zeros', 'reflect', 'replicate', 'circular'):
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        device = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * dims
        self._kernel_size = ks
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._transposed = transposed
        self._dims = dims
        w_shape = ([in_channels, out_channels // groups] if transposed
                   else [out_channels, in_channels // groups]) + ks
        fan_in = in_channels // groups * math.prod(ks)
        bound = 1.0 / math.sqrt(fan_in)

        def draw(t):
            return t.uniform_(-bound, bound, generator=generator)
        kw = dict(device=device, generator=generator, default=draw)
        self.weight = create_parameter(w_shape, weight_attr, **kw)
        self.bias = create_parameter([out_channels], bias_attr, is_bias=True,
                                     **kw)

    def _input(self, x):
        """``x`` padded by ``padding`` in ``padding_mode`` (not zeros) ->
        ``(x, padding left for the convolution)``."""
        if self._padding_mode == 'zeros':
            return x, self._padding
        n = self._dims
        last = not self._data_format.startswith('NC')
        v = to_channels_first(x, n) if last else x
        pads = norm_padding(self._padding, n, v.shape[2:], self._kernel_size,
                            [1] * n, [1] * n)
        v = TF.pad(v, torch_pad(pads), mode=self._padding_mode)
        return (to_channels_last(v, n) if last else v), 0

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCL', **kw):
        super().__init__(in_channels, out_channels, kernel_size, False, 1,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        x, pad = self._input(x)
        return F.conv1d(x, self.weight, self.bias, self._stride, pad,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW', **kw):
        super().__init__(in_channels, out_channels, kernel_size, False, 2,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        x, pad = self._input(x)
        return F.conv2d(x, self.weight, self.bias, self._stride, pad,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, False, 3,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        x, pad = self._input(x)
        return F.conv3d(x, self.weight, self.bias, self._stride, pad,
                        self._dilation, self._groups, self._data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._output_padding,
                              self._groups, self._dilation, output_size,
                              self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCL', **kw):
        super().__init__(in_channels, out_channels, kernel_size, True, 1,
                         stride, padding, output_padding, dilation, groups,
                         'zeros', weight_attr, bias_attr, data_format, **kw)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format='NCHW', **kw):
        super().__init__(in_channels, out_channels, kernel_size, True, 2,
                         stride, padding, output_padding, dilation, groups,
                         'zeros', weight_attr, bias_attr, data_format, **kw)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, True, 3,
                         stride, padding, output_padding, dilation, groups,
                         'zeros', weight_attr, bias_attr, data_format, **kw)
