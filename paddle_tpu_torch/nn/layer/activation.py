"""Activation layers. Counterpart of ``paddle_tpu/nn/layer/activation.py``:
each calls its functional with the arguments it was built with
(positional ones in the reference's order)."""
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import create_parameter

__all__ = ['ReLU', 'ReLU6', 'LeakyReLU', 'ELU', 'CELU', 'GELU', 'Sigmoid',
           'Hardsigmoid', 'Hardswish', 'Hardshrink', 'Hardtanh', 'Softplus',
           'Softshrink', 'Softsign', 'Swish', 'Silu', 'Mish', 'Tanh',
           'Tanhshrink', 'ThresholdedReLU', 'LogSigmoid', 'LogSoftmax',
           'Softmax', 'Maxout', 'GLU', 'SELU', 'PReLU', 'RReLU']

_SIGS = {
    'leaky_relu': ('negative_slope',),
    'elu': ('alpha',),
    'celu': ('alpha',),
    'gelu': ('approximate',),
    'hardshrink': ('threshold',),
    'hardtanh': ('min', 'max'),
    'hardsigmoid': ('slope', 'offset'),
    'softplus': ('beta', 'threshold'),
    'softshrink': ('threshold',),
    'thresholded_relu': ('threshold',),
    'log_softmax': ('axis',),
    'softmax': ('axis',),
    'maxout': ('groups', 'axis'),
    'glu': ('axis',),
}


def _simple(cls_name, fname):
    def __init__(self, *args, **kwargs):
        nn.Module.__init__(self)
        self._kwargs = dict(zip(_SIGS.get(fname, ()), args))
        self._kwargs.update((k, v) for k, v in kwargs.items() if k != 'name')

    def forward(self, x):
        return getattr(F, fname)(x, **self._kwargs)

    def extra_repr(self):
        return ', '.join(f'{k}={v}' for k, v in self._kwargs.items())
    return type(cls_name, (nn.Module,), {
        '__init__': __init__, 'forward': forward, 'extra_repr': extra_repr,
        '__doc__': f"``F.{fname}`` as a layer.",
        '__module__': __name__})


ReLU = _simple('ReLU', 'relu')
ReLU6 = _simple('ReLU6', 'relu6')
LeakyReLU = _simple('LeakyReLU', 'leaky_relu')
ELU = _simple('ELU', 'elu')
CELU = _simple('CELU', 'celu')
GELU = _simple('GELU', 'gelu')
Sigmoid = _simple('Sigmoid', 'sigmoid')
Hardsigmoid = _simple('Hardsigmoid', 'hardsigmoid')
Hardswish = _simple('Hardswish', 'hardswish')
Hardshrink = _simple('Hardshrink', 'hardshrink')
Hardtanh = _simple('Hardtanh', 'hardtanh')
Softplus = _simple('Softplus', 'softplus')
Softshrink = _simple('Softshrink', 'softshrink')
Softsign = _simple('Softsign', 'softsign')
Swish = _simple('Swish', 'swish')
Silu = _simple('Silu', 'silu')
Mish = _simple('Mish', 'mish')
Tanh = _simple('Tanh', 'tanh')
Tanhshrink = _simple('Tanhshrink', 'tanhshrink')
ThresholdedReLU = _simple('ThresholdedReLU', 'thresholded_relu')
LogSigmoid = _simple('LogSigmoid', 'log_sigmoid')
LogSoftmax = _simple('LogSoftmax', 'log_softmax')
Softmax = _simple('Softmax', 'softmax')
Maxout = _simple('Maxout', 'maxout')
GLU = _simple('GLU', 'glu')
SELU = _simple('SELU', 'selu')


class PReLU(nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            [num_parameters], weight_attr, device=resolve_device(device),
            generator=generator, default=lambda w: w.fill_(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class RReLU(nn.Module):
    """``F.rrelu``; training draws from ``generator`` (an explicit
    ``torch.Generator`` on the input's device)."""

    def __init__(self, lower=1. / 8., upper=1. / 3., name=None, *,
                 generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training,
                       generator=self.generator)
