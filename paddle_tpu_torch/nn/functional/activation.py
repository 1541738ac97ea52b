"""Activations. Counterpart of ``paddle_tpu/nn/functional/activation.py``;
plain PyTorch ops, as the reference leaves them to XLA. Each follows the
reference's formula (``hardsigmoid``'s slope 0.1666667 and offset 0.5,
``softplus``'s threshold on ``beta * x``, ``leaky_relu``'s ``x >= 0``
branch, ...). ``rrelu`` in training draws its slopes from an explicit
``generator`` (the reference from its global key chain)."""
import torch
import torch.nn.functional as TF

__all__ = ['relu', 'relu6', 'leaky_relu', 'prelu', 'elu', 'selu', 'gelu',
           'sigmoid', 'hardsigmoid', 'hardswish', 'hardshrink', 'hardtanh',
           'softshrink', 'tanhshrink', 'softplus', 'softsign', 'swish',
           'silu', 'mish', 'maxout', 'log_sigmoid', 'log_softmax', 'softmax',
           'tanh', 'thresholded_relu', 'glu', 'celu', 'rrelu', 'logsigmoid',
           'soft_relu', 'brelu']


def _dtype(x, dtype):
    if dtype is None:
        return x
    return x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format='NCHW'):
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == 'C' else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def elu(x, alpha=1.0):
    return TF.elu(x, alpha)


def celu(x, alpha=1.0):
    return TF.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def gelu(x, approximate=False):
    """GELU: the exact erf form (the reference's default, BERT's), or the
    tanh approximation."""
    return TF.gelu(x, approximate='tanh' if approximate else 'none')


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


brelu = hardtanh


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1, threshold=20):
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def soft_relu(x, threshold=40.0):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def softsign(x):
    return x / (1 + torch.abs(x))


def swish(x):
    return x * torch.sigmoid(x)


silu = swish


def mish(x):
    return x * torch.tanh(TF.softplus(x))


def maxout(x, groups, axis=1):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


def log_sigmoid(x):
    return TF.logsigmoid(x)


logsigmoid = log_sigmoid


def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_dtype(x, dtype), dim=axis)


def softmax(x, axis=-1, dtype=None):
    return torch.softmax(_dtype(x, dtype), dim=axis)


def tanh(x):
    return torch.tanh(x)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def rrelu(x, lower=1. / 8., upper=1. / 3., training=True, generator=None):
    """Randomised leaky ReLU: in training each negative element's slope is
    drawn from U(lower, upper) with ``generator``; in eval the mean
    slope."""
    if training:
        a = torch.empty_like(x).uniform_(lower, upper, generator=generator)
        return torch.where(x >= 0, x, a * x)
    return torch.where(x >= 0, x, (lower + upper) / 2. * x)
