"""Normalisation layers. Counterpart of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``, ``RMSNorm``, ``BatchNorm``, ``BatchNorm1D/2D/3D``,
``SyncBatchNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm``, ``SpectralNorm``).

The BatchNorms keep their running statistics in fp32 buffers named as the
reference's, ``_mean`` (zeros) and ``_variance`` (ones), with no
``num_batches_tracked``, so that ``interop.load_paddle_tpu_state`` moves a
model's state key for key; ``momentum`` weighs the old value (Paddle's
0.9, torch's 0.1). The buffers are updated in place by a training
forward; ``engine.build_train_step`` carries them in ``state['buffers']``
and keeps them when a step is skipped. ``SpectralNorm``'s power-iteration
vectors ``weight_u`` / ``weight_v`` are buffers too, drawn N(0, 1) from
``generator``.
"""
import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import create_parameter

__all__ = ['LayerNorm', 'RMSNorm', 'BatchNorm', 'BatchNorm1D', 'BatchNorm2D',
           'BatchNorm3D', 'SyncBatchNorm', 'GroupNorm', 'InstanceNorm1D',
           'InstanceNorm2D', 'InstanceNorm3D', 'LocalResponseNorm',
           'SpectralNorm']


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


def _ones(w):
    return w.fill_(1.0)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, generator=generator)
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = create_parameter([num_features], weight_attr,
                                           default=_ones, **kw)
            self.bias = create_parameter([num_features], bias_attr,
                                         is_bias=True, **kw)
        self.register_buffer('_mean', torch.zeros(num_features,
                                                  device=device))
        self.register_buffer('_variance', torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
               f"momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid-era BatchNorm, with its activation (``act``) after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype='float32',
                 data_layout='NCHW', in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats, **kw)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         'NCHW' if data_format in ('NCL', 'NC') else 'NHWC',
                         use_global_stats, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         'NCHW' if data_format == 'NCDHW' else 'NHWC',
                         use_global_stats, **kw)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose training statistics are summed over the data axis
    of the process group (``distributed.init_parallel_env``), with the
    reference's ``SyncBatchNorm`` arithmetic (the sums in the input's
    dtype, the BIASED variance into the running value). Without a group,
    and in eval, it is ``BatchNorm``, as the reference's is outside
    ``shard_map``."""

    def forward(self, x):
        from ...distributed import env
        if not self.training or not env.is_initialized():
            return super().forward(x)
        return F.norm.sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            self._momentum, self._epsilon, self._data_format)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm in it replaced by a
        ``SyncBatchNorm`` holding the same parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            dev = layer._mean.device
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon, weight_attr=False,
                                data_format=layer._data_format, device=dev)
            out.weight, out.bias = layer.weight, layer.bias
            out._mean, out._variance = layer._mean, layer._variance
            out.train(layer.training)
        for name, sub in list(layer.named_children()):
            new = cls.convert_sync_batchnorm(sub)
            if new is not sub:
                setattr(out, name, new)
        return out


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter([num_channels], weight_attr,
                                       default=_ones, **kw)
        self.bias = create_parameter([num_channels], bias_attr, is_bias=True,
                                     **kw)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=device, generator=generator)
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = create_parameter([num_features], weight_attr,
                                           default=_ones, **kw)
            self.bias = create_parameter([num_features], bias_attr,
                                         is_bias=True, **kw)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format='NCHW', name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(nn.Module):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (moved so that ``dim`` leads, flattened to a matrix) estimated by
    ``power_iters`` power iterations from the buffers ``weight_u`` /
    ``weight_v``, which each forward advances (without gradient; the
    gradient flows through the iteration, as in the reference)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype='float32', *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.register_buffer('weight_u', torch.randn(
            h, device=device, generator=generator))
        self.register_buffer('weight_v', torch.randn(
            w, device=device, generator=generator))

    def forward(self, weight):
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim], -1)
        # clones: the buffers are overwritten below, after the graph saved
        # what it read
        u, v = self.weight_u.clone(), self.weight_v.clone()
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + self._eps)
        sigma = u @ wm @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / sigma
