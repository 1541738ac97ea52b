"""Common layers. Counterpart of ``paddle_tpu/nn/layer/common.py``
(``Linear``, ``Embedding``, ``Identity``, ``Flatten``, the dropouts, the
pads, ``Upsample``, ``CosineSimilarity``, the pixel shuffles,
``Bilinear``, ``Unfold`` / ``Fold``).

``weight_attr=`` / ``bias_attr=`` take a ``nn.initializer.ParamAttr`` (its
initializer, learning rate, regularizer, ``trainable`` and ``need_clip``),
an ``Initializer``, a name, or None; ``bias_attr=False`` builds no bias,
as in the reference.

Without an initializer the layers follow the reference's defaults —
Xavier-uniform ``Linear`` weights, zero biases (or the global bias
initializer, ``nn.initializer.set_global_initializer``), Normal(0, std)
embeddings — and every draw comes from the ``generator`` passed in (the
device's default generator when it is None). ``Dropout`` draws from no generator at call time: it asks the
``DropoutState`` (``kernels/philox.py``) it was given for each call's
``(seed, offset)``. A model creates one state and hands it to every layer
that drops, so no two calls of a run see the same mask; a layer without
one raises when it is first asked to drop anything.
"""
import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import create_parameter

__all__ = ['Linear', 'Embedding', 'Dropout', 'Identity', 'Flatten',
           'Dropout2D', 'Dropout3D', 'AlphaDropout', 'Upsample',
           'UpsamplingNearest2D', 'UpsamplingBilinear2D', 'Pad1D', 'Pad2D',
           'Pad3D', 'ZeroPad2D', 'CosineSimilarity', 'PixelShuffle',
           'PixelUnshuffle', 'Bilinear', 'Unfold', 'Fold']


class Linear(nn.Module):
    """``y = x W^T + b`` through ``F.linear`` (so under ``amp.auto_cast``
    the product takes the amp dtype). ``weight`` is stored (out_features,
    in_features) as in ``torch.nn.Linear`` — the transpose of the
    reference's (in, out); ``interop.load_paddle_tpu_state`` transposes on
    load."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        # the initializer sees the reference's (in, out) layout
        self.weight = create_parameter(
            (in_features, out_features), weight_attr, device=device,
            generator=generator, transpose=True,
            default=lambda w: w.uniform_(-limit, limit, generator=generator))
        self.bias = create_parameter((out_features,), bias_attr,
                                     device=device, generator=generator,
                                     is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup into a (num_embeddings, embedding_dim) table initialised
    Normal(0, ``std``)."""

    def __init__(self, num_embeddings, embedding_dim, std=1.0, *,
                 weight_attr=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr, device=device,
            generator=generator,
            default=lambda w: w.normal_(0.0, std, generator=generator))

    def forward(self, x):
        return torch.nn.functional.embedding(x, self.weight)


class Dropout(nn.Module):
    """Inverted dropout with the Philox mask of ``dropout_state``, the
    ``DropoutState`` of the model this layer belongs to. Without one the
    layer passes its input through in eval mode and at ``p = 0``, and
    raises when training asks it to drop. ``axis`` / ``mode``: as
    ``F.dropout``'s."""

    def __init__(self, p=0.5, axis=None, mode='upscale_in_train', *,
                 dropout_state=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.dropout_state = dropout_state
        # (n, r): the input is column block r of n of the dense activation
        # (tensor parallelism), whose mask it draws (F.dropout's shard)
        self.shard = None

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.dropout_state,
                         shard=self.shard, axis=self.axis, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format='NCHW', name=None, *,
                 dropout_state=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.dropout_state = dropout_state

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format,
                           self.dropout_state)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format='NCDHW', name=None, *,
                 dropout_state=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.dropout_state = dropout_state

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format,
                           self.dropout_state)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None, *, dropout_state=None):
        super().__init__()
        self.p = p
        self.dropout_state = dropout_state

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training, self.dropout_state)


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=False, align_mode=0, data_format='NCHW',
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'nearest', False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'bilinear', True, 0,
                         data_format)


class _PadNd(nn.Module):
    _n = 0

    def __init__(self, padding, mode='constant', value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self._pad = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * (2 * self._n)
        self._mode, self._value = mode, value
        self._data_format = data_format or self._format

    def forward(self, x):
        return F.pad(x, self._pad, self._mode, self._value,
                     self._data_format)


class Pad1D(_PadNd):
    _n, _format = 1, 'NCL'


class Pad2D(_PadNd):
    _n, _format = 2, 'NCHW'


class Pad3D(_PadNd):
    _n, _format = 3, 'NCDHW'


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format='NCHW', name=None):
        super().__init__(padding, 'constant', 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self._axis, eps=self._eps)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format='NCHW', name=None):
        super().__init__()
        self._factor, self._data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._factor, self._data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format='NCHW', name=None):
        super().__init__()
        self._factor, self._data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class Bilinear(nn.Module):
    """``F.bilinear`` with a (out, in1, in2) weight (Xavier-uniform, as the
    reference's default over that shape) and a zero bias."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr, **kw)
        self.bias = create_parameter((out_features,), bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)
