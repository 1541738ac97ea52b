"""Common layers. Counterpart of ``paddle_tpu/nn/layer/common.py``
(``Linear``, ``Embedding``, ``Dropout``).

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

__all__ = ['Linear', 'Embedding', 'Dropout']


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
    raises when training asks it to drop."""

    def __init__(self, p=0.5, *, dropout_state=None):
        super().__init__()
        self.p = p
        self.dropout_state = dropout_state
        # (n, r): the input is column block r of n of the dense activation
        # (tensor parallelism), whose mask it draws (F.dropout's shard)
        self.shard = None

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.dropout_state,
                         shard=self.shard)

    def extra_repr(self):
        return f"p={self.p}"
