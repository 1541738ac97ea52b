"""Common layers. Counterpart of ``paddle_tpu/nn/layer/common.py``
(``Linear``, ``Embedding``, ``Dropout``).

Initialisers follow the reference's distributions — Xavier-uniform
``Linear`` weights with zero biases, Normal(0, std) embeddings — and draw
from the ``generator`` passed in (the device's default generator when it
is None).
"""
import math

import torch
from torch import nn

from ...device import resolve_device

__all__ = ['Linear', 'Embedding', 'Dropout']


class Linear(nn.Module):
    """``y = x W^T + b``. ``weight`` is stored (out_features, in_features)
    as in ``torch.nn.Linear`` — the transpose of the reference's (in, out);
    ``interop.load_paddle_tpu_state`` transposes on load."""

    def __init__(self, in_features, out_features, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-limit, limit, generator=generator)
        self.bias.zero_()

    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup into a (num_embeddings, embedding_dim) table initialised
    Normal(0, ``std``)."""

    def __init__(self, num_embeddings, embedding_dim, std=1.0, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim, device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x):
        return torch.nn.functional.embedding(x, self.weight)


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return torch.nn.functional.dropout(x, self.p, self.training)

    def extra_repr(self):
        return f"p={self.p}"
