"""Activations the ported layers name. Counterpart of
``paddle_tpu/nn/functional/activation.py``; plain PyTorch ops, as the
reference leaves them to XLA."""
import torch

__all__ = ['gelu', 'relu']


def gelu(x):
    """GELU in the exact erf form, the reference's default (BERT's)."""
    return torch.nn.functional.gelu(x, approximate='none')


def relu(x):
    return torch.relu(x)

