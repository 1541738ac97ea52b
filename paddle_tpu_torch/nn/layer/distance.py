"""Distance layers. Counterpart of ``paddle_tpu/nn/layer/distance.py``."""
import torch
from torch import nn

__all__ = ['PairwiseDistance']


class PairwiseDistance(nn.Module):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2., epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)
