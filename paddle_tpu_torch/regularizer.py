"""The fluid ``regularizer`` module path. Counterpart of
``paddle_tpu/regularizer.py``."""
from .nn.regularizer import (L1Decay, L1DecayRegularizer, L2Decay,
                             L2DecayRegularizer)

__all__ = ['L1Decay', 'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer']
