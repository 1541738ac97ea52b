"""Resilience of the port's training. Counterpart of
``paddle_tpu/resilience``; this version has the NaN guard."""
from .nanguard import NanGuard, NanStepError

__all__ = ['NanGuard', 'NanStepError']
