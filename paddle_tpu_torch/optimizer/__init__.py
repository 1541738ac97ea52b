"""Optimizers of the port. Counterpart of ``paddle_tpu/optimizer``; this
version has ``Adam`` and ``AdamW``."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ['Optimizer', 'Adam', 'AdamW']
