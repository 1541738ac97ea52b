"""Optimizers of the port. Counterpart of ``paddle_tpu/optimizer``; this
version has ``Adam``, ``AdamW`` and the flat-buffer ``FlatFusedUpdate``."""
from .fused import FlatFusedUpdate
from .optimizer import Adam, AdamW, Optimizer

__all__ = ['Optimizer', 'Adam', 'AdamW', 'FlatFusedUpdate']
