"""Input encodings. Counterpart of ``paddle_tpu/nn/functional/input.py``."""
from .common import embedding, one_hot

__all__ = ['one_hot', 'embedding']
