"""Neural-network layers and functionals of the port. Counterpart of
``paddle_tpu/nn``; the layers are ``torch.nn.Module``s."""
from . import functional
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ['functional', 'Dropout', 'Embedding', 'LayerNorm', 'Linear',
           'MultiHeadAttention', 'TransformerEncoder',
           'TransformerEncoderLayer']
