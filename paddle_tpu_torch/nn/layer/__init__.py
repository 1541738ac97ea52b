"""Layers of the port. Counterpart of ``paddle_tpu/nn/layer``."""
from .activation import GELU
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ['GELU', 'Dropout', 'Embedding', 'Linear', 'LayerList',
           'Sequential', 'LayerNorm', 'RMSNorm',
           'MultiHeadAttention', 'TransformerEncoder',
           'TransformerEncoderLayer']
