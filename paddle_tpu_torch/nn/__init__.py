"""Neural-network layers and functionals of the port. Counterpart of
``paddle_tpu/nn``; the layers are ``torch.nn.Module``s. Also here:
gradient clips (``clip``), regularizers (``regularizer``), ``ParamAttr``
(``initializer``) and rematerialisation (``remat``)."""
from . import clip, functional, initializer, regularizer, remat
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .initializer import ParamAttr
from .layer import (GELU, Dropout, Embedding, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, Sequential,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ['functional', 'clip', 'initializer', 'regularizer', 'remat',
           'ClipGradByGlobalNorm', 'ClipGradByNorm', 'ClipGradByValue',
           'clip_grad_norm_', 'ParamAttr', 'GELU', 'Dropout', 'Embedding',
           'LayerList', 'LayerNorm', 'Linear', 'MultiHeadAttention',
           'RMSNorm', 'Sequential', 'TransformerEncoder',
           'TransformerEncoderLayer']
