"""Functionals of the port. Counterpart of ``paddle_tpu/nn/functional``."""
from . import common, loss, norm, transformer
from .activation import gelu, relu
from .common import dropout
from .loss import cross_entropy
from .norm import fused_dropout_add_layer_norm, layer_norm
from .transformer import scaled_dot_product_attention

__all__ = ['gelu', 'relu', 'dropout', 'cross_entropy', 'layer_norm',
           'fused_dropout_add_layer_norm', 'scaled_dot_product_attention']
