"""Functionals of the port. Counterpart of ``paddle_tpu/nn/functional``."""
from . import common, loss, norm, transformer
from .activation import gelu, relu
from .common import dropout, linear
from .loss import cross_entropy
from .norm import fused_dropout_add_layer_norm, layer_norm, rms_norm
from .transformer import scaled_dot_product_attention

__all__ = ['gelu', 'relu', 'linear', 'dropout', 'cross_entropy',
           'layer_norm', 'rms_norm', 'fused_dropout_add_layer_norm',
           'scaled_dot_product_attention']
