"""Functionals of the port. Counterpart of ``paddle_tpu/nn/functional``."""
from .activation import gelu, relu
from .norm import fused_dropout_add_layer_norm, layer_norm
from .transformer import scaled_dot_product_attention

__all__ = ['gelu', 'relu', 'layer_norm',
           'fused_dropout_add_layer_norm', 'scaled_dot_product_attention']
