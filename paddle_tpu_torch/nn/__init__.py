"""Neural-network layers and functionals of the port. Counterpart of
``paddle_tpu/nn``; the layers are ``torch.nn.Module``s. Also here:
gradient clips (``clip``), regularizers (``regularizer``), ``ParamAttr``
(``initializer``), rematerialisation (``remat``), the weight
reparameterisations (``utils``) and the decoding stack (``decode``: beam
search, ``dynamic_decode``, the helpers, and ``beam_search``,
``beam_search_decode`` and ``gather_tree``, which the reference takes from
``fluid.layers``)."""
from . import (clip, decode, functional, initializer, layer, regularizer,
               remat, utils)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .decode import *  # noqa: F401,F403
from .functional.extension import gather_tree
from .initializer import ParamAttr
from .layer import *  # noqa: F401,F403
from .utils import remove_weight_norm, spectral_norm, weight_norm

__all__ = sorted({'functional', 'clip', 'decode', 'initializer',
                  'regularizer', 'remat', 'utils', *decode.__all__,
                  'gather_tree', 'ClipGradByGlobalNorm', 'ClipGradByNorm',
                  'ClipGradByValue', 'clip_grad_norm_', 'ParamAttr',
                  'weight_norm', 'remove_weight_norm', 'spectral_norm',
                  *layer.__all__})
