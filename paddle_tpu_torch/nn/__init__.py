"""Neural-network layers and functionals of the port. Counterpart of
``paddle_tpu/nn``; the layers are ``torch.nn.Module``s. Also here:
gradient clips (``clip``), regularizers (``regularizer``), ``ParamAttr``
(``initializer``), rematerialisation (``remat``) and the weight
reparameterisations (``utils``)."""
from . import clip, functional, initializer, layer, regularizer, remat, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .initializer import ParamAttr
from .layer import *  # noqa: F401,F403
from .utils import remove_weight_norm, spectral_norm, weight_norm

__all__ = sorted({'functional', 'clip', 'initializer', 'regularizer',
                  'remat', 'utils', 'ClipGradByGlobalNorm', 'ClipGradByNorm',
                  'ClipGradByValue', 'clip_grad_norm_', 'ParamAttr',
                  'weight_norm', 'remove_weight_norm', 'spectral_norm',
                  *layer.__all__})
