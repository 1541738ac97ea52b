"""Functionals of the port. Counterpart of ``paddle_tpu/nn/functional``."""
from . import (activation, common, conv, loss, norm, pooling, transformer,
               vision)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import scaled_dot_product_attention
from .vision import *  # noqa: F401,F403

conv_transpose1d = conv1d_transpose  # noqa: F405
conv_transpose2d = conv2d_transpose  # noqa: F405
conv_transpose3d = conv3d_transpose  # noqa: F405

__all__ = sorted({*activation.__all__, *common.__all__, *conv.__all__,
                  *loss.__all__, *norm.__all__, *pooling.__all__,
                  *vision.__all__, 'scaled_dot_product_attention',
                  'conv_transpose1d', 'conv_transpose2d',
                  'conv_transpose3d'})
