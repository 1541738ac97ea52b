"""Functionals of the port. Counterpart of ``paddle_tpu/nn/functional``.

The reference re-exports the fluid-era op zoo here (its ``_FLUID_ALIASES``,
resolved lazily from ``fluid.layers``). The port has the detection names
of that list, resolved lazily from ``vision`` (which imports ``nn``, so
an eager import here would be a cycle); the other names wait for
``fluid`` (ROADMAP.md, Queue 1 item 7)."""
from . import (activation, common, conv, crf, extension, input, loss, norm,
               pooling, rnn, transformer, vision)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .crf import crf_decoding, linear_chain_crf
from .extension import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import rnn_scan
from .transformer import multi_head_attention, scaled_dot_product_attention
from .vision import *  # noqa: F401,F403

conv_transpose1d = conv1d_transpose  # noqa: F405
conv_transpose2d = conv2d_transpose  # noqa: F405
conv_transpose3d = conv3d_transpose  # noqa: F405

_FLUID_ALIASES = frozenset([
    'anchor_generator', 'bipartite_match', 'box_clip', 'box_coder',
    'box_decoder_and_assign', 'collect_fpn_proposals',
    'deformable_roi_pooling', 'density_prior_box', 'detection_output',
    'distribute_fpn_proposals', 'generate_mask_labels',
    'generate_proposal_labels', 'generate_proposals', 'iou_similarity',
    'multiclass_nms', 'polygon_box_transform', 'prior_box', 'prroi_pool',
    'psroi_pool', 'retinanet_detection_output', 'retinanet_target_assign',
    'roi_align', 'roi_perspective_transform', 'roi_pool',
    'rpn_target_assign', 'ssd_loss', 'target_assign', 'yolo_box',
    'yolov3_loss',
])

__all__ = sorted({*activation.__all__, *common.__all__, *conv.__all__,
                  *extension.__all__, *loss.__all__, *norm.__all__, *pooling.__all__,
                  *vision.__all__, 'scaled_dot_product_attention',
                  'multi_head_attention', 'rnn_scan', 'linear_chain_crf',
                  'crf_decoding', 'input', 'conv_transpose1d', 'conv_transpose2d',
                  'conv_transpose3d', *_FLUID_ALIASES})


def __getattr__(name):
    if name in _FLUID_ALIASES:
        from ... import vision as _vision
        from ...vision import ops as _ops
        return getattr(_vision, name, None) or getattr(_ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
