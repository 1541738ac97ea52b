"""Vision transforms. The port's own copy of
``paddle_tpu/vision/transforms`` (numpy; the random ones draw from an
explicit generator)."""
from . import functional
from .functional import (center_crop, crop, hflip, normalize, pad, resize,
                         rotate, to_grayscale, vflip)
from .transforms import *  # noqa: F401,F403
from .transforms import __all__ as _classes

__all__ = list(_classes) + ['functional', 'resize', 'pad', 'rotate',
                            'to_grayscale', 'normalize', 'crop',
                            'center_crop', 'hflip', 'vflip', 'flip']


def flip(image, code):
    """cv2-style flip: code 0 vertical, > 0 horizontal, < 0 both."""
    if code == 0:
        return vflip(image)
    if code > 0:
        return hflip(image)
    return hflip(vflip(image))
