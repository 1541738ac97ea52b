"""Transform functionals on numpy HWC images. The port's own copy of
``paddle_tpu/vision/transforms/functional.py`` (pure numpy, as the
reference's: bilinear ``resize`` on ``linspace`` coordinates, nearest
``rotate``, ``to_tensor`` scaling by 1/255 when the image's max exceeds
1.5, the colour adjustments clipped to uint8 for 0-255 images)."""
import numbers

import numpy as np

__all__ = ['to_tensor', 'resize', 'crop', 'center_crop', 'hflip', 'vflip',
           'normalize', 'pad', 'rotate', 'adjust_brightness', 'adjust_contrast',
           'adjust_saturation', 'adjust_hue', 'to_grayscale', 'transpose_img']


def _as_np(img):
    if hasattr(img, 'convert'):  # PIL
        return np.asarray(img)
    return np.asarray(img)


def to_tensor(pic, data_format='CHW'):
    img = _as_np(pic).astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.max() > 1.5:
        img = img / 255.0
    if data_format == 'CHW':
        img = img.transpose(2, 0, 1)
    return img


def _resize_np(img, size):
    """Bilinear resize HWC uint8/float numpy."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return img
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None] if img.ndim == 3 else (ys - y0)[:, None]
    wx = (xs - x0)[None, :, None] if img.ndim == 3 else (xs - x0)[None, :]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def resize(img, size, interpolation='bilinear'):
    return _resize_np(_as_np(img), size)


def crop(img, top, left, height, width):
    return _as_np(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_np(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    i = int(round((h - th) / 2.))
    j = int(round((w - tw) / 2.))
    return crop(img, i, j, th, tw)


def hflip(img):
    return _as_np(img)[:, ::-1]


def vflip(img):
    return _as_np(img)[::-1]


def normalize(img, mean, std, data_format='CHW', to_rgb=False):
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == 'CHW':
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def pad(img, padding, fill=0, padding_mode='constant'):
    img = _as_np(img)
    if isinstance(padding, int):
        pl = pr = pt = pb = padding
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    spec = [(pt, pb), (pl, pr)] + ([(0, 0)] if img.ndim == 3 else [])
    mode = {'constant': 'constant', 'edge': 'edge', 'reflect': 'reflect',
            'symmetric': 'symmetric'}[padding_mode]
    if mode == 'constant':
        return np.pad(img, spec, mode=mode, constant_values=fill)
    return np.pad(img, spec, mode=mode)


def rotate(img, angle, interpolation='nearest', expand=False, center=None,
           fill=0):
    """Nearest-neighbor rotation (pure numpy)."""
    img = _as_np(img)
    h, w = img.shape[:2]
    cy, cx = ((h - 1) / 2., (w - 1) / 2.) if center is None else center[::-1]
    a = np.deg2rad(angle)
    cos_a, sin_a = np.cos(a), np.sin(a)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = cos_a * (yy - cy) + sin_a * (xx - cx) + cy
    xs = -sin_a * (yy - cy) + cos_a * (xx - cx) + cx
    yi = np.round(ys).astype(int)
    xi = np.round(xs).astype(int)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full_like(img, fill)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def adjust_brightness(img, brightness_factor):
    img = _as_np(img).astype(np.float32)
    out = img * brightness_factor
    return np.clip(out, 0, 255).astype(np.uint8) if img.max() > 1.5 else out


def adjust_contrast(img, contrast_factor):
    img = _as_np(img).astype(np.float32)
    mean = img.mean()
    out = (img - mean) * contrast_factor + mean
    return np.clip(out, 0, 255).astype(np.uint8) if img.max() > 1.5 else out


def adjust_saturation(img, saturation_factor):
    img = _as_np(img).astype(np.float32)
    gray = img.mean(axis=-1, keepdims=True)
    out = (img - gray) * saturation_factor + gray
    return np.clip(out, 0, 255).astype(np.uint8) if img.max() > 1.5 else out


def adjust_hue(img, hue_factor):
    """Approximate hue rotation in RGB space."""
    img = _as_np(img).astype(np.float32)
    cos_h = np.cos(2 * np.pi * hue_factor)
    sin_h = np.sin(2 * np.pi * hue_factor)
    m = np.array([[0.299, 0.587, 0.114]] * 3) + \
        cos_h * (np.eye(3) - np.array([[0.299, 0.587, 0.114]] * 3)) + \
        sin_h * np.array([[0.701, -0.587, -0.114],
                          [-0.299, 0.413, -0.114],
                          [-0.299, -0.587, 0.886]])
    out = img @ m.T
    return np.clip(out, 0, 255).astype(np.uint8) if img.max() > 1.5 else out


def to_grayscale(img, num_output_channels=1):
    img = _as_np(img).astype(np.float32)
    if img.ndim == 2:
        g = img
    else:
        g = img @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
    if num_output_channels == 3:
        g = np.stack([g] * 3, axis=-1)
    else:
        g = g[..., None]
    return g.astype(np.uint8) if img.max() > 1.5 else g


def transpose_img(img, order):
    return _as_np(img).transpose(order)
