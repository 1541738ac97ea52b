"""Pooling functionals. Counterpart of
``paddle_tpu/nn/functional/pooling.py`` (max and average pooling in 1-3
D, the adaptive pools, ``global_pool``).

The reference lowers pooling to ``lax.reduce_window``; the port calls
torch's pooling ops on the card (XLA code in the reference, not Pallas).
Its arithmetic, kept here:

- ``padding``: an int or one per spatial dim (symmetric), or ``'SAME'`` /
  ``'VALID'`` (lax's rule, the odd element at the end).
- ``ceil_mode`` widens each dim's right padding until the windows tile
  the padded input (``(in + lo + hi - k) % s`` short of a stride).
- A max pool pads with -inf (the dtype's least integer for integers); an
  average pool with zeros, and divides the window's sum by
  ``divisor_override``, else, with ``exclusive`` and an explicit padding
  that is not all zero, by the count of real elements in the window, else
  by the window's size (a string padding divides by the window's size).
- The adaptive pools' bins run from ``floor(j in / out)`` to ``ceil((j +
  1) in / out)``, torch's own bins.
- ``return_mask``: each output's argmax as a flat index into its input
  plane (``h * W + w``), as upstream Paddle returns it; the reference
  returns zeros (ROADMAP.md, Queue 3).

Symmetric pads within half a window, and no ``ceil_mode`` widening, go to
torch's own ``padding`` (ResNet's 3x3/2 max pool); other pads through
``F.pad`` first. ``data_format`` N...C permutes to channels-first as a
view and back.
"""
import math

import torch
import torch.nn.functional as TF

from .conv import same_pads, to_channels_first, to_channels_last, torch_pad

__all__ = ['avg_pool1d', 'avg_pool2d', 'avg_pool3d', 'max_pool1d',
           'max_pool2d', 'max_pool3d', 'adaptive_avg_pool1d',
           'adaptive_avg_pool2d', 'adaptive_avg_pool3d',
           'adaptive_max_pool1d', 'adaptive_max_pool2d',
           'adaptive_max_pool3d', 'global_pool']

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}
_AMAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
         3: TF.adaptive_max_pool3d}
_AAVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
         3: TF.adaptive_avg_pool3d}


def _norm(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(i) for i in v)
    return v * n if len(v) == 1 else v


def _pads(x, k, s, padding, n, ceil_mode):
    """-> ``(one (lo, hi) a spatial dim, explicit)``; ``explicit`` is False
    for a string padding (which takes no ``ceil_mode`` widening, as in the
    reference)."""
    sizes = x.shape[2:]
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == 'VALID':
            return [(0, 0)] * n, False
        return [same_pads(sizes[i], k[i], s[i]) for i in range(n)], False
    pads = [(p, p) for p in _norm(padding, n)]
    if ceil_mode:
        for i in range(n):
            lo, hi = pads[i]
            rem = (sizes[i] + lo + hi - k[i]) % s[i]
            if rem:
                pads[i] = (lo, hi + s[i] - rem)
    return pads, True


def _torch_padding(pads, k):
    """The pads as torch pooling's own ``padding`` where it takes them:
    symmetric and at most half the window."""
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _flat_index(idx, pads, in_sizes, padded_sizes):
    """Flat argmax indices into a padded plane -> into the unpadded one."""
    coords = []
    rest = idx
    for size in reversed(padded_sizes):
        coords.append(rest % size)
        rest = rest // size
    coords.reverse()
    out = torch.zeros_like(idx)
    for c, (lo, _), size in zip(coords, pads, in_sizes):
        out = out * size + (c - lo)
    return out


def _max_pool(x, kernel, stride, padding, n, channel_last, ceil_mode,
              return_mask):
    k = _norm(kernel, n)
    s = _norm(stride if stride is not None else kernel, n)
    if channel_last:
        x = to_channels_first(x, n)
    pads, _ = _pads(x, k, s, padding, n, ceil_mode)
    own = _torch_padding(pads, k)
    if own is not None and not return_mask:
        out = _MAX[n](x, k, s, own)
        return to_channels_last(out, n) if channel_last else out
    fill = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    xp = TF.pad(x, torch_pad(pads), value=fill)
    if return_mask:
        out, idx = _MAX[n](xp, k, s, 0, return_indices=True)
        idx = _flat_index(idx, pads, x.shape[2:], xp.shape[2:])
        if channel_last:
            return to_channels_last(out, n), to_channels_last(idx, n)
        return out, idx
    out = _MAX[n](xp, k, s, 0)
    return to_channels_last(out, n) if channel_last else out


def _window_sum(x, k, s, n):
    """The sum over each window (no padding) of an N C ... tensor."""
    if n == 1:
        return TF.avg_pool2d(x.unsqueeze(2), (1,) + k, (1,) + s,
                             divisor_override=1).squeeze(2)
    return _AVG[n](x, k, s, divisor_override=1)


def _avg_pool(x, kernel, stride, padding, n, channel_last, ceil_mode,
              exclusive, divisor_override=None):
    k = _norm(kernel, n)
    s = _norm(stride if stride is not None else kernel, n)
    if channel_last:
        x = to_channels_first(x, n)
    pads, explicit = _pads(x, k, s, padding, n, ceil_mode)
    padded = any(p != (0, 0) for p in pads)
    summed = _window_sum(TF.pad(x, torch_pad(pads)) if padded else x, k, s, n)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and explicit and padded:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = summed / _window_sum(TF.pad(ones, torch_pad(pads)), k, s, n)
    else:
        out = summed / float(math.prod(k))
    return to_channels_last(out, n) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCL'):
    return _max_pool(x, kernel_size, stride, padding, 1,
                     data_format == 'NLC', ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCHW'):
    return _max_pool(x, kernel_size, stride, padding, 2,
                     data_format == 'NHWC', ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCDHW'):
    return _max_pool(x, kernel_size, stride, padding, 3,
                     data_format == 'NDHWC', ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format='NCL'):
    return _avg_pool(x, kernel_size, stride, padding, 1,
                     data_format == 'NLC', ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCHW'):
    return _avg_pool(x, kernel_size, stride, padding, 2,
                     data_format == 'NHWC', ceil_mode, exclusive,
                     divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCDHW'):
    return _avg_pool(x, kernel_size, stride, padding, 3,
                     data_format == 'NDHWC', ceil_mode, exclusive,
                     divisor_override)


def _adaptive(x, output_size, n, channel_last, kind, return_mask=False):
    size = tuple(None if o is None else int(o)
                 for o in _norm_sizes(output_size, n))
    if channel_last:
        x = to_channels_first(x, n)
    if kind == 'max':
        out, idx = _AMAX[n](x, size, return_indices=True)
    else:
        out, idx = _AAVG[n](x, size), None
    if channel_last:
        out = to_channels_last(out, n)
        idx = None if idx is None else to_channels_last(idx, n)
    return (out, idx) if return_mask else out


def _norm_sizes(v, n):
    if v is None or isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def adaptive_avg_pool1d(x, output_size):
    return _adaptive(x, output_size, 1, False, 'avg')


def adaptive_avg_pool2d(x, output_size, data_format='NCHW'):
    return _adaptive(x, output_size, 2, data_format == 'NHWC', 'avg')


def adaptive_avg_pool3d(x, output_size, data_format='NCDHW'):
    return _adaptive(x, output_size, 3, data_format == 'NDHWC', 'avg')


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 1, False, 'max', return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 2, False, 'max', return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 3, False, 'max', return_mask)


def global_pool(x, kind='avg', data_format='NCHW'):
    """The mean (``kind='avg'``) or max over the spatial axes, kept as
    size-1 axes."""
    axes = tuple(range(2, x.dim())) if data_format.startswith('NC') \
        else tuple(range(1, x.dim() - 1))
    if kind == 'avg':
        return x.mean(dim=axes, keepdim=True)
    return x.amax(dim=axes, keepdim=True)
