"""Common functionals. Counterpart of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``dropout`` and its channel-wise and alpha forms, ``pad``,
``interpolate``, ``bilinear``, ``cosine_similarity``, the pixel shuffles,
``unfold`` / ``fold``, ``one_hot``, ``embedding``, ``label_smooth``).

``linear`` asks ``amp.maybe_cast_for('matmul', x, w)`` first, as the
reference's does: under ``auto_cast`` (O1, or O2) ``x`` and ``w`` become
the amp dtype, and the bias is cast to the product's dtype.

The reference draws each dropout call's key from its global key chain
(``core.rng.next_key``); the port has no implicit generator: a call that
drops anything takes a ``DropoutState`` (a seed fixed from an explicit
``torch.Generator`` plus a host-side call count) and asks it for this
call's ``(seed, offset)``. The mask is the Philox mask the kernels use
(``kernels/philox.py``), in plain torch ops: this dropout is composed XLA
code in the reference too, not a Pallas kernel.
"""
import numbers

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp import maybe_cast_for
from ...kernels.philox import keep_mask

__all__ = ['linear', 'dropout', 'next_dropout_call', 'dropout2d',
           'dropout3d', 'alpha_dropout', 'pad', 'zeropad2d', 'interpolate',
           'upsample', 'bilinear', 'cosine_similarity', 'pixel_shuffle',
           'pixel_unshuffle', 'unfold', 'fold', 'one_hot', 'embedding',
           'label_smooth']


def linear(x, weight, bias=None):
    """``x W^T + b`` with ``weight`` stored (out, in), torch's layout (the
    reference stores (in, out)). Under ``auto_cast`` the product takes the
    amp dtype and the bias follows it."""
    x, weight = maybe_cast_for('matmul', x, weight)
    if bias is not None:
        bias = bias.to(torch.promote_types(x.dtype, weight.dtype))
    return torch.nn.functional.linear(x, weight, bias)


def next_dropout_call(dropout_state, p_eff, what):
    """``(seed, offset)`` of one dropout call from ``dropout_state``;
    ``(None, None)`` when nothing is dropped. Raises when something is to
    be dropped and no state was given."""
    if p_eff <= 0.0:
        return None, None
    if dropout_state is None:
        raise ValueError(
            f"{what}: dropout_p > 0 in training needs dropout_state= (a "
            "kernels.philox.DropoutState); the port draws from no implicit "
            "random generator")
    return dropout_state.next()


def dropout(x, p=0.5, training=True, dropout_state=None, shard=None, *,
            axis=None, mode='upscale_in_train'):
    """Inverted dropout: in training each element is zeroed with
    probability ``p`` and the rest divided by ``1 - p``, in ``x``'s dtype:
    the reference's ``where(keep, v / (1 - p), 0)``, whose ``1 - p`` is a
    weakly typed scalar and so takes ``x``'s dtype (0.9 becomes 0.8999 in
    fp16, 0.8984 in bf16); the quotient is rounded once. ``shard=(n,
    r)``: ``x`` is column block ``r`` of ``n`` (last dim) of the dense
    activation and draws the dense mask's block (a tensor-parallel rank's
    piece). ``axis``: one mask element for each index of these axes,
    shared along the others (``dropout2d``'s channels). ``mode=
    'downscale_in_infer'``: the kept values stay as they are in training
    and everything is scaled by ``1 - p`` in eval, as in the reference."""
    if mode not in ('upscale_in_train', 'downscale_in_infer'):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training and mode == 'downscale_in_infer':
        return x * (1 - p)
    p_eff = float(p) if training else 0.0
    if not 0.0 <= p_eff < 1.0:
        if p_eff == 1.0:
            return x * 0.0
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    seed, offset = next_dropout_call(dropout_state, p_eff, 'dropout')
    if seed is None:
        return x
    if axis is not None:
        axes = [axis] if isinstance(axis, numbers.Integral) else list(axis)
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
        keep = keep_mask(shape, p_eff, seed, offset, x.device)
    elif shard is None:
        keep = keep_mask(x.shape, p_eff, seed, offset, x.device)
    else:
        n, r = shard
        w = x.shape[-1]
        keep = keep_mask(x.shape, p_eff, seed, offset, x.device, within=(
            tuple(x.shape[:-1]) + (n * w,), (0,) * (x.dim() - 1) + (r * w,)))
    if mode == 'downscale_in_infer':
        return torch.where(keep, x, 0.0)
    kept = float(torch.tensor(1.0 - p_eff, dtype=x.dtype))
    return torch.where(keep, x / kept, 0.0)


def dropout2d(x, p=0.5, training=True, data_format='NCHW',
              dropout_state=None):
    """Whole channels dropped: one mask element a (sample, channel)."""
    axis = [0, 1] if data_format == 'NCHW' else [0, 3]
    return dropout(x, p, training, dropout_state, axis=axis)


def dropout3d(x, p=0.5, training=True, data_format='NCDHW',
              dropout_state=None):
    axis = [0, 1] if data_format == 'NCDHW' else [0, 4]
    return dropout(x, p, training, dropout_state, axis=axis)


def alpha_dropout(x, p=0.5, training=True, dropout_state=None):
    """SELU's dropout: dropped values become ``-alpha * scale`` and the
    result is rescaled to keep the mean and variance, as in the
    reference."""
    p_eff = float(p) if training else 0.0
    seed, offset = next_dropout_call(dropout_state, p_eff, 'alpha_dropout')
    if seed is None:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = keep_mask(x.shape, p_eff, seed, offset, x.device)
    return a * torch.where(keep, x, alpha_p) + b


def _pad_pairs(pad, ndim, data_format):
    """Paddle's pad list -> one ``(lo, hi)`` a dim, first dim first: 2 x
    ndim values pad every dim in order; fewer pad the spatial dims, last
    dim first (``[left, right, top, bottom, ...]``)."""
    if len(pad) == 2 * ndim:
        return [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(ndim)]
    pairs = [(0, 0)] * ndim
    last = ndim - 1 if data_format.startswith('NC') else ndim - 2
    for i in range(len(pad) // 2):
        pairs[last - i] = (int(pad[2 * i]), int(pad[2 * i + 1]))
    return pairs


def _pad_index(n, lo, hi, mode, device):
    """The source index of each padded position along a dim of ``n``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == 'reflect':
        period = 2 * (n - 1)
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - j, j)
    if mode == 'edge':
        return torch.clamp(i, 0, n - 1)
    return torch.remainder(i, n)           # circular


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW'):
    """``jnp.pad`` of the reference: ``'constant'`` (with ``value``),
    ``'reflect'`` (no edge repeat), ``'replicate'`` / ``'edge'`` and
    ``'circular'``, on any dims."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pairs = _pad_pairs(list(pad), x.dim(), data_format)
    modes = {'constant': 'constant', 'reflect': 'reflect',
             'replicate': 'edge', 'edge': 'edge', 'circular': 'wrap'}
    m = modes[mode]
    if m == 'constant':
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return TF.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, m,
                                             x.device))
    return x


def zeropad2d(x, padding, data_format='NCHW'):
    return pad(x, padding, mode='constant', value=0.0,
               data_format=data_format)


def _linear_coords(out_size, in_size, align_corners, align_mode, scale,
                   device):
    """The reference's source coordinate of each output index (fp32)."""
    if align_corners:
        if out_size == 1:
            return torch.zeros(1, device=device)
        return torch.arange(out_size, dtype=torch.float32, device=device) * \
            ((in_size - 1) / (out_size - 1))
    ratio = (in_size / out_size) if scale is None else (1.0 / scale)
    ar = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_mode == 0:
        return torch.clamp_min((ar + 0.5) * ratio - 0.5, 0)
    return ar * ratio


def _keys_cubic_weights(in_size, out_size):
    """``jax.image.resize(method='cubic')``'s weight matrix (in, out): the
    Keys kernel (a = -0.5) at half-pixel centres, widened by the scale on
    a downsample (antialiasing), each column normalised, zero outside."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f = np.float32
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * f(inv) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / \
        f(kscale)
    w = ((f(1.5) * x - f(2.5)) * x) * x + f(1.)
    w = np.where(x >= 1., ((f(-0.5) * x + f(2.5)) * x - f(4.)) * x + f(2.), w)
    w = np.where(x >= 2., f(0.), w).astype(f)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def interpolate(x, size=None, scale_factor=None, mode='nearest',
                align_corners=False, align_mode=0, data_format='NCHW'):
    """Resize the spatial dims: ``'nearest'`` (source ``floor(i * in /
    out)``), ``'linear'`` / ``'bilinear'`` / ``'trilinear'`` (Paddle's
    ``align_corners`` and ``align_mode`` coordinates, one axis at a time),
    ``'bicubic'`` (``jax.image.resize``'s cubic, as the reference calls
    it) and ``'area'`` (adaptive average pooling, upstream Paddle's; the
    reference runs it as linear: ROADMAP.md, Queue 3)."""
    nd = x.dim()
    channel_last = not data_format.startswith('NC')
    axes = list(range(1, nd - 1)) if channel_last else list(range(2, nd))
    in_sizes = [x.shape[a] for a in axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sizes = [int(s) for s in
                     (size if isinstance(size, (list, tuple)) else [size])]
        scales = [None] * len(out_sizes)
    else:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(in_sizes)
        out_sizes = [int(s * f) for s, f in zip(in_sizes, scale_factor)]
        scales = list(scale_factor)
    if mode == 'area':
        from .pooling import _AAVG
        n = len(axes)
        v = x.permute(0, nd - 1, *range(1, nd - 1)) if channel_last else x
        out = _AAVG[n](v, tuple(out_sizes))
        return out.permute(0, *range(2, nd), 1) if channel_last else out
    if mode not in ('nearest', 'linear', 'bilinear', 'trilinear', 'bicubic'):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    out = x
    for ax, osz, isz, sc in zip(axes, out_sizes, in_sizes, scales):
        if mode == 'nearest':
            idx = torch.clamp(torch.floor(
                torch.arange(osz, dtype=torch.float32, device=x.device) *
                (isz / osz)), 0, isz - 1).to(torch.int64)
            out = out.index_select(ax, idx)
        elif mode == 'bicubic':
            w = torch.from_numpy(_keys_cubic_weights(isz, osz)).to(
                device=x.device, dtype=x.dtype)
            out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
        else:
            coords = _linear_coords(osz, isz, align_corners, align_mode, sc,
                                    x.device)
            lo = torch.clamp(torch.floor(coords).to(torch.int64), 0, isz - 1)
            hi = torch.clamp(lo + 1, 0, isz - 1)
            shape = [1] * out.dim()
            shape[ax] = osz
            w = (coords - lo).to(x.dtype).reshape(shape)
            out = (1 - w) * out.index_select(ax, lo) + \
                w * out.index_select(ax, hi)
    return out


def upsample(x, size=None, scale_factor=None, mode='nearest',
             align_corners=False, align_mode=0, data_format='NCHW'):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None):
    """``y_k = x1 W_k x2^T (+ b_k)``, ``weight`` (out, in1, in2)."""
    out = torch.einsum('bi,oij,bj->bo', x1, weight, x2)
    return out if bias is None else out + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


def pixel_shuffle(x, upscale_factor, data_format='NCHW'):
    r = upscale_factor
    if data_format == 'NCHW':
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format='NCHW'):
    r = downscale_factor
    if data_format == 'NCHW':
        n, c, h, w = x.shape
        v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    v = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h // r, w // r, c * r * r)


def _two(v):
    return [v, v] if isinstance(v, int) else list(v)


def _four_pads(paddings):
    p = _two(paddings)
    return (p[0], p[0], p[1], p[1]) if len(p) == 2 else tuple(p)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: (N, C, H, W) -> (N, C * kh * kw, L); ``paddings`` one a
    spatial dim or ``[top, bottom, left, right]``."""
    pt, pb, pl, pr = _four_pads(paddings)
    v = TF.pad(x, (pl, pr, pt, pb))
    return TF.unfold(v, _two(kernel_sizes), _two(dilations), 0,
                     _two(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the inverse of ``unfold``: overlapping patches add."""
    oh, ow = _two(output_sizes)
    pt, pb, pl, pr = _four_pads(paddings)
    full = TF.fold(x, (oh + pt + pb, ow + pl + pr), _two(kernel_sizes),
                   _two(dilations), 0, _two(strides))
    return full[:, :, pt:pt + oh, pl:pl + ow]


def one_hot(x, num_classes):
    return TF.one_hot(x.to(torch.int64), num_classes).to(torch.float32)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; rows looked up at ``padding_idx`` are
    zeros (and pass no gradient), as in the reference. ``sparse`` changes
    nothing: the gradient is dense on both sides."""
    out = TF.embedding(x.to(torch.int64), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]
