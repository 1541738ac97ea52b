"""Convolution functionals. Counterpart of
``paddle_tpu/nn/functional/conv.py`` (``conv1d/2d/3d`` and their
transposes).

The reference lowers every convolution to ``lax.conv_general_dilated``;
the port calls ``torch.nn.functional.conv{1,2,3}d`` /
``conv_transpose{1,2,3}d``, which reach cuDNN on the card: these are XLA
code in the reference, not Pallas kernels. Paddle's forms of the
arguments:

- ``padding``: an int, one per spatial dim, one ``(lo, hi)`` pair per
  dim, a 2n-element ``[lo0, hi0, lo1, hi1, ...]`` list, or ``'SAME'`` /
  ``'VALID'`` (lax's rule: ``SAME`` pads ``max((ceil(in / s) - 1) s +
  d (k - 1) + 1 - in, 0)``, the odd element at the end). Symmetric pads
  go to torch's ``padding``; asymmetric ones through ``F.pad`` first.
- ``data_format`` ``'NLC'`` / ``'NHWC'`` / ``'NDHWC'``: the input is
  permuted to channels-first as a view (of a contiguous NHWC tensor, a
  channels-last one that cuDNN takes without a copy) and the output
  permuted back.
- Weights keep Paddle's (and torch's) layouts: (out, in / groups, k...)
  for a convolution, (in, out / groups, k...) for a transposed one.
- A transposed convolution is the reference's ``lhs_dilation`` form: the
  full ``conv_transpose`` (no padding) cropped by ``(lo, hi -
  output_padding)`` per dim (zero-filled where that grows it).
  ``output_size`` picks ``output_padding`` as upstream Paddle does (the
  reference ignores it: ROADMAP.md, Queue 3); ``groups > 1`` and a string
  padding (``'VALID'``: none; ``'SAME'``: an output of ``in * stride``)
  run as upstream defines them (the reference's ``lax`` call refuses
  both).

Under ``amp.auto_cast`` the input and weight are cast as for
``'conv2d'`` (white-listed under O1), and the bias follows the product.
"""
import torch.nn.functional as TF

from ...amp import maybe_cast_for

__all__ = ['conv1d', 'conv2d', 'conv3d', 'conv1d_transpose',
           'conv2d_transpose', 'conv3d_transpose']

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(i) for i in v)
    return v * n if len(v) == 1 else v


def same_pads(in_size, k_eff, stride):
    """lax's ``'SAME'`` pads of one dim: ``(lo, hi)``."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + k_eff - in_size, 0)
    return total // 2, total - total // 2


def norm_padding(padding, n, in_sizes, kernel, strides, dilations):
    """Paddle's padding forms -> one ``(lo, hi)`` pair a spatial dim."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == 'VALID':
            return [(0, 0)] * n
        if mode != 'SAME':
            raise ValueError(f"bad padding {padding!r}")
        return [same_pads(in_sizes[i], dilations[i] * (kernel[i] - 1) + 1,
                          strides[i]) for i in range(n)]
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(int(v) for v in p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def torch_pad(pairs):
    """``(lo, hi)`` a spatial dim, first dim first -> ``F.pad``'s list
    (last dim first)."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def to_channels_first(x, n):
    """An N...C tensor as N C... (a view)."""
    return x.permute(0, n + 1, *range(1, n + 1))


def to_channels_last(x, n):
    return x.permute(0, *range(2, n + 2), 1)


def _add_bias(out, bias):
    if bias is None:
        return out
    shape = [1] * out.dim()
    shape[1] = bias.numel()
    return out + bias.to(out.dtype).reshape(shape)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             channel_last, transpose=False, output_padding=0,
             output_size=None):
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    x, weight = maybe_cast_for('conv2d', x, weight)
    if channel_last:
        x = to_channels_first(x, n)
    k = tuple(weight.shape[2:])
    in_sizes = tuple(x.shape[2:])
    if not transpose:
        pads = norm_padding(padding, n, in_sizes, k, strides, dilations)
        if all(lo == hi for lo, hi in pads):
            out = _CONV[n](x, weight, None, strides,
                           tuple(lo for lo, _ in pads), dilations, groups)
        else:
            out = _CONV[n](TF.pad(x, torch_pad(pads)), weight, None,
                           strides, 0, dilations, groups)
    else:
        out = _conv_transpose(x, weight, strides, padding, dilations, groups,
                              n, k, in_sizes, output_padding, output_size)
    out = _add_bias(out, bias)
    return to_channels_last(out, n) if channel_last else out


def _conv_transpose(x, weight, strides, padding, dilations, groups, n, k,
                    in_sizes, output_padding, output_size):
    """The reference's transposed convolution: pads ``(d (k - 1) - lo,
    d (k - 1) - hi + output_padding)`` on the stride-dilated input, run as
    torch's full transposed convolution and a crop."""
    eff = [dilations[i] * (k[i] - 1) for i in range(n)]
    if isinstance(padding, str):
        # upstream Paddle: 'VALID' pads nothing, 'SAME' makes the output
        # in * stride (the reference's lax call refuses a string here)
        mode = padding.upper()
        pads = [(0, 0)] * n if mode == 'VALID' else [
            (t // 2, t - t // 2) for t in
            (max(eff[i] + 1 - strides[i], 0) for i in range(n))]
        lax = [(eff[i] - lo, eff[i] - hi) for i, (lo, hi) in enumerate(pads)]
    else:
        pads = norm_padding(padding, n, in_sizes, k, strides, dilations)
        opad = list(_norm_tuple(output_padding, n))
        if output_size is not None:
            # upstream Paddle: output_size picks the output padding
            want = _norm_tuple(output_size, n)
            want = want[-n:]
            for i in range(n):
                natural = (in_sizes[i] - 1) * strides[i] - pads[i][0] - \
                    pads[i][1] + eff[i] + 1
                opad[i] = int(want[i]) - natural
                if not 0 <= opad[i] < max(strides[i], dilations[i]):
                    raise ValueError(
                        f"conv_transpose: output_size {tuple(want)} is not "
                        f"reachable from input {in_sizes} (dim {i}: "
                        f"{natural} to {natural + max(strides[i], dilations[i]) - 1})")
        lax = [(eff[i] - pads[i][0], eff[i] - pads[i][1] + opad[i])
               for i in range(n)]
    crops = [(lo - eff[i], hi - eff[i]) for i, (lo, hi) in enumerate(lax)]
    sym = all(lo == hi and lo <= 0 for lo, hi in crops)
    if sym:
        return _CONV_T[n](x, weight, None, strides,
                          tuple(-lo for lo, _ in crops), 0, groups,
                          dilations)
    full = _CONV_T[n](x, weight, None, strides, 0, 0, groups, dilations)
    return TF.pad(full, torch_pad(crops))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCL'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    channel_last=data_format == 'NLC')


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    channel_last=data_format == 'NHWC')


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    channel_last=data_format == 'NDHWC')


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCL'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    channel_last=data_format == 'NLC', transpose=True,
                    output_padding=output_padding, output_size=output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCHW'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    channel_last=data_format == 'NHWC', transpose=True,
                    output_padding=output_padding, output_size=output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCDHW'):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    channel_last=data_format == 'NDHWC', transpose=True,
                    output_padding=output_padding, output_size=output_size)
