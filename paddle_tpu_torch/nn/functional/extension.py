"""Extension ops: the sequence ops on dense padded tensors, ``diag_embed``,
``temporal_shift`` and ``gather_tree``. Counterpart of
``paddle_tpu/nn/functional/extension.py``.

As in the reference, a ragged (LoD) batch is a dense (B, T, ...) tensor
with its lengths (B,) beside it, and each ``sequence_*`` op takes
``length`` in place of the LoD levels. ``sequence_mask(maxlen=None)`` and
``sequence_expand`` read their sizes on the host, as the reference's
eager path does; every other op runs on the tensor's device with no host
read.
"""
import torch

__all__ = ['diag_embed', 'sequence_mask', 'temporal_shift', 'sequence_pool',
           'sequence_softmax', 'sequence_pad', 'sequence_unpad',
           'sequence_expand', 'sequence_reverse', 'sequence_concat',
           'gather_tree']


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """The last axis of ``input`` on the ``offset`` diagonal of a new
    square pair of axes, placed at ``dim1`` and ``dim2``."""
    return torch.diag_embed(input, offset=offset, dim1=dim1, dim2=dim2)


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    """Lengths -> a (..., maxlen) mask of ``dtype``; ``maxlen=None`` takes
    ``x.max()`` (one host read)."""
    if maxlen is None:
        maxlen = int(x.max())
    elif isinstance(maxlen, torch.Tensor):
        maxlen = int(maxlen.item())
    steps = torch.arange(maxlen, device=x.device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return (steps < x[..., None]).to(dtype)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format='NCHW',
                   name=None):
    """TSM: the first ``shift_ratio`` of the channels take the next
    segment's values, the next ``shift_ratio`` the previous segment's."""
    if data_format == 'NHWC':
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    pad = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([pad[:, 2:, :c1], pad[:, :-2, c1:c2], v[:, :, c2:]],
                    dim=2).reshape(nt, c, h, w)
    if data_format == 'NHWC':
        out = out.permute(0, 2, 3, 1)
    return out


def _length_mask(v, length, dtype):
    """(B, T) mask of the valid steps, shaped to broadcast over ``v``."""
    mask = (torch.arange(v.shape[1], device=v.device)
            < length.to(v.device)[:, None]).to(dtype)
    return mask.reshape(mask.shape + (1,) * (v.dim() - 2))


def sequence_pool(x, pool_type, length=None, pad_value=0.0):
    """Pool each sequence of (B, T, ...) over its valid steps: ``sum``,
    ``average``, ``sqrt`` (sum over the root of the length), ``max``,
    ``first`` or ``last``. An empty sequence (length 0) pools to
    ``pad_value``, as upstream Paddle's ``sequence_pool`` pads it (the
    reference accepts ``pad_value`` and never uses it)."""
    pool_type = pool_type.lower()
    if length is None:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
    mask = _length_mask(x, length, x.dtype)
    cnt = length.to(x.device, x.dtype).clamp_min(1.0).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if pool_type == 'sum':
        out = (x * mask).sum(1)
    elif pool_type in ('average', 'avg', 'mean'):
        out = (x * mask).sum(1) / cnt
    elif pool_type == 'sqrt':
        out = (x * mask).sum(1) / cnt.sqrt()
    elif pool_type == 'max':
        out = torch.where(mask > 0, x, torch.full_like(x, -1e30)).amax(1)
    elif pool_type == 'first':
        out = x[:, 0]
    elif pool_type == 'last':
        idx = (length.to(x.device, torch.int64) - 1).clamp_min(0)
        idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
            (-1, 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx)[:, 0]
    else:
        raise ValueError(pool_type)
    empty = (length.to(x.device) == 0).reshape(
        (-1,) + (1,) * (out.dim() - 1))
    return torch.where(empty, torch.full_like(out, pad_value), out)


def sequence_softmax(x, length=None, axis=1):
    """Softmax over each sequence's valid steps; the padded steps are 0."""
    if length is None:
        return torch.softmax(x, dim=axis)
    mask = _length_mask(x, length, x.dtype)
    logits = torch.where(mask > 0, x, torch.full_like(x, -1e30))
    return torch.softmax(logits, dim=axis) * mask


def sequence_pad(x, pad_value, maxlen=None, length=None):
    """-> (``x`` padded along time to ``maxlen`` with ``pad_value``,
    ``length``); the batch is already dense."""
    if maxlen is None:
        return x, length
    if isinstance(pad_value, torch.Tensor):
        pad_value = pad_value.item()
    pad = [0, 0] * (x.dim() - 2) + [0, maxlen - x.shape[1]]
    return torch.nn.functional.pad(x, pad, value=pad_value), length


def sequence_unpad(x, length):
    """``x`` with the steps past each ``length`` zeroed (the dense form)."""
    return x * _length_mask(x, length, x.dtype)


def sequence_expand(x, y_lengths, ref_level=0):
    """Row ``i`` of ``x`` repeated ``y_lengths[i]`` times (the counts read
    on the host)."""
    reps = torch.as_tensor(y_lengths).to('cpu', torch.int64)
    idx = torch.repeat_interleave(torch.arange(len(reps)), reps)
    return x[idx.to(x.device)]


def sequence_reverse(x, length=None):
    """Each sequence's valid steps reversed in place; padding stays."""
    if length is None:
        return torch.flip(x, dims=[1])
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    ln = length.to(x.device, torch.int64)[:, None]
    rev = torch.where(pos < ln, ln - 1 - pos, pos)
    rev = rev.reshape(rev.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, rev)


def sequence_concat(inputs, lengths=None):
    """The inputs concatenated along time (the dense form)."""
    return torch.cat(list(inputs), dim=1)


def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids``, ``parents`` (T, B, W) -> the
    (T, B, W) token sequences, each beam followed from its last step back
    through its parents (T small gathers on the device)."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        index = beams.to(torch.int64)
        out[t] = torch.gather(ids[t], 1, index)
        beams = torch.gather(parents[t], 1, index)
    return out
