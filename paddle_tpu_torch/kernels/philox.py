"""Counter-based dropout masks (Philox4x32-10) in plain torch integer ops.

Counterpart of ``paddle_tpu/kernels/_common.py`` (``tile_keep_scale``); the
device side is ``csrc/philox.cuh``, and the two give the same bits. The
reference seeds the TPU's hardware PRNG per tile; here the mask is keyed on
the element, so every kernel, whatever its tiling, and this module rebuild
the same mask from ``(seed, offset)`` and none is ever stored:

- key = the 64-bit ``seed``; counter = (``i // 4``, ``offset``), each as
  two 32-bit words; element ``i`` (its linear index in the tensor) takes
  word ``i % 4`` of the four output words;
- ``keep = word >= min(int(p * 2**32), 2**32 - 1)`` and kept values are
  scaled by ``1 / (1 - p)``, the reference's rule.

``DropoutState`` carries the seed (drawn once from an explicit
``torch.Generator``) and counts the calls on the host, so that drawing a
mask never waits for the device. ``next()`` folds the state's ``rank``
into the high 32 bits of the offset it hands out (the stored count stays
the call count, so a replay that sets it back draws the same masks). The
rank is 0 unless the model's gradients are averaged over a process group:
a train step that synchronises them (``sharding=`` or a ``DataParallel``
net) and ``distributed.DataParallel`` set it to the process's rank on the
data axis, so that ranks that share a seed and average their gradients
draw different masks, while the model ranks of one data replica (tensor
parallelism) draw the same. Ranks that synchronise nothing (``engine.fit(world=, rank=)``
alone) keep rank 0's masks, and with them stay equal when fed the same
batches. Rank 0's offsets, and with them a world of one, are unchanged.
All arithmetic is int64 holding 32-bit words; the 32 x 32 -> 64-bit
products are formed from 16-bit halves so that no intermediate overflows.
"""
import weakref

import torch

__all__ = ['DropoutState', 'live_states', 'philox4x32', 'threshold',
           'keep_mask', 'keep_scale', 'block_index', 'head_block']

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


class DropoutState:
    """The seed of a model's dropout masks and the count of dropout calls
    made with it. ``next()`` hands out ``(seed, offset)`` for one call and
    advances the count; setting ``offset`` back replays the same masks.
    ``rank``: the process rank folded into the offsets' high word (see the
    module docstring)."""

    def __init__(self, seed):
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.offset = 0
        self.rank = 0
        _live.add(self)

    @classmethod
    def from_generator(cls, generator):
        """Seed drawn from ``generator``, an explicit ``torch.Generator``."""
        if generator is None:
            raise ValueError(
                "DropoutState.from_generator: needs a torch.Generator; the "
                "port draws from no implicit random generator")
        draw = torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device, dtype=torch.int64)
        return cls(int(draw.item()))

    def next(self):
        offset = self.offset
        self.offset += 1
        return self.seed, offset + (self.rank << 32)

    def __repr__(self):
        return f"DropoutState(seed={self.seed}, offset={self.offset})"


# every DropoutState alive: a rematerialised forward sets their offsets back
# (nn/remat.py)
_live = weakref.WeakSet()


def live_states():
    """Every ``DropoutState`` alive now."""
    return list(_live)


def _mulhilo(a, b):
    """(high, low) 32-bit words of ``a * b``: ``a`` a Python int below
    2**32, ``b`` an int64 tensor of values below 2**32."""
    t0 = a * (b & 0xFFFF)            # below 2**48
    t1 = a * (b >> 16)               # below 2**48
    lo = (t0 + ((t1 & 0xFFFF) << 16)) & _MASK32
    hi = ((t0 >> 16) + t1) >> 16
    return hi, lo


def philox4x32(seed, offset, index4):
    """Philox4x32-10 with key ``seed`` and counter ``(index4, offset)``.
    ``index4``: int64 tensor of non-negative counters -> int64 tensor of
    shape ``index4.shape + (4,)`` holding the four 32-bit output words."""
    seed, offset = int(seed), int(offset)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    c0 = index4 & _MASK32
    c1 = (index4 >> 32) & _MASK32
    c2 = torch.full_like(index4, offset & _MASK32)
    c3 = torch.full_like(index4, (offset >> 32) & _MASK32)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack((c0, c1, c2, c3), dim=-1)


def threshold(p):
    """The 32-bit word below which an element is dropped."""
    return min(int(p * 4294967296.0), 4294967295)


def block_index(full_shape, starts, shape, device=None):
    """The row-major linear indices in a tensor of ``full_shape`` of the
    block of ``shape`` that starts at ``starts`` -> int64 of ``shape``."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(full_shape))):
        pos = torch.arange(int(starts[d]), int(starts[d]) + int(shape[d]),
                           dtype=torch.int64, device=device) * stride
        idx = idx + pos.reshape((-1,) + (1,) * (len(full_shape) - 1 - d))
        stride *= int(full_shape[d])
    return idx.expand(tuple(int(s) for s in shape))


def keep_mask(shape, p, seed, offset, device=None, within=None):
    """Boolean keep mask of ``shape``: element ``i`` (row-major) is kept
    where its Philox word is ``>= threshold(p)``. ``within=(full_shape,
    starts)``: the tensor is the block of a ``full_shape`` tensor that
    starts at ``starts``, and each element takes the word of its index
    there (a tensor-parallel rank's piece draws the dense model's mask)."""
    if within is not None:
        idx = block_index(within[0], within[1], shape, device)
        words = philox4x32(seed, offset, idx >> 2)
        word = words.gather(-1, (idx & 3).unsqueeze(-1)).squeeze(-1)
        return word >= threshold(p)
    n = 1
    for s in shape:
        n *= int(s)
    index4 = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32(seed, offset, index4).reshape(-1)[:n]
    return (words >= threshold(p)).reshape(tuple(shape))


def head_block(shape, head_map):
    """``keep_mask``'s ``within`` for (B, H, ...) probabilities that hold
    heads ``h0 .. h0 + H - 1`` of a model of ``heads`` heads (``head_map
    = (heads, h0)``; None: the tensor's own)."""
    if head_map is None:
        return None
    heads, h0 = head_map
    full = (shape[0], int(heads)) + tuple(shape[2:])
    return full, (0, int(h0)) + (0,) * (len(shape) - 2)


def keep_scale(shape, p, seed, offset, device=None, dtype=torch.float32,
               within=None):
    """``keep / (1 - p)`` as a ``dtype`` tensor of ``shape``."""
    keep = keep_mask(shape, p, seed, offset, device, within)
    return keep.to(dtype) * (1.0 / (1.0 - p))
