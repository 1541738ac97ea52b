"""The add+LayerNorm register path and the vector mask gradient, emulated.

On the card the add+LayerNorm forward takes rows whose width is a whole
number of 16-byte chunks (G = 8 bf16 or 4 fp32 columns), at most
``kWarpRowColumns`` wide, on its register path
(``add_layer_norm_warp_kernel`` in
``paddle_tpu_torch/kernels/csrc/fused_dropout_norm.cu``, on the row routine
``norm_warp_row`` of ``csrc/norm_rows.cuh``): one warp a row, lane ``l``
holding chunks ``k * 32 + l`` (k = 0 .. K - 1) of x and the residual, and
the mask gradient takes 16-byte aligned tensors on its vector kernel
(``dropout_grad_vec_kernel``). ``chip_smoke.py`` holds both to their plain
versions on the card; this file shows on the CPU what their order of work
does (``tests/test_torch_norm_fwd_rows.py`` does the same for the
LayerNorm and RMSNorm forwards on that routine).

- The reduction order: each lane sums its chunks' fp32 sums in the
  kernel's order (chunk by chunk, column by column), then an xor-shuffle
  tree over the 32 lanes gives the mean; the centred variance the same way
  from the same registers. That order, emulated in torch, is held to the
  JAX package's Pallas ``_fwd_kernel`` (interpret mode) and to the port's
  plain version at the gates ``chip_smoke.py`` uses on the card: ``TOL``
  on every output at fp32; ``BF16_TOL`` of the max on y and yin and
  ``STAT_TOL`` on mean and rstd at bf16.
- The work maps: which Philox call and word each element takes, from
  lanes and chunks (forward), from threads, packs and the ragged tail
  (vector mask gradient), and from threads of four (scalar mask gradient).
  Each map covers every element once, and the keep mask it gives equals
  ``philox.keep_scale`` bit for bit.

The kernels' constants are read from the CUDA source, so the emulation
follows it.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, STAT_TOL, TOL
from paddle_tpu.kernels import fused_dropout_norm as jfdn
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import philox

CSRC = Path(tfdn.__file__).parent / 'csrc'
ROWS_SOURCE = (CSRC / 'norm_rows.cuh').read_text()
SOURCE = (CSRC / 'fused_dropout_norm.cu').read_text()


def _constant(name, source=SOURCE):
    return int(re.search(rf'constexpr int {name} = (\d+);', source).group(1))


ROW_WARPS = _constant('kRowWarps', ROWS_SOURCE)
ROW_COLUMNS = _constant('kWarpRowColumns', ROWS_SOURCE)
GRAD_THREADS = _constant('kGradThreads')
GRAD_PACKS = _constant('kGradPacks')
LANES = 32
P, SEED, OFFSET = 0.1, 0x1234567890ABCDEF, 5


def _chunk_width(dtype):
    """G: the columns of one 16-byte chunk."""
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _takes_register_path(d, dtype):
    return d % _chunk_width(dtype) == 0 and d <= ROW_COLUMNS


def _warp_sum(s):
    """The xor-shuffle tree over the lanes (last axis): offsets 16 .. 1."""
    lanes = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    return s


def _fma(a, b, c):
    """fp32 a * b + c rounded once, as the card's fused multiply-add: the
    product is exact in float64 (two 24-bit significands)."""
    return (a.double() * b.double() + c.double()).float()


def _lanes(v, g):
    """An (n, d) fp32 row block as the register path holds it -> (lanes
    [row, k, lane, e], valid [k, lane]): lane l's chunk k is columns
    (k * 32 + l) * G .. + G - 1, which exist where valid."""
    n, d = v.shape
    chunks = d // g
    k_chunks = -(-chunks // LANES)
    pad = torch.zeros(n, k_chunks * LANES * g)
    pad[:, :d] = v
    valid = (torch.arange(k_chunks)[:, None] * LANES
             + torch.arange(LANES)[None, :]) < chunks
    return pad.reshape(n, k_chunks, LANES, g), valid


def _lane_sum(lanes, valid, step):
    """Each lane's fp32 sum in the kernel's order, chunk by chunk and
    column by column (``step(sum, value)`` -> the next sum), then the
    xor-shuffle tree -> (n, 1)."""
    s = torch.zeros(lanes.shape[0], LANES)
    for k in range(lanes.shape[1]):
        for e in range(lanes.shape[3]):
            s = torch.where(valid[k], step(s, lanes[:, k, :, e]), s)
    return _warp_sum(s)[:, :1]


def _register_path(x, res, w, b, eps):
    """The register path at p = 0, emulated -> (y, yin, mean, rstd)."""
    d = x.shape[1]
    v = res.float() + x.float()
    lanes, valid = _lanes(v, _chunk_width(x.dtype))
    mean = _lane_sum(lanes, valid, lambda s, a: s + a) / d
    var = _lane_sum(lanes, valid,
                    lambda s, a: _fma(a - mean, a - mean, s)) / d
    rstd = torch.rsqrt(var + eps)
    y = _fma((v - mean) * rstd, w.float(), b.float())
    return y.to(x.dtype), v.to(x.dtype), mean[:, 0], rstd[:, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [768, 1024])
def test_register_path_reduction_order(dtype, d):
    assert _takes_register_path(d, dtype)
    rs = np.random.RandomState(d)
    x, res = (rs.randn(16, d).astype(np.float32) for _ in range(2))
    res = 2.0 * res + 0.5
    w = (1.0 + 0.2 * rs.randn(d)).astype(np.float32)
    b = rs.randn(d).astype(np.float32)
    tx, tres, tw, tb = (torch.from_numpy(a).to(dtype) for a in (x, res, w, b))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = jfdn._fused_fwd(*(jnp.asarray(a).astype(jdt)
                               for a in (x, res, w, b)),
                             jnp.zeros((1, 1), jnp.int32), 1e-5, 0.0, True)
    pallas = [torch.from_numpy(np.array(o.astype(jnp.float32)))
              for o in pallas]
    pallas[2:] = [o.reshape(-1) for o in pallas[2:]]       # (n, 1) stats
    plain = tfdn._plain_stats(tx, tres, tw, tb, 0.0, 1e-5, None, None)
    got = _register_path(tx, tres, tw, tb, 1e-5)
    for name, g_ in zip(('y', 'yin', 'mean', 'rstd'), got):
        assert g_.dtype == (dtype if name in ('y', 'yin') else torch.float32)
    for other, ref in (('Pallas', pallas), ('plain', plain)):
        for name, g_, r in zip(('y', 'yin', 'mean', 'rstd'), got, ref):
            err = float((g_.float() - r.float()).abs().max())
            if dtype == torch.bfloat16 and name in ('y', 'yin'):
                err /= float(r.float().abs().max())
                tol = BF16_TOL
            else:
                tol = STAT_TOL if dtype == torch.bfloat16 else TOL
            assert err <= tol, (other, name, err)


def _forward_map(n, d, dtype):
    """The register path's elements -> (linear index, Philox index4, word):
    row = block * kRowWarps + warp; lane l's chunk k is c = k * 32 + l when
    c < d / G, columns c G .. c G + G - 1; index4 = (row d / G + c) G / 4 +
    e // 4, word e % 4."""
    g = _chunk_width(dtype)
    chunks = d // g
    k_chunks = -(-chunks // LANES)
    blocks = -(-n // ROW_WARPS)
    rows = (torch.arange(blocks)[:, None] * ROW_WARPS
            + torch.arange(ROW_WARPS)[None, :]).reshape(-1)
    rows = rows[rows < n]
    c = (torch.arange(k_chunks)[:, None] * LANES
         + torch.arange(LANES)[None, :]).reshape(-1)
    c = c[c < chunks]
    e = torch.arange(g)
    linear = (rows[:, None, None] * d + c[None, :, None] * g
              + e[None, None, :])
    index4 = ((rows[:, None, None] * chunks + c[None, :, None]) * (g // 4)
              + e[None, None, :] // 4)
    word = (e % 4).expand_as(index4)
    return linear.reshape(-1), index4.reshape(-1), word.reshape(-1)


def _grad_vec_map(n, dtype, blocks):
    """The vector mask gradient's elements on a grid of ``blocks`` blocks:
    block b takes tiles b, b + blocks, ... of kGradPacks * kGradThreads
    packs, thread t the packs t0 + q kGradThreads + t below n // G; pack pk
    holds elements pk G + e, Philox index4 pk G / 4 + e // 4, word e % 4.
    Then block 0's threads take the n % G elements past the last pack, one
    each, index4 i // 4, word i % 4."""
    g = _chunk_width(dtype)
    packs = n // g
    tile = GRAD_PACKS * GRAD_THREADS
    taken = []
    for blk in range(blocks):
        for t0 in range(blk * tile, packs, blocks * tile):
            pk = (t0 + torch.arange(GRAD_PACKS)[:, None] * GRAD_THREADS
                  + torch.arange(GRAD_THREADS)[None, :]).reshape(-1)
            taken.append(pk[pk < packs])
    pk = torch.cat(taken)
    e = torch.arange(g)
    linear = (pk[:, None] * g + e[None, :]).reshape(-1)
    index4 = (pk[:, None] * (g // 4) + e[None, :] // 4).reshape(-1)
    word = (e % 4).expand(len(pk), g).reshape(-1)
    tail = packs * g + torch.arange(GRAD_THREADS)
    tail = tail[tail < n]
    return (torch.cat([linear, tail]), torch.cat([index4, tail // 4]),
            torch.cat([word, tail % 4]))


def _grad_scalar_map(n):
    """The scalar mask gradient: thread t takes elements 4 t .. 4 t + 3
    below n, index4 t, word e."""
    t = torch.arange(-(-n // 4))
    linear = (4 * t[:, None] + torch.arange(4)[None, :]).reshape(-1)
    keep = linear < n
    return (linear[keep], (linear // 4)[keep], (linear % 4)[keep])


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("forward", (9, 768), torch.bfloat16),
    ("forward", (9, 1000), torch.float32),
    ("grad vector", (37, 1023), torch.bfloat16),
    ("grad vector", (37, 1023), torch.float32),
    ("grad scalar", (37, 1023), torch.bfloat16),
], ids=["fwd-bf16-768", "fwd-fp32-1000-masked-lanes", "grad-bf16-ragged",
        "grad-fp32-ragged", "grad-scalar"])
def test_work_maps_cover_each_element_once_with_the_philox_mask(
        kernel, shape, dtype):
    n = shape[0] * shape[1]
    if kernel == "forward":
        assert _takes_register_path(shape[1], dtype)
        linear, index4, word = _forward_map(*shape, dtype)
    elif kernel == "grad vector":
        assert n % _chunk_width(dtype)          # a ragged tail
        # 3 blocks: each strides over several tiles
        linear, index4, word = _grad_vec_map(n, dtype, blocks=3)
    else:
        linear, index4, word = _grad_scalar_map(n)
    assert torch.equal(torch.bincount(linear, minlength=n),
                       torch.ones(n, dtype=torch.int64))
    assert torch.equal(4 * index4 + word, linear)
    words = philox.philox4x32(SEED, OFFSET, index4)
    bits = words.gather(1, word[:, None])[:, 0]
    scale = torch.zeros(n)
    scale[linear] = (bits >= philox.threshold(P)).float() * (1.0 / (1.0 - P))
    want = philox.keep_scale((n,), P, SEED, OFFSET)
    assert torch.equal(scale, want)
    assert 0.85 < float((want > 0).float().mean()) < 0.95
