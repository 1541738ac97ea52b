"""The LayerNorm and RMSNorm forwards' register path, emulated.

On the card the LayerNorm and RMSNorm forwards take rows whose width is a
whole number of 16-byte chunks (G = 8 bf16 or 4 fp32 columns), at most
``kWarpRowColumns`` wide, with every pointer 16-byte aligned, on their
register path (``ln_rows_warp_kernel``, ``rms_rows_warp_kernel`` in
``paddle_tpu_torch/kernels/csrc/fused_norm.cu``, on the row routine
``norm_warp_row`` of ``csrc/norm_rows.cuh``): one warp a row, lane ``l``
holding chunks ``k * 32 + l`` of x. ``chip_smoke.py`` holds both to their
plain versions on the card; this file shows on the CPU what their order of
work does, as ``tests/test_torch_norm_rows.py`` does for the add+LayerNorm.

- The reduction order: each lane sums its chunks in the kernel's order
  (chunk by chunk, column by column), then an xor-shuffle tree over the 32
  lanes. LayerNorm: the mean, then the centred variance from the same
  registers; RMSNorm: the sum of squares. Each emulation is held to the
  JAX package's Pallas ``_ln_fwd_kernel`` / ``_rms_fwd_kernel`` (interpret
  mode) and to the port's plain versions (``layer_norm_stats``,
  ``rms_norm_stats``) at ``chip_smoke.py``'s gates: ``TOL`` on every
  output at fp32; ``BF16_TOL`` of the max on y and ``STAT_TOL`` on the
  statistics at bf16. Widths 768, 1000 (at bf16 125 chunks: the last
  round masked past lane 28) and 1024, with and without weight and bias.
- The route: the rule ``dispatch_ln`` / ``dispatch_rms`` apply, read from
  the source, and the kernel it gives each norm shape ``chip_smoke.py``
  drives (``LN_ROUTES``, ``RMS_ROUTES``), at fp32 and bf16.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import BF16_TOL, STAT_TOL, TOL
from paddle_tpu.kernels import fused_norm as jfn
from paddle_tpu_torch.kernels import fused_norm as tfn
from test_torch_norm_rows import (CSRC, ROW_COLUMNS, _chunk_width, _fma,
                                  _lane_sum, _lanes)

NORM_SOURCE = (CSRC / 'fused_norm.cu').read_text()
ROWS = 16
DTYPES = {'fp32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16)}
LN_EPS, RMS_EPS = 1e-12, 1e-6


def _layer_norm_rows(x, w, b, eps):
    """``ln_rows_warp_kernel``, emulated -> (y, mean, rstd)."""
    d = x.shape[1]
    v = x.float()
    lanes, valid = _lanes(v, _chunk_width(x.dtype))
    mean = _lane_sum(lanes, valid, lambda s, a: s + a) / d
    var = _lane_sum(lanes, valid,
                    lambda s, a: _fma(a - mean, a - mean, s)) / d
    rstd = torch.rsqrt(var + eps)
    y = (v - mean) * rstd
    # u *= w; u += b: contracted into one fused multiply-add when both
    if w is not None and b is not None:
        y = _fma(y, w.float(), b.float())
    elif w is not None:
        y = y * w.float()
    elif b is not None:
        y = y + b.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def _rms_norm_rows(x, w, eps):
    """``rms_rows_warp_kernel``, emulated -> (y, rstd)."""
    d = x.shape[1]
    v = x.float()
    lanes, valid = _lanes(v, _chunk_width(x.dtype))
    rstd = torch.rsqrt(_lane_sum(lanes, valid, lambda s, a: _fma(a, a, s))
                       / d + eps)
    y = v * rstd
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype), rstd[:, 0]


def _inputs(d, with_w, with_b):
    rs = np.random.RandomState(d + 2 * with_w + with_b)
    x = (2.0 * rs.randn(ROWS, d) + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rs.randn(d)).astype(np.float32) if with_w else None
    b = rs.randn(d).astype(np.float32) if with_b else None
    return x, w, b


def _gate(got, want, dtype, names):
    """Each output against ``want`` at chip_smoke.py's gates."""
    for name, g, r in zip(names, got, want):
        err = float((g.float() - r.float()).abs().max())
        if dtype == torch.bfloat16 and name == 'y':
            err /= float(r.float().abs().max())
            tol = BF16_TOL
        else:
            tol = STAT_TOL if dtype == torch.bfloat16 else TOL
        assert err <= tol, (name, err)


def _to_jax(a, jdt):
    return None if a is None else jnp.asarray(a).astype(jdt)


def _from_jax(outs):
    """Pallas outputs -> float32 torch tensors, (n, 1) statistics flat."""
    return [torch.from_numpy(np.array(o.astype(jnp.float32))).reshape(
        (ROWS, -1) if i == 0 else (-1,)) for i, o in enumerate(outs)]


@pytest.mark.parametrize("affine", ["w+b", "w", "none"])
@pytest.mark.parametrize("d", [768, 1000, 1024])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_layer_norm_register_path_order(dt, d, affine):
    dtype, jdt = DTYPES[dt]
    x, w, b = _inputs(d, affine != "none", affine == "w+b")
    tx, tw, tb = (None if a is None else torch.from_numpy(a).to(dtype)
                  for a in (x, w, b))
    got = _layer_norm_rows(tx, tw, tb, LN_EPS)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    pallas = _from_jax(jfn._ln_forward(_to_jax(x, jdt), _to_jax(w, jdt),
                                       _to_jax(b, jdt), LN_EPS, True))
    plain = tfn.layer_norm_stats(tx, tw, tb, LN_EPS)
    for want in (pallas, plain):
        _gate(got, want, dtype, ('y', 'mean', 'rstd'))


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "none"])
@pytest.mark.parametrize("d", [768, 1000, 1024])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rms_norm_register_path_order(dt, d, weighted):
    dtype, jdt = DTYPES[dt]
    x, w, _ = _inputs(d, weighted, False)
    tx = torch.from_numpy(x).to(dtype)
    tw = None if w is None else torch.from_numpy(w).to(dtype)
    got = _rms_norm_rows(tx, tw, RMS_EPS)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    pallas = _from_jax(jfn._rms_forward(_to_jax(x, jdt), _to_jax(w, jdt),
                                        RMS_EPS, True))
    plain = tfn.rms_norm_stats(tx, tw, RMS_EPS)
    for want in (pallas, plain):
        _gate(got, want, dtype, ('y', 'rstd'))


def _dispatch(name):
    """The body of ``dispatch_<name>`` in fused_norm.cu."""
    m = re.search(rf'\nint dispatch_{name}\(.*?\n}}\n', NORM_SOURCE, re.S)
    assert m, f'dispatch_{name} not found'
    return m.group(0)


# what each dispatch checks, in order, and the kernel each branch launches
RULES = {'ln': ('{x, w, b, y}', 'launch_ln', 'ln_rows_warp_kernel',
                'layer_norm_fwd_kernel'),
         'rms': ('{x, w, y}', 'launch_rms', 'rms_rows_warp_kernel',
                 'rms_norm_fwd_kernel')}


@pytest.mark.parametrize("kernel", ["ln", "rms"])
def test_route_rule_from_source_gives_chip_smoke_routes(kernel):
    pointers, block_launch, warp_kernel, block_kernel = RULES[kernel]
    body = _dispatch(kernel)
    # unaligned or ragged -> the block path, element by element; wider
    # than kWarpRowColumns -> the block path, 16 bytes a step; else the
    # register path at row_chunks<T>(d) chunks a lane
    rule = (rf'if \(!rows_vectorise<T>\(d, {re.escape(pointers)}\)\)\s*'
            rf'return {block_launch}<T, false>.*?'
            rf'if \(d > kWarpRowColumns\)\s*'
            rf'return {block_launch}<T, true>.*?'
            rf'dispatch_row_chunks<T>\(row_chunks<T>\(d\).*?{warp_kernel}')
    assert re.search(rule, body, re.S), body
    assert block_kernel in NORM_SOURCE and warp_kernel in NORM_SOURCE
    routes = chip_smoke.LN_ROUTES if kernel == 'ln' else \
        chip_smoke.RMS_ROUTES
    # chip_smoke's tensors are fresh allocations: 16-byte aligned
    for (n, d), want in routes.items():
        for dtype in (torch.float32, torch.bfloat16):
            whole = d % _chunk_width(dtype) == 0
            got = warp_kernel if whole and d <= ROW_COLUMNS else block_kernel
            assert got == want, ((n, d), dtype, got, want)
    # the main path's shapes take the register path, and RMSNorm drives
    # both routes
    assert set(routes.values()) == ({warp_kernel} if kernel == 'ln'
                                    else {warp_kernel, block_kernel})
