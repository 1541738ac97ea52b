"""Dropout + residual add + LayerNorm on hand-written CUDA kernels, with
its backward.

Counterpart of ``paddle_tpu/kernels/fused_dropout_norm.py`` (``_fwd_kernel``
launched by ``_fused_fwd``, ``_dmask_kernel`` launched by
``_apply_dropout_grad``, and the ``custom_vjp`` ``_fdln``); the kernels are
in ``csrc/fused_dropout_norm.cu``. ``fused_dropout_add_layer_norm``
computes ``y = LayerNorm(residual + dropout(x))`` over the last axis: the
post-norm epilogue every transformer sublayer ends with. A CUDA tensor goes
to the kernels, a CPU tensor to the plain versions.

The dropout mask is the Philox mask of ``philox.py`` / ``csrc/philox.cuh``,
a function of ``(seed, offset)`` and the element's index, so it is never
stored: ``dropout_p > 0`` needs ``seed`` and ``offset``, the backward
regenerates the bits. When a gradient is wanted the call goes through a
``torch.autograd.Function`` after the reference's ``_fdln_fwd`` /
``_fdln_bwd``: the forward also writes the pre-norm sum ``yin`` and the row
statistics, the backward is LayerNorm's closed form in torch ops (plain XLA
in the reference) followed, when ``p > 0``, by the mask-gradient kernel
``dx = d_yin * keep / (1 - p)``. In eval and under ``torch.no_grad()`` the
forward writes ``y`` only.

Both kernels take fp32 or bf16, every tensor of a call in one dtype. As in
the reference, the sum ``residual + dropout(x)`` is formed in fp32 and the
statistics are taken from that fp32 sum, while ``y`` and ``yin`` are
stored in the input dtype; the backward forms ``xhat`` from the stored
(at bf16, rounded) ``yin``, and the mask gradient multiplies in fp32 and
rounds once.
"""
import torch

from . import _build
from .fused_norm import layer_norm_backward, layer_norm_stats
from .philox import keep_scale

__all__ = ['fused_dropout_add_layer_norm',
           'fused_dropout_add_layer_norm_plain', 'dropout_grad',
           'dropout_grad_plain']

_FWD_ARGTYPES = (_build.P,) * 8 + (_build.I64, _build.I64, _build.F32) + \
    _build.DROPOUT_ARGTYPES + (_build.I32, _build.P)
_GRAD_ARGTYPES = (_build.P, _build.P, _build.I64) + \
    _build.DROPOUT_ARGTYPES + (_build.I32, _build.P)
# at bf16 the block path's dropout branch (the widths the register path
# does not take, csrc/fused_dropout_norm.cu) keeps a row's fp32 sum in
# shared memory: 4 bytes a column of the 227 KB a block may have, less its
# 128-byte scratch
MAX_BF16_DROPOUT_WIDTH = (232448 - 128) // 4


def _check_dropout(name, dropout_p, seed, offset):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p must be in [0, 1), got "
                         f"{dropout_p}")
    if dropout_p > 0.0 and (seed is None or offset is None):
        raise ValueError(f"{name}: dropout_p > 0 needs the Philox seed and "
                         "offset of this call (DropoutState.next())")


def _plain_stats(x, residual, weight, bias, dropout_p, epsilon, seed, offset):
    """-> ``(y, yin, mean, rstd)`` in plain PyTorch: the statistics of the
    sum in the compute type, ``y`` and ``yin`` in ``x``'s dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    if dropout_p > 0.0:
        xf = xf * keep_scale(x.shape, dropout_p, seed, offset, x.device, ct)
    total = residual.to(ct) + xf
    y, mean, rstd = layer_norm_stats(total, weight, bias, epsilon)
    return y.to(x.dtype), total.to(x.dtype), mean, rstd


def fused_dropout_add_layer_norm_plain(x, residual, weight=None, bias=None,
                                       dropout_p=0.0, epsilon=1e-5,
                                       seed=None, offset=None):
    """``LayerNorm(residual + dropout(x))`` in plain PyTorch, with the
    kernel's arithmetic and the same Philox mask."""
    _check_dropout('fused_dropout_add_layer_norm_plain', dropout_p, seed,
                   offset)
    return _plain_stats(x, residual, weight, bias, dropout_p, epsilon, seed,
                        offset)[0]


def dropout_grad_plain(g, dropout_p, seed, offset):
    """``g * keep / (1 - p)`` with the Philox mask of ``(seed, offset)``,
    multiplied in the compute type and rounded once to ``g``'s dtype."""
    ct = torch.promote_types(g.dtype, torch.float32)
    return (g.to(ct) * keep_scale(g.shape, dropout_p, seed, offset, g.device,
                                  ct)).to(g.dtype)


def dropout_grad(g, dropout_p, seed, offset):
    """The dropout-mask gradient ``dx = g * keep / (1 - p)``, the mask
    regenerated from ``(seed, offset)``. CUDA tensors run the kernel (fp32
    or bf16, contiguous); CPU tensors the plain version."""
    _check_dropout('dropout_grad', dropout_p, seed, offset)
    if dropout_p == 0.0:
        return g
    if not _build.use_kernels(g):
        return dropout_grad_plain(g, dropout_p, seed, offset)
    _build.require(g, 'dropout_grad: g', g.device)
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    with torch.cuda.device(g.device):
        _build.call('dropout_grad', 'ptt_dropout_grad', _GRAD_ARGTYPES,
                    g.data_ptr(), out.data_ptr(), g.numel(),
                    *_build.dropout_args(dropout_p, seed, offset),
                    _build.dtype_code(g), _build.stream(g.device))
    return out


def _forward(x, residual, weight, bias, dropout_p, epsilon, seed, offset,
             want_saved):
    """-> ``(y, yin, mean, rstd)``; the last three are None unless
    ``want_saved``."""
    if not _build.use_kernels(x):
        out = _plain_stats(x, residual, weight, bias, dropout_p, epsilon,
                           seed, offset)
        return out if want_saved else (out[0], None, None, None)
    name = 'fused_dropout_add_layer_norm'
    d = x.shape[-1]
    # x last: a dtype that differs from x's is named before other faults
    _build.require(residual, f'{name}: residual', x.device, x.shape,
                   dtype=x.dtype)
    for t, label in ((weight, 'weight'), (bias, 'bias')):
        if t is not None:
            _build.require(t, f'{name}: {label}', x.device, (d,),
                           dtype=x.dtype)
    _build.require(x, f'{name}: x', x.device)
    if (dropout_p > 0.0 and x.dtype == torch.bfloat16
            and d > MAX_BF16_DROPOUT_WIDTH):
        raise ValueError(f"{name}: with dropout at bfloat16 the kernel takes "
                         f"rows of at most {MAX_BF16_DROPOUT_WIDTH} columns, "
                         f"got {d}")
    y = torch.empty_like(x)
    # with dropout the entry point takes yin: the fp32 block path parks the
    # sum there between its passes
    yin = torch.empty_like(x) if want_saved or dropout_p > 0.0 else None
    mean = rstd = None
    if want_saved:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    n = x.numel() // d if d else 0
    if n == 0:
        return y, yin, mean, rstd
    with torch.cuda.device(x.device):
        _build.call('add_layer_norm_fwd', 'ptt_add_layer_norm_fwd',
                    _FWD_ARGTYPES, x.data_ptr(), residual.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    None if yin is None else yin.data_ptr(),
                    None if mean is None else mean.data_ptr(),
                    None if rstd is None else rstd.data_ptr(), n, d,
                    float(epsilon),
                    *_build.dropout_args(dropout_p, seed, offset),
                    _build.dtype_code(x), _build.stream(x.device))
    return (y, yin, mean, rstd) if want_saved else (y, None, None, None)


class _DropoutAddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, bias, dropout_p, epsilon, seed,
                offset):
        y, yin, mean, rstd = _forward(x, residual, weight, bias, dropout_p,
                                      epsilon, seed, offset, True)
        ctx.save_for_backward(yin, weight, mean, rstd)
        ctx.has_bias = bias is not None
        ctx.dropout = (dropout_p, seed, offset)
        return y

    @staticmethod
    def backward(ctx, g):
        yin, weight, mean, rstd = ctx.saved_tensors
        d_yin, dw, db = layer_norm_backward(g, yin, weight, mean, rstd,
                                            ctx.has_bias)
        dx = dropout_grad(d_yin.contiguous(), *ctx.dropout)
        return dx, d_yin, dw, db, None, None, None, None


def fused_dropout_add_layer_norm(x, residual, weight=None, bias=None,
                                 dropout_p=0.0, epsilon=1e-5, seed=None,
                                 offset=None):
    """``y = LayerNorm(residual + dropout(x))`` over the last axis.
    ``dropout_p > 0`` needs the call's Philox ``seed`` and ``offset``. CUDA
    tensors run the kernels (fp32 or bf16, contiguous, one dtype for every
    tensor); CPU tensors the plain versions; differentiable on both."""
    dropout_p = float(dropout_p)
    _check_dropout('fused_dropout_add_layer_norm', dropout_p, seed, offset)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, residual, weight, bias)):
        return _DropoutAddLayerNorm.apply(x, residual, weight, bias,
                                          dropout_p, epsilon, seed, offset)
    return _forward(x, residual, weight, bias, dropout_p, epsilon, seed,
                    offset, False)[0]
