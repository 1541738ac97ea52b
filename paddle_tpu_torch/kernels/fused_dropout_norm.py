"""Residual add + LayerNorm forward on a hand-written CUDA kernel.

Counterpart of ``paddle_tpu/kernels/fused_dropout_norm.py`` (``_fwd_kernel``,
launched by ``_fused_fwd``); the kernel is ``csrc/fused_dropout_norm.cu``.
``fused_dropout_add_layer_norm`` computes ``y = LayerNorm(residual +
dropout(x))`` over the last axis: the post-norm epilogue every transformer
sublayer ends with. A CUDA tensor goes to the kernel, a CPU tensor to the
plain version.

The CUDA path has no dropout yet: in-kernel dropout needs a counter-based
generator (Philox) that the backward can replay, which comes with the
training path, so ``dropout_p > 0`` on CUDA raises ``NotImplementedError``
(serving runs in eval, where ``p == 0``). The plain version draws its
dropout mask with ``torch.nn.functional.dropout``.
"""
import torch

from . import _build

__all__ = ['fused_dropout_add_layer_norm',
           'fused_dropout_add_layer_norm_plain']

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0

_ARGTYPES = (_build.P,) * 8 + (_build.I64, _build.I64, _build.F32,
                               _build.P)


def fused_dropout_add_layer_norm_plain(x, residual, weight=None, bias=None,
                                       dropout_p=0.0, epsilon=1e-5):
    """``LayerNorm(residual + dropout(x))`` in plain PyTorch, with fp32
    two-pass statistics as the kernel computes them."""
    if dropout_p > 0.0:
        x = torch.nn.functional.dropout(x, dropout_p, training=True)
    yin = residual.float() + x.float()
    mean = yin.mean(-1, keepdim=True)
    xc = yin - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_dropout_add_layer_norm(x, residual, weight=None, bias=None,
                                 dropout_p=0.0, epsilon=1e-5):
    """``y = LayerNorm(residual + dropout(x))`` over the last axis. CUDA
    tensors run the kernel (fp32, contiguous, ``dropout_p == 0``); CPU
    tensors the plain version; any other device raises."""
    global launches
    if x.device.type == 'cpu':
        return fused_dropout_add_layer_norm_plain(x, residual, weight, bias,
                                                  dropout_p, epsilon)
    if dropout_p > 0.0:
        raise NotImplementedError(
            "fused_dropout_add_layer_norm: dropout_p > 0 on CUDA needs the "
            "in-kernel Philox dropout of the training path, not ported yet")
    d = x.shape[-1]
    _build.require(x, 'fused_dropout_add_layer_norm: x', x.device)
    _build.require(residual, 'fused_dropout_add_layer_norm: residual',
                   x.device, x.shape)
    for t, name in ((weight, 'weight'), (bias, 'bias')):
        if t is not None:
            _build.require(t, f'fused_dropout_add_layer_norm: {name}',
                           x.device, (d,))
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        _build.call('ptt_add_layer_norm_fwd', _ARGTYPES, x.data_ptr(),
                    residual.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    y.data_ptr(), None, None, None, n, d, float(epsilon),
                    _build.stream(x.device))
    launches += 1
    return y
