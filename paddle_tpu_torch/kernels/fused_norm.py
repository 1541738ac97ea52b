"""LayerNorm forward on a hand-written CUDA kernel.

Counterpart of ``paddle_tpu/kernels/fused_norm.py`` (``_ln_fwd_kernel``,
launched by ``_ln_forward``); the kernel is ``csrc/fused_norm.cu``.
``fused_layer_norm`` normalises over the last axis: a CUDA tensor goes to
the kernel, a CPU tensor to ``fused_layer_norm_plain``, which writes the
same fp32 two-pass arithmetic out in PyTorch.

The RMSNorm kernel of the reference (``_rms_fwd_kernel``) and the
backward are not ported yet (ROADMAP.md).
"""
import torch

from . import _build

__all__ = ['fused_layer_norm', 'fused_layer_norm_plain']

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0

_ARGTYPES = (_build.P,) * 6 + (_build.I64, _build.I64, _build.F32,
                               _build.P)


def fused_layer_norm_plain(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis in plain PyTorch: fp32 mean, then the
    centred variance, as the kernel computes them."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the LAST axis of ``x`` (any leading shape). CUDA
    tensors run the kernel (fp32, contiguous); CPU tensors the plain
    version; any other device raises."""
    global launches
    if x.device.type == 'cpu':
        return fused_layer_norm_plain(x, weight, bias, eps)
    d = x.shape[-1]
    _build.require(x, 'fused_layer_norm: x', x.device)
    for t, name in ((weight, 'weight'), (bias, 'bias')):
        if t is not None:
            _build.require(t, f'fused_layer_norm: {name}', x.device, (d,))
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        _build.call('ptt_layer_norm_fwd', _ARGTYPES, x.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    y.data_ptr(), None, None, n, d, float(eps),
                    _build.stream(x.device))
    launches += 1
    return y
