"""LayerNorm on a hand-written CUDA kernel, with its backward.

Counterpart of ``paddle_tpu/kernels/fused_norm.py`` (``_ln_fwd_kernel``,
launched by ``_ln_forward``, and the ``custom_vjp`` around it); the kernel
is ``csrc/fused_norm.cu``. ``fused_layer_norm`` normalises over the last
axis: a CUDA tensor goes to the kernel, a CPU tensor to
``fused_layer_norm_plain``, which writes the same two-pass arithmetic out
in PyTorch.

When a gradient is wanted the call goes through a
``torch.autograd.Function``: the forward also returns the per-row ``mean``
and ``rstd`` (the kernel writes them only then), and the backward is the
closed form of the reference's ``_ln_bwd_rule`` in torch ops, on either
device: the reference computes it in plain XLA, outside any kernel.

The RMSNorm kernel of the reference (``_rms_fwd_kernel``) is not ported
yet (ROADMAP.md).
"""
import torch

from . import _build

__all__ = ['fused_layer_norm', 'fused_layer_norm_plain', 'layer_norm_stats',
           'layer_norm_backward']

_ARGTYPES = (_build.P,) * 6 + (_build.I64, _build.I64, _build.F32,
                               _build.P)


def _compute_dtype(t):
    """fp32 for fp32 and narrower inputs, fp64 for fp64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def layer_norm_stats(x, weight, bias, eps):
    """Plain LayerNorm over the last axis -> ``(y, mean, rstd)``: the mean,
    then the centred variance, as the kernel computes them; ``mean`` and
    ``rstd`` have shape ``x.shape[:-1]``."""
    xf = x.to(_compute_dtype(x))
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def fused_layer_norm_plain(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis in plain PyTorch."""
    return layer_norm_stats(x, weight, bias, eps)[0]


def layer_norm_backward(g, x, weight, mean, rstd, want_bias):
    """Closed-form LayerNorm gradients from the saved input and row
    statistics -> ``(dx, dw, db)``; ``dw``/``db`` are None without a
    weight/bias."""
    d = x.shape[-1]
    gf = g.to(_compute_dtype(g))
    xhat = (x.to(gf.dtype) - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    gw = gf * weight.to(gf.dtype) if weight is not None else gf
    mean_g = gw.mean(-1, keepdim=True)
    mean_gx = (gw * xhat).mean(-1, keepdim=True)
    dx = (rstd.unsqueeze(-1) * (gw - mean_g - xhat * mean_gx)).to(x.dtype)
    dw = ((gf * xhat).reshape(-1, d).sum(0).to(weight.dtype)
          if weight is not None else None)
    db = gf.reshape(-1, d).sum(0).to(g.dtype) if want_bias else None
    return dx, dw, db


def _forward(x, weight, bias, eps, want_stats):
    """-> ``(y, mean, rstd)``; the statistics are None unless wanted."""
    if not _build.use_kernels(x):
        y, mean, rstd = layer_norm_stats(x, weight, bias, eps)
        return (y, mean, rstd) if want_stats else (y, None, None)
    d = x.shape[-1]
    _build.require(x, 'fused_layer_norm: x', x.device)
    for t, name in ((weight, 'weight'), (bias, 'bias')):
        if t is not None:
            _build.require(t, f'fused_layer_norm: {name}', x.device, (d,))
    y = torch.empty_like(x)
    mean = rstd = None
    if want_stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    n = x.numel() // d if d else 0
    if n == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        _build.call('layer_norm_fwd', 'ptt_layer_norm_fwd', _ARGTYPES,
                    x.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    None if mean is None else mean.data_ptr(),
                    None if rstd is None else rstd.data_ptr(), n, d,
                    float(eps), _build.stream(x.device))
    return y, mean, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = _forward(x, weight, bias, eps, True)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(g, x, weight, mean, rstd,
                                         ctx.has_bias)
        return dx, dw, db, None


def fused_layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the LAST axis of ``x`` (any leading shape). CUDA
    tensors run the kernel (fp32, contiguous); CPU tensors the plain
    version; differentiable on both."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps, False)[0]
