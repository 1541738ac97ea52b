"""LayerNorm and RMSNorm on hand-written CUDA kernels, with their backward.

Counterpart of ``paddle_tpu/kernels/fused_norm.py`` (``_ln_fwd_kernel``,
launched by ``_ln_forward``, ``_rms_fwd_kernel``, launched by
``_rms_forward``, and the ``custom_vjp`` around each); the kernels are
``csrc/fused_norm.cu``. ``fused_layer_norm`` and ``fused_rms_norm``
normalise over the last axis: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version (``layer_norm_stats``, ``rms_norm_stats``),
which writes the same arithmetic out in PyTorch.

Both take fp32, bf16 or fp16, with the weight (and bias) in the input's
dtype:
``x`` is widened to fp32, ``y`` comes back in ``x``'s dtype and the row
statistics in fp32, as in the reference. When a gradient is wanted the
call goes through a ``torch.autograd.Function``: the forward also returns
the statistics (the kernel writes them only then), and the backward is the
closed form of the reference's ``_ln_bwd_rule`` / ``_rms_bwd_rule`` in
torch ops, on either device: the reference computes it in plain XLA,
outside any kernel.
"""
import torch

from . import _build

__all__ = ['fused_layer_norm', 'fused_layer_norm_plain', 'layer_norm_stats',
           'layer_norm_backward', 'fused_rms_norm', 'fused_rms_norm_plain',
           'rms_norm_stats', 'rms_norm_backward']

_ARGTYPES = (_build.P,) * 6 + (_build.I64, _build.I64, _build.F32,
                               _build.I32, _build.P)
_RMS_ARGTYPES = (_build.P,) * 4 + (_build.I64, _build.I64, _build.F32,
                                   _build.I32, _build.P)


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


def _require_rows(x, params, name):
    """Check ``x`` and its (d,) parameters for the kernel -> ``(n, d)``.
    The parameters go first, so a dtype that differs from ``x``'s is named
    before any other fault."""
    d = x.shape[-1]
    for t, label in params:
        if t is not None:
            _build.require(t, f'{name}: {label}', x.device, (d,),
                           dtype=x.dtype)
    _build.require(x, f'{name}: x', x.device)
    return (x.numel() // d if d else 0), d


def _forward(x, weight, bias, eps, want_stats):
    """-> ``(y, mean, rstd)``; the statistics are None unless wanted."""
    if not _build.use_kernels(x):
        y, mean, rstd = layer_norm_stats(x, weight, bias, eps)
        return (y, mean, rstd) if want_stats else (y, None, None)
    n, d = _require_rows(x, ((weight, 'weight'), (bias, 'bias')),
                         'fused_layer_norm')
    y = torch.empty_like(x)
    mean = rstd = None
    if want_stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    if n == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        _build.call('layer_norm_fwd', 'ptt_layer_norm_fwd', _ARGTYPES,
                    x.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    None if mean is None else mean.data_ptr(),
                    None if rstd is None else rstd.data_ptr(), n, d,
                    float(eps), _build.dtype_code(x), _build.stream(x.device))
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
    tensors run the kernel (fp32, bf16 or fp16, contiguous, weight and bias
    in ``x``'s dtype); CPU tensors the plain version; differentiable on
    both."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps, False)[0]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_stats(x, weight, eps):
    """Plain RMSNorm over the last axis -> ``(y, rstd)``, the kernel's
    arithmetic: ``ms = mean(x^2)`` in fp32, ``rstd = rsqrt(ms + eps)``,
    ``y = x * rstd * w`` (the reference's kernel multiplies by ``rsqrt``;
    its off-TPU path divides by ``sqrt``); ``rstd`` has shape
    ``x.shape[:-1]``."""
    xf = x.to(_compute_dtype(x))
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = xf * rstd
    if weight is not None:
        y = y * weight.to(y.dtype)
    return y.to(x.dtype), rstd.squeeze(-1)


def fused_rms_norm_plain(x, weight=None, eps=1e-6):
    """RMSNorm over the last axis in plain PyTorch."""
    return rms_norm_stats(x, weight, eps)[0]


def rms_norm_backward(g, x, weight, rstd):
    """Closed-form RMSNorm gradients from the saved input and ``rstd`` (the
    reference's ``_rms_bwd_rule``) -> ``(dx, dw)``; ``dw`` is None without
    a weight."""
    d = x.shape[-1]
    gf = g.to(_compute_dtype(g))
    r = rstd.unsqueeze(-1)
    xhat = x.to(gf.dtype) * r
    gw = gf * weight.to(gf.dtype) if weight is not None else gf
    mean_gx = (gw * xhat).mean(-1, keepdim=True)
    dx = (r * (gw - xhat * mean_gx)).to(x.dtype)
    dw = ((gf * xhat).reshape(-1, d).sum(0).to(weight.dtype)
          if weight is not None else None)
    return dx, dw


def _rms_forward(x, weight, eps, want_rstd):
    """-> ``(y, rstd)``; ``rstd`` is None unless wanted."""
    if not _build.use_kernels(x):
        y, rstd = rms_norm_stats(x, weight, eps)
        return y, (rstd if want_rstd else None)
    n, d = _require_rows(x, ((weight, 'weight'),), 'fused_rms_norm')
    y = torch.empty_like(x)
    rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
            if want_rstd else None)
    if n == 0:
        return y, rstd
    with torch.cuda.device(x.device):
        _build.call('rms_norm_fwd', 'ptt_rms_norm_fwd', _RMS_ARGTYPES,
                    x.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    y.data_ptr(), None if rstd is None else rstd.data_ptr(),
                    n, d, float(eps), _build.dtype_code(x),
                    _build.stream(x.device))
    return y, rstd


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = _rms_forward(x, weight, eps, True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_backward(g, x, weight, rstd)
        return dx, dw, None


def fused_rms_norm(x, weight=None, eps=1e-6):
    """RMSNorm over the LAST axis of ``x`` (any leading shape). CUDA tensors
    run the kernel at any width (fp32, bf16 or fp16, contiguous, the weight
    in ``x``'s dtype); CPU tensors the plain version; differentiable on
    both."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight)):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_forward(x, weight, eps, False)[0]
