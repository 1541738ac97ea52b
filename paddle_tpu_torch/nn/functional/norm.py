"""Normalisation functionals. Counterpart of
``paddle_tpu/nn/functional/norm.py`` (``layer_norm``, ``rms_norm``,
``fused_dropout_add_layer_norm``, ``batch_norm``, ``instance_norm``,
``group_norm``, ``local_response_norm``, ``normalize``).

``layer_norm``, ``rms_norm`` and ``fused_dropout_add_layer_norm`` run on
the port's kernels; the others are plain PyTorch ops, as the reference
leaves them to XLA (``batch_norm`` through a ``torch.autograd.Function``
whose backward is the closed form of the reference's gradient, so that
a step keeps only the input and two per-channel vectors a layer).

The three kernel functionals dispatch by device inside the kernel wrappers: CUDA tensors run
the hand-written kernels, CPU tensors their plain versions. The
reference's gates (``x.shape[-1] % 128 == 0`` and
``_FUSED_DROPOUT_NORM_MIN_ROWS = 4096``) were measured on a TPU v5e and do
not carry over: on CUDA the kernels run at every size until thresholds are
measured on the card.

Mixed dtypes, as ``amp.auto_cast`` makes them (the kernels take one dtype
a call, and a wrapper never casts, so the casts are here):

- ``layer_norm`` of a low-precision ``x`` with fp32 parameters (the MLM
  head's LayerNorm under O1, fed by an fp16 ``Linear``): the parameters
  are cast to ``x``'s dtype and the kernel runs at that dtype. The
  reference's kernel reads them in fp32 and writes ``y`` in ``x``'s dtype,
  so the port's ``y`` is the same up to the parameters' rounding;
- ``fused_dropout_add_layer_norm`` of a low-precision sublayer output
  ``x`` with an fp32 ``residual`` (every post-norm epilogue under O1):
  ``x`` is cast up and the kernel runs in fp32. The reference's composed
  path (``paddle_tpu/nn/functional/norm.py:310-314``) drops ``x`` in its
  own dtype and adds in fp32: at ``p = 0`` the two are the same sum; at
  ``p > 0`` the port scales the kept values in fp32, rounding once where
  the reference rounds once in ``x``'s dtype (ROADMAP.md, Queue 3).
"""
import contextlib
import math

import torch

from ...kernels.fused_dropout_norm import \
    fused_dropout_add_layer_norm as _add_ln_kernel
from ...kernels.fused_norm import fused_layer_norm, fused_rms_norm
from .common import next_dropout_call

__all__ = ['layer_norm', 'rms_norm', 'fused_dropout_add_layer_norm',
           'batch_norm', 'instance_norm', 'group_norm',
           'local_response_norm', 'normalize', 'batch_stats_over_ranks']


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes. Several
    trailing axes are flattened into one, so every call is one row
    normalisation."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_norm = len(normalized_shape)
    d = math.prod(normalized_shape)
    shape = x.shape
    weight, bias = (None if t is None else t.to(x.dtype)
                    for t in (weight, bias))
    y = fused_layer_norm(
        x.reshape(*shape[:x.dim() - n_norm], d),
        None if weight is None else weight.reshape(d),
        None if bias is None else bias.reshape(d), epsilon)
    return y.reshape(shape)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + epsilon) *
    weight`` — the reference kernel's arithmetic (its off-TPU path divides
    by ``sqrt`` instead), on the RMSNorm kernel at every width."""
    return fused_rms_norm(x, weight, epsilon)


def fused_dropout_add_layer_norm(x, residual, weight=None, bias=None,
                                 dropout_p=0.0, epsilon=1e-5, training=True,
                                 dropout_state=None):
    """``y = LayerNorm(residual + dropout(x))`` over the last axis; dropout
    applies only when ``training``, and then draws this call's ``(seed,
    offset)`` from ``dropout_state`` (the reference draws a seed per call
    from its key chain)."""
    p_eff = float(dropout_p) if training else 0.0
    seed, offset = next_dropout_call(dropout_state, p_eff,
                                     'fused_dropout_add_layer_norm')
    ct = torch.promote_types(x.dtype, residual.dtype)
    x, residual, weight, bias = (None if t is None else t.to(ct)
                                 for t in (x, residual, weight, bias))
    return _add_ln_kernel(x, residual, weight, bias, dropout_p=p_eff,
                          epsilon=epsilon, seed=seed, offset=offset)


# -- batch_norm ------------------------------------------------------------
#
# The reference's arithmetic (paddle_tpu/nn/functional/norm.py): in
# training the batch statistics are computed in fp32, shifted by the
# running mean s (E[x - s] and E[(x - s)^2], var = max(E[(x-s)^2] -
# E[x-s]^2, 0)), the normalised value is cast to the input's dtype before
# the affine, and the running statistics become ``momentum * old + (1 -
# momentum) * batch`` (Paddle's momentum weighs the OLD value), the
# variance unbiased (n / (n - 1)), in the buffers' dtype. In eval (or with
# ``use_global_stats``) the input is normalised by the running statistics
# ``(x - mean) / sqrt(var + eps)``, in the promoted dtype.

_STATS = {'ranks': False}


@contextlib.contextmanager
def batch_stats_over_ranks(enabled=True):
    """Inside, a training ``batch_norm`` takes its statistics over the
    global batch: the per-channel sums of every rank of the data axis are
    added (one all-reduce in the forward, one in the backward), as the
    reference's sharded step, one program over the global batch, reduces
    them. ``engine.build_train_step`` enters it for a step that averages
    its gradients over the ranks (``sharding=``, a ``DataParallel`` net)."""
    before = _STATS['ranks']
    _STATS['ranks'] = bool(enabled)
    try:
        yield
    finally:
        _STATS['ranks'] = before


def _sum_over_ranks(t):
    from ...distributed import collective
    return collective.all_reduce(t)


def _channel_shape(ndim, c, data_format):
    ch = 1 if data_format.startswith('NC') else ndim - 1
    shape = [1] * ndim
    shape[ch] = c
    return shape, tuple(i for i in range(ndim) if i != ch)


class _BatchStats(torch.autograd.Function):
    """``(x - mean) * rsqrt(var + eps)`` with the batch statistics, in
    ``x``'s dtype, and the new running statistics. Saves ``x``, ``mean``
    and ``inv``; the backward is ``inv * (g - mean(g) - xhat * mean(g *
    xhat))``, the gradient of the reference's expression (its shift is a
    ``stop_gradient``)."""

    @staticmethod
    def forward(ctx, x, running_mean, shape, axes, eps, n, over_ranks):
        ct = torch.promote_types(x.dtype, torch.float32)
        s = running_mean.detach().to(ct).reshape(shape)
        vc = x.to(ct) - s
        if over_ranks:
            sums = _sum_over_ranks(torch.stack([vc.sum(dim=axes),
                                                (vc * vc).sum(dim=axes)]))
            mean_c, m2 = sums[0] / n, sums[1] / n
        else:
            mean_c = vc.mean(dim=axes)
            m2 = (vc * vc).mean(dim=axes)
        var = torch.clamp_min(m2 - mean_c * mean_c, 0.0)
        mean = mean_c + s.reshape(mean_c.shape)
        inv = torch.rsqrt(var.reshape(shape) + eps)
        out = ((x.to(ct) - mean.reshape(shape)) * inv).to(x.dtype)
        ctx.save_for_backward(x, mean, inv)
        ctx.shape, ctx.axes, ctx.over_ranks, ctx.n = shape, axes, \
            over_ranks, n
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, mean, inv = ctx.saved_tensors
        ct = inv.dtype
        xhat = (x.to(ct) - mean.reshape(ctx.shape)) * inv
        g = g.to(ct)
        if ctx.over_ranks:
            sums = torch.stack([g.sum(dim=ctx.axes),
                                (g * xhat).sum(dim=ctx.axes)])
            sums = _sum_over_ranks(sums) / ctx.n
            mg, mgx = sums[0], sums[1]
        else:
            mg, mgx = g.mean(dim=ctx.axes), (g * xhat).mean(dim=ctx.axes)
        dx = inv * (g - mg.reshape(ctx.shape) - xhat * mgx.reshape(ctx.shape))
        return dx.to(x.dtype), None, None, None, None, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format='NCHW', use_global_stats=None):
    """BatchNorm over every axis but the channel one (axis 1 for ``NC...``
    formats, the last for ``N...C``). In training (and without
    ``use_global_stats``) ``running_mean`` / ``running_var`` are updated in
    place, without gradient."""
    shape, axes = _channel_shape(x.dim(), running_mean.numel(), data_format)
    if training and not use_global_stats:
        n = math.prod(x.shape[a] for a in axes)
        over_ranks = _STATS['ranks']
        if over_ranks:
            from ...distributed import env
            n *= env.get_world_size(env.DATA_AXIS)   # equal slices a rank
        out, mean, var = _BatchStats.apply(
            x, running_mean, shape, axes, float(epsilon), n, over_ranks)
        unbias = n / max(n - 1, 1)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum)
                               * mean.to(running_mean.dtype))
            running_var.copy_(momentum * running_var + (1 - momentum)
                              * (var * unbias).to(running_var.dtype))
    else:
        inv = 1.0 / torch.sqrt(running_var.reshape(shape) + epsilon)
        out = (x - running_mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``t`` over the data axis's ranks; its gradient is the
    same sum of the cotangent (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, t):
        return _sum_over_ranks(t.clone())

    @staticmethod
    def backward(ctx, g):
        return _sum_over_ranks(g.clone())


def sync_batch_norm(x, running_mean, running_var, weight, bias, momentum,
                    epsilon, data_format):
    """The reference's ``SyncBatchNorm`` in training inside a group: the
    per-channel sums of ``x`` and ``x * x`` and the count added over the
    data axis's ranks, in ``x``'s dtype; the running variance takes the
    BIASED batch variance, in the buffers' dtype."""
    shape, axes = _channel_shape(x.dim(), running_mean.numel(), data_format)
    n_local = math.prod(x.shape[a] for a in axes)
    c = running_mean.numel()
    sums = _SumOverRanks.apply(torch.cat([
        x.sum(dim=axes), (x * x).sum(dim=axes),
        torch.full((1,), n_local, dtype=x.dtype, device=x.device)]))
    s, ss, n = sums[:c], sums[c:2 * c], sums[2 * c]
    mean = s / n
    var = ss / n - mean * mean
    out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) +
                                                 epsilon)
    if weight is not None:
        out = out * weight.reshape(shape) + bias.reshape(shape)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum)
                           * mean.detach().to(running_mean.dtype))
        running_var.copy_(momentum * running_var + (1 - momentum)
                          * var.detach().to(running_var.dtype))
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format='NCHW'):
    """Each sample's channels normalised over their spatial axes (biased
    variance); the running statistics are accepted and unused, as in the
    reference."""
    ch = 1 if data_format.startswith('NC') else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i not in (0, ch))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    if weight is not None:
        shape = [1] * x.dim()
        shape[ch] = weight.numel()
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format='NCHW'):
    """The channels cut into ``num_groups`` groups, each normalised over
    its channels and the spatial axes (biased variance)."""
    ch = 1 if data_format.startswith('NC') else x.dim() - 1
    v = x if ch == 1 else x.movedim(ch, 1)
    n, c = v.shape[0], v.shape[1]
    g = v.reshape(n, num_groups, c // num_groups, *v.shape[2:])
    axes = tuple(range(2, g.dim()))
    var, mean = torch.var_mean(g, dim=axes, correction=0, keepdim=True)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(v.shape)
    if weight is not None:
        shape = [1] * v.dim()
        shape[1] = c
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out if ch == 1 else out.movedim(1, ch)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format='NCHW'):
    """``x / (k + alpha * sum of x^2 over a window of size channels) **
    beta``, the window padded ``(size // 2, size - 1 - size // 2)``; the
    reference does not divide ``alpha`` by ``size``."""
    ch = 1 if data_format.startswith('NC') else x.dim() - 1
    half = size // 2
    sq = (x * x).movedim(ch, -1)
    padded = torch.nn.functional.pad(sq, (half, size - 1 - half))
    c = x.shape[ch]
    acc = torch.zeros_like(sq)
    for i in range(size):
        acc = acc + padded[..., i:i + c]
    div = (k + alpha * acc.movedim(-1, ch)) ** beta
    return x / div


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x`` divided by its ``p``-norm along ``axis`` (at least
    ``epsilon``)."""
    if p == 2:
        nrm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        nrm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** \
            (1.0 / p)
    return x / torch.clamp_min(nrm, epsilon)
