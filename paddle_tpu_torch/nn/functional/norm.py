"""Normalisation functionals. Counterpart of
``paddle_tpu/nn/functional/norm.py`` (``layer_norm``, ``rms_norm`` and
``fused_dropout_add_layer_norm``).

All three dispatch by device inside the kernel wrappers: CUDA tensors run
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
import math

import torch

from ...kernels.fused_dropout_norm import \
    fused_dropout_add_layer_norm as _add_ln_kernel
from ...kernels.fused_norm import fused_layer_norm, fused_rms_norm
from .common import next_dropout_call

__all__ = ['layer_norm', 'rms_norm', 'fused_dropout_add_layer_norm']


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
