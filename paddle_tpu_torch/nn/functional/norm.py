"""Normalisation functionals. Counterpart of
``paddle_tpu/nn/functional/norm.py`` (``layer_norm``, ``rms_norm`` and
``fused_dropout_add_layer_norm``).

All three dispatch by device inside the kernel wrappers: CUDA tensors run
the hand-written kernels, CPU tensors their plain versions. The
reference's gates (``x.shape[-1] % 128 == 0`` and
``_FUSED_DROPOUT_NORM_MIN_ROWS = 4096``) were measured on a TPU v5e and do
not carry over: on CUDA the kernels run at every size until thresholds are
measured on the card.
"""
import math

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
    return _add_ln_kernel(x, residual, weight, bias, dropout_p=p_eff,
                          epsilon=epsilon, seed=seed, offset=offset)
