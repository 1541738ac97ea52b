"""Common functionals. Counterpart of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``dropout``).

``linear`` asks ``amp.maybe_cast_for('matmul', x, w)`` first, as the
reference's does: under ``auto_cast`` (O1, or O2) ``x`` and ``w`` become
the amp dtype, and the bias is cast to the product's dtype.

The reference draws each dropout call's key from its global key chain
(``core.rng.next_key``); the port has no implicit generator: a call that
drops anything takes a ``DropoutState`` (a seed fixed from an explicit
``torch.Generator`` plus a host-side call count) and asks it for this
call's ``(seed, offset)``. The mask is the Philox mask the kernels use
(``kernels/philox.py``), in plain torch ops: this dropout is composed XLA
code in the reference too, not a Pallas kernel.
"""
import torch

from ...amp import maybe_cast_for
from ...kernels.philox import keep_mask

__all__ = ['linear', 'dropout', 'next_dropout_call']


def linear(x, weight, bias=None):
    """``x W^T + b`` with ``weight`` stored (out, in), torch's layout (the
    reference stores (in, out)). Under ``auto_cast`` the product takes the
    amp dtype and the bias follows it."""
    x, weight = maybe_cast_for('matmul', x, weight)
    if bias is not None:
        bias = bias.to(torch.promote_types(x.dtype, weight.dtype))
    return torch.nn.functional.linear(x, weight, bias)


def next_dropout_call(dropout_state, p_eff, what):
    """``(seed, offset)`` of one dropout call from ``dropout_state``;
    ``(None, None)`` when nothing is dropped. Raises when something is to
    be dropped and no state was given."""
    if p_eff <= 0.0:
        return None, None
    if dropout_state is None:
        raise ValueError(
            f"{what}: dropout_p > 0 in training needs dropout_state= (a "
            "kernels.philox.DropoutState); the port draws from no implicit "
            "random generator")
    return dropout_state.next()


def dropout(x, p=0.5, training=True, dropout_state=None, shard=None):
    """Inverted dropout: in training each element is zeroed with
    probability ``p`` and the rest divided by ``1 - p``, in ``x``'s dtype:
    the reference's ``where(keep, v / (1 - p), 0)``, whose ``1 - p`` is a
    weakly typed scalar and so takes ``x``'s dtype (0.9 becomes 0.8999 in
    fp16, 0.8984 in bf16); the quotient is rounded once. ``shard=(n,
    r)``: ``x`` is column block ``r`` of ``n`` (last dim) of the dense
    activation and draws the dense mask's block (a tensor-parallel rank's
    piece)."""
    p_eff = float(p) if training else 0.0
    if not 0.0 <= p_eff < 1.0:
        if p_eff == 1.0:
            return x * 0.0
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    seed, offset = next_dropout_call(dropout_state, p_eff, 'dropout')
    if seed is None:
        return x
    if shard is None:
        keep = keep_mask(x.shape, p_eff, seed, offset, x.device)
    else:
        n, r = shard
        w = x.shape[-1]
        keep = keep_mask(x.shape, p_eff, seed, offset, x.device, within=(
            tuple(x.shape[:-1]) + (n * w,), (0,) * (x.dim() - 1) + (r * w,)))
    kept = float(torch.tensor(1.0 - p_eff, dtype=x.dtype))
    return torch.where(keep, x / kept, 0.0)
