"""Common functionals. Counterpart of ``paddle_tpu/nn/functional/common.py``
(``dropout``).

The reference draws each dropout call's key from its global key chain
(``core.rng.next_key``); the port has no implicit generator: a call that
drops anything takes a ``DropoutState`` (a seed fixed from an explicit
``torch.Generator`` plus a host-side call count) and asks it for this
call's ``(seed, offset)``. The mask is the Philox mask the kernels use
(``kernels/philox.py``), in plain torch ops: this dropout is composed XLA
code in the reference too, not a Pallas kernel.
"""
from ...kernels.philox import keep_scale

__all__ = ['dropout', 'next_dropout_call']


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


def dropout(x, p=0.5, training=True, dropout_state=None):
    """Inverted dropout: in training each element is zeroed with
    probability ``p`` and the rest scaled by ``1 / (1 - p)``."""
    p_eff = float(p) if training else 0.0
    if not 0.0 <= p_eff < 1.0:
        if p_eff == 1.0:
            return x * 0.0
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    seed, offset = next_dropout_call(dropout_state, p_eff, 'dropout')
    if seed is None:
        return x
    return x * keep_scale(x.shape, p_eff, seed, offset, x.device, x.dtype)
