"""Load the JAX package's weights into the port.

The port's own counterpart of the weight-moving half of
``paddle_tpu/interop.py`` (which the port does not import).
``load_paddle_tpu_state(module, state)`` takes a reference layer's
``state_dict()`` as ``{key: numpy array}`` — keys such as
``encoder.layers.0.self_attn.q_proj.weight`` — and copies it into a port
module whose attribute names match. Every ``Linear`` weight is transposed:
the reference stores (in, out), ``torch.nn.functional.linear`` takes
(out, in). Shape alone cannot tell (q/k/v/out projections are square), so
the transpose is chosen by module type.
"""
import numpy as np
import torch

from .nn.layer.common import Linear

__all__ = ['load_paddle_tpu_state']


def load_paddle_tpu_state(module, state):
    """Copy ``state`` (reference key -> numpy array) into ``module``.
    Raises ``ValueError`` on missing, unexpected or mis-shaped keys; nothing
    is copied unless every key checks out."""
    linear_weights = {f'{name}.weight' if name else 'weight'
                      for name, m in module.named_modules()
                      if isinstance(m, Linear)}
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"load_paddle_tpu_state: missing keys {missing[:8]}, unexpected "
            f"keys {unexpected[:8]}")
    converted = {}
    for key, target in own.items():
        value = np.asarray(state[key])
        transpose = key in linear_weights
        expected = tuple(target.shape)[::-1] if transpose \
            else tuple(target.shape)
        if value.shape != expected:
            raise ValueError(
                f"load_paddle_tpu_state: {key} has shape {value.shape}, "
                f"expected {expected} (the reference's layout)")
        if transpose:
            value = value.T
        converted[key] = torch.tensor(value, dtype=target.dtype)
    module.load_state_dict(converted)
    return module
