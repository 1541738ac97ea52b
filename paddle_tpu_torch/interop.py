"""Carry weights, gradients and optimizer state between the JAX package
and the port.

The port's own counterpart of the weight-moving half of
``paddle_tpu/interop.py`` (which the port does not import).
``load_paddle_tpu_state(module, state)`` takes a reference layer's
``state_dict()`` as ``{key: numpy array}`` — keys such as
``encoder.layers.0.self_attn.q_proj.weight`` — and copies it into a port
module whose attribute names match. Every ``Linear`` weight is transposed:
the reference stores (in, out), ``torch.nn.functional.linear`` takes
(out, in). Shape alone cannot tell (q/k/v/out projections are square), so
the transpose is chosen by module type. BERT's tied MLM decoder is one
(vocab, hidden) parameter on both sides, listed once, under
``bert.embeddings.word_embeddings.weight``, and used untransposed, so it
moves like any embedding table.

``to_paddle_tpu_state`` is the inverse (parameters, or their ``.grad``s),
and ``load_paddle_tpu_opt_state`` / ``to_paddle_tpu_opt_state`` move the
optimizer's per-parameter state — ``{key: {'moment1', 'moment2',
'beta1_pow', 'beta2_pow'}}`` on both sides, the powers 0-dim arrays of the
parameter's dtype — the same way, so a test can
lay gradients, updated weights and moments beside the reference's.
"""
import numpy as np
import torch

from .nn.layer.common import Linear

__all__ = ['load_paddle_tpu_state', 'to_paddle_tpu_state',
           'load_paddle_tpu_opt_state', 'to_paddle_tpu_opt_state']


def _linear_weights(module):
    """Keys of the weights stored transposed against the reference."""
    return {f'{name}.weight' if name else 'weight'
            for name, m in module.named_modules() if isinstance(m, Linear)}


def load_paddle_tpu_state(module, state):
    """Copy ``state`` (reference key -> numpy array) into ``module``.
    Raises ``ValueError`` on missing, unexpected or mis-shaped keys; nothing
    is copied unless every key checks out."""
    linear_weights = _linear_weights(module)
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


def to_paddle_tpu_state(module, grads=False):
    """The port's parameters and buffers (or, with ``grads=True``, the
    parameters' ``.grad``s; None where there is none) as ``{reference key:
    numpy array}`` in the reference's layout: ``Linear`` weights transposed
    back to (in, out)."""
    linear_weights = _linear_weights(module)
    if grads:
        tensors = {k: p.grad for k, p in module.named_parameters()}
    else:
        tensors = module.state_dict()
    out = {}
    for key, t in tensors.items():
        if t is None:
            out[key] = None
            continue
        value = t.detach().cpu().numpy()
        out[key] = value.T.copy() if key in linear_weights else value.copy()
    return out


_MOMENTS = ('moment1', 'moment2')
_POWS = ('beta1_pow', 'beta2_pow')


def load_paddle_tpu_opt_state(module, opt_state, ref_state):
    """Copy the reference's Adam/AdamW state ``ref_state`` (``{key: {slot:
    array}}``) into the port's ``opt_state`` (of
    ``optimizer.init_state_values``) for ``module``'s parameters. Raises
    ``ValueError`` on missing, unexpected or mis-shaped entries."""
    linear_weights = _linear_weights(module)
    if set(ref_state) != set(opt_state):
        raise ValueError(
            f"load_paddle_tpu_opt_state: missing keys "
            f"{sorted(set(opt_state) - set(ref_state))[:8]}, unexpected keys "
            f"{sorted(set(ref_state) - set(opt_state))[:8]}")
    for key, slots in opt_state.items():
        for slot in _MOMENTS:
            value = np.asarray(ref_state[key][slot])
            if key in linear_weights:
                value = value.T
            if value.shape != tuple(slots[slot].shape):
                raise ValueError(
                    f"load_paddle_tpu_opt_state: {key}.{slot} has shape "
                    f"{np.asarray(ref_state[key][slot]).shape}, which does "
                    f"not fit a parameter of {tuple(slots[slot].shape)}")
            with torch.no_grad():
                slots[slot].copy_(torch.tensor(value,
                                               dtype=slots[slot].dtype))
        for slot in _POWS:
            # 0-dim tensors of the parameter's dtype, one pair a parameter
            slots[slot] = torch.tensor(
                np.array(ref_state[key][slot]), dtype=slots[slot].dtype,
                device=slots[slot].device)
    return opt_state


def to_paddle_tpu_opt_state(module, opt_state):
    """The port's Adam/AdamW state as ``{reference key: {slot: numpy}}`` in
    the reference's layout."""
    linear_weights = _linear_weights(module)
    out = {}
    for key, slots in opt_state.items():
        out[key] = {}
        for slot in _MOMENTS:
            value = slots[slot].detach().cpu().numpy()
            out[key][slot] = (value.T.copy() if key in linear_weights
                              else value.copy())
        for slot in _POWS:
            out[key][slot] = slots[slot].detach().cpu().numpy()
    return out
