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
optimizer's per-parameter state — ``{key: {slot: array}}`` under the same
slot names on both sides (``moment1``, ``velocity``, ``inf_norm``,
``avg_squared_grad``, ``mean_square``, ``squared``, ``moment2_max``, ...),
the powers 0-dim arrays of the parameter's dtype — the same way, and
``load_paddle_tpu_scheduler_state`` / ``to_paddle_tpu_scheduler_state``
a learning-rate scheduler's ``state_dict``, so a test can lay gradients,
updated weights, slots and schedules beside the reference's.
"""
import numpy as np
import torch

from .nn.layer.common import Linear

__all__ = ['load_paddle_tpu_state', 'to_paddle_tpu_state',
           'load_paddle_tpu_opt_state', 'to_paddle_tpu_opt_state',
           'load_paddle_tpu_scheduler_state',
           'to_paddle_tpu_scheduler_state']


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


def load_paddle_tpu_opt_state(module, opt_state, ref_state):
    """Copy the reference's optimizer state ``ref_state`` (``{key: {slot:
    array}}``, any optimizer's slots) into the port's ``opt_state`` (of
    ``optimizer.init_state_values``) for ``module``'s parameters: slots of
    the parameter's shape are copied in (transposed for ``Linear``
    weights), 0-dim ones (``beta*_pow``) become 0-dim tensors of their
    dtype, one a parameter. ``Dpsgd``'s ``key`` (a JAX PRNG key there, a
    ``torch.Generator`` here) is left as it is. Raises ``ValueError`` on
    missing, unexpected or mis-shaped entries."""
    linear_weights = _linear_weights(module)
    if set(ref_state) != set(opt_state):
        raise ValueError(
            f"load_paddle_tpu_opt_state: missing keys "
            f"{sorted(set(opt_state) - set(ref_state))[:8]}, unexpected keys "
            f"{sorted(set(ref_state) - set(opt_state))[:8]}")
    for key, slots in opt_state.items():
        own = {s: t for s, t in slots.items() if isinstance(t, torch.Tensor)}
        theirs = {s for s in ref_state[key] if s != 'key'}
        if set(own) != theirs:
            raise ValueError(
                f"load_paddle_tpu_opt_state: {key} has slots {sorted(own)}, "
                f"the reference's {sorted(theirs)}")
        for slot, target in own.items():
            value = np.asarray(ref_state[key][slot])
            if target.dim() == 0:
                slots[slot] = torch.tensor(value, dtype=target.dtype,
                                           device=target.device)
                continue
            if key in linear_weights:
                value = value.T
            if value.shape != tuple(target.shape):
                raise ValueError(
                    f"load_paddle_tpu_opt_state: {key}.{slot} has shape "
                    f"{np.asarray(ref_state[key][slot]).shape}, which does "
                    f"not fit a parameter of {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(value, dtype=target.dtype))
    return opt_state


def to_paddle_tpu_opt_state(module, opt_state):
    """The port's optimizer state as ``{reference key: {slot: numpy}}`` in
    the reference's layout (``Dpsgd``'s generators left out)."""
    linear_weights = _linear_weights(module)
    out = {}
    for key, slots in opt_state.items():
        out[key] = {}
        for slot, t in slots.items():
            if not isinstance(t, torch.Tensor):
                continue
            value = t.detach().cpu().numpy()
            out[key][slot] = (value.T.copy() if key in linear_weights
                              and value.ndim == 2 else value.copy())
    return out


def load_paddle_tpu_scheduler_state(scheduler, ref_state):
    """Set a port ``optimizer.lr`` scheduler to the reference scheduler's
    ``state_dict()`` (plain numbers on both sides, under the same keys);
    raises ``ValueError`` when the keys differ."""
    own = scheduler.state_dict()
    if set(own) != set(ref_state):
        raise ValueError(
            f"load_paddle_tpu_scheduler_state: keys {sorted(ref_state)}, "
            f"expected {sorted(own)}")
    scheduler.set_state_dict({k: (v.item() if isinstance(v, np.generic)
                                  else v) for k, v in ref_state.items()})
    return scheduler


def to_paddle_tpu_scheduler_state(scheduler):
    """A port scheduler's ``state_dict()`` for the reference scheduler's
    ``set_state_dict`` (the same keys and numbers)."""
    return dict(scheduler.state_dict())
