"""Optimizer base, ``Adam`` and ``AdamW``. Counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer.init_state_values`` /
``functional_update``, ``Adam._init_state``/``_rule``, ``AdamW._rule``).

The reference's update is a pure function that returns new parameters and
a new state (XLA code outside any Pallas kernel, with the old buffers
donated). The port keeps the same per-parameter state — ``moment1``,
``moment2``, ``beta1_pow``, ``beta2_pow`` — and the same arithmetic, in
plain torch ops (``torch._foreach_*``), and updates parameters and moments
IN PLACE: there is no donation to port. ``beta*_pow`` are numbers of the
parameter's precision (numpy float32, or float64 for a float64 parameter)
kept on the host, so forming ``1 - beta_pow`` needs no device round trip.

``AdamW`` follows the reference's FUNCTIONAL rule, the one its train step
uses: decoupled decay ``- lr * coeff * p`` on the old value, for every
parameter when no ``apply_decay_param_fun`` is given. When one is given it
is honoured (the reference's functional rule ignores it; its eager
``step()`` honours it — ROADMAP.md, Queue 3).

Not ported yet: learning-rate schedulers, gradient clipping, per-parameter
regularizers and learning rates, ``amsgrad``, the eager ``step()``.
"""
import numpy as np
import torch

__all__ = ['Optimizer', 'Adam', 'AdamW']


class Optimizer:
    def __init__(self, learning_rate=0.001, weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "optimizer: learning-rate schedulers (optimizer/lr.py) come "
                "with the next training slice; pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "optimizer: grad_clip is not ported yet")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "optimizer: regularizer objects are not ported yet; pass "
                "weight_decay as a float (an L2 term coeff * p added to the "
                "gradient)")
        self._lr = float(learning_rate)
        self._weight_decay = None if weight_decay is None \
            else float(weight_decay)

    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    def _init_state(self, value):
        return {}

    def init_state_values(self, param_values):
        """``param_values``: ``{name: tensor}`` -> ``{name: state}``."""
        return {k: self._init_state(v) for k, v in param_values.items()}

    @torch.no_grad()
    def functional_update(self, param_values, grad_values, opt_state,
                          lr=None):
        """Apply one update IN PLACE to every parameter that has a
        gradient: ``param_values[k]`` and ``opt_state[k]`` change, the rest
        stays. Returns ``(param_values, opt_state)``, the same objects."""
        lr = self.get_lr() if lr is None else float(lr)
        names = [k for k, g in grad_values.items() if g is not None]
        for k in names:
            if k not in opt_state:
                opt_state[k] = self._init_state(param_values[k])
        params = [param_values[k] for k in names]
        grads = [grad_values[k].to(param_values[k].dtype) for k in names]
        if self._weight_decay is not None and names:
            grads = torch._foreach_add(grads, params,
                                       alpha=self._weight_decay)
        if names:
            self._update(names, params, grads, [opt_state[k] for k in names],
                         lr)
        return param_values, opt_state

    def _update(self, names, params, grads, states, lr):
        raise NotImplementedError


class Adam(Optimizer):
    """``m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments, the
    reference's ``Adam._rule``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=None, grad_clip=None,
                 amsgrad=False):
        super().__init__(learning_rate, weight_decay, grad_clip)
        if amsgrad:
            raise NotImplementedError("Adam: amsgrad is not ported yet")
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _init_state(self, value):
        one = np.float64 if value.dtype == torch.float64 else np.float32
        return {'moment1': torch.zeros_like(value),
                'moment2': torch.zeros_like(value),
                'beta1_pow': one(1.0), 'beta2_pow': one(1.0)}

    def _decayed(self, names, params, lr):
        """Hook for AdamW: decay ``params`` in place before the step."""

    def _update(self, names, params, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        m = [s['moment1'] for s in states]
        v = [s['moment2'] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        for s in states:
            kind = type(s['beta1_pow'])        # the parameter's precision
            s['beta1_pow'] = s['beta1_pow'] * kind(b1)
            s['beta2_pow'] = s['beta2_pow'] * kind(b2)
        m_hat = torch._foreach_div(
            m, [float(1 - s['beta1_pow']) for s in states])
        denom = torch._foreach_div(
            v, [float(1 - s['beta2_pow']) for s in states])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        self._decayed(names, params, lr)      # on the old values
        torch._foreach_addcdiv_(params, m_hat, denom, value=-lr)


class AdamW(Adam):
    """Adam with decoupled weight decay ``- lr * coeff * p`` on the old
    value; ``apply_decay_param_fun(name) -> bool`` exempts parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, None,
                         grad_clip)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._apply_decay_fn = apply_decay_param_fun

    def _decayed(self, names, params, lr):
        fn = self._apply_decay_fn
        chosen = [p for k, p in zip(names, params) if fn is None or fn(k)]
        if chosen:
            torch._foreach_mul_(chosen, 1.0 - lr * self._coeff)
