"""Weight-decay regularizers. Counterpart of ``paddle_tpu/nn/regularizer.py``
(``L1Decay``, ``L2Decay``, their ``loss`` and ``grad_term``, the fluid
aliases).

A regularizer adds its term to the gradient before the clip and the
optimizer's rule (``Optimizer.functional_update``): ``coeff * p`` for
``L2Decay``, ``coeff * sign(p)`` for ``L1Decay``. ``grad_terms`` is the
same over lists of tensors, one ``torch._foreach_*`` call, which is how
the optimizer applies it.
"""
import torch

__all__ = ['WeightDecayRegularizer', 'L1Decay', 'L2Decay',
           'L1DecayRegularizer', 'L2DecayRegularizer']


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def loss(self, param):
        raise NotImplementedError

    def grad_term(self, param_value):
        """The term added to the raw gradient of ``param_value``."""
        raise NotImplementedError

    def add_grad_terms(self, grads, params):
        """``[g + grad_term(p)]`` over lists, as new tensors."""
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def loss(self, param):
        return self._coeff * 0.5 * (param * param).sum()

    def grad_term(self, param_value):
        return self._coeff * param_value

    def add_grad_terms(self, grads, params):
        return torch._foreach_add(grads, params, alpha=self._coeff)

    def __repr__(self):
        return f"L2Decay(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    def loss(self, param):
        return self._coeff * param.abs().sum()

    def grad_term(self, param_value):
        return self._coeff * torch.sign(param_value)

    def add_grad_terms(self, grads, params):
        return torch._foreach_add(grads, torch._foreach_sign(params),
                                  alpha=self._coeff)

    def __repr__(self):
        return f"L1Decay(coeff={self._coeff})"


# fluid aliases
L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
