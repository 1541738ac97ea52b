"""EMA, LookAhead, ModelAverage and the Recompute wrapper. Counterpart of
``paddle_tpu/optimizer/extras.py`` (``ExponentialMovingAverage``,
``LookAhead``, ``ModelAverage``, ``RecomputeOptimizer``,
``PipelineOptimizer``), on the port's eager ``step()``.

The reference holds JAX arrays, which no update can change: a slot that
stores ``p._value`` keeps that value. Here the optimizer updates each
parameter in place, so every stored value is a clone (a shadow, a backup,
LookAhead's slow weights, ModelAverage's sum), and ``apply`` / ``restore``
copy into the live parameters. ``parameters`` are tensors or ``(name,
tensor)`` pairs, as the optimizers take them; the stores are kept in that
order.

``RecomputeOptimizer`` runs each ``nn.Module`` given to
``_set_checkpoints`` under ``nn.remat``'s ``'full'`` policy: its
activations are recomputed in the backward pass, with the same dropout
masks and precision (the reference records the checkpoints and leaves
the recompute to ``jax.checkpoint``).
``PipelineOptimizer`` validates its configuration and delegates to the
inner optimizer, as the reference's: the pipeline itself is
``distributed.pipeline_apply``.
"""
import functools

import torch

from ..nn import remat as _remat

__all__ = ['ExponentialMovingAverage', 'LookAhead', 'ModelAverage',
           'PipelineOptimizer', 'RecomputeOptimizer']


def _tensors(parameters):
    return [p[1] if isinstance(p, tuple) else p for p in parameters]


class _RestoreGuard:
    def __init__(self, owner):
        self._owner = owner

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._owner.restore()
        return False


class _Swap:
    """``apply`` / ``restore`` of a stored value per parameter."""

    def _swap_in(self, values, need_restore):
        with torch.no_grad():
            self._backup = [p.detach().clone() for p in self._params]
            for p, v in zip(self._params, values):
                p.copy_(v)
        return _RestoreGuard(self) if need_restore else None

    def restore(self, executor=None):
        with torch.no_grad():
            for p, b in zip(self._params, self._backup):
                p.copy_(b)
        self._backup = []


class ExponentialMovingAverage(_Swap):
    """``shadow = d * shadow + (1 - d) * p`` at each ``update()``, with
    ``d = min(decay, (1 + n) / (10 + n))`` at the n-th update; ``apply()``
    puts the shadows in the parameters (restored on leaving its guard, or
    by ``restore()``)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = []
        self._backup = []
        self._step = 0
        self._params = []

    def register(self, parameters):
        self._params = _tensors(parameters)
        self._shadow = [p.detach().clone() for p in self._params]

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None and not self._shadow:
            self.register(parameters)
        self._step += 1
        decay = min(self._decay, (1 + self._step) / (10 + self._step))
        self._shadow = [decay * s + (1 - decay) * p.detach()
                        for s, p in zip(self._shadow, self._params)]

    def apply(self, executor=None, need_restore=True):
        return self._swap_in(self._shadow, need_restore)


class LookAhead:
    """Slow weights that follow the inner optimizer's (fast) weights every
    ``k`` steps: ``slow += alpha * (fast - slow)``, and the fast weights
    are set to them. The slow weights start as the fast weights after the
    first step, as in the reference, and are clones, never the live
    parameters."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = []
        self._step = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        params = _tensors(self.inner_optimizer._parameters or [])
        if not self._slow:
            self._slow = [p.detach().clone() for p in params]
        if self._step % self.k == 0:
            for i, p in enumerate(params):
                slow = self._slow[i] + self.alpha * (p - self._slow[i])
                self._slow[i] = slow
                p.copy_(slow)

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def state_dict(self):
        return self.inner_optimizer.state_dict()


class ModelAverage(_Swap):
    """The running sum of the parameters at each ``step()``; ``apply()``
    puts ``sum / n`` in them (restored on leaving its guard, or by
    ``restore()``)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000):
        self._params = _tensors(parameters) if parameters else []
        self._sum = [torch.zeros_like(p) for p in self._params]
        self._num = 0
        self._backup = []
        self.max_average_window = max_average_window

    @torch.no_grad()
    def step(self):
        self._num += 1
        self._sum = [s + p.detach() for s, p in zip(self._sum, self._params)]

    def apply(self, executor=None, need_restore=True):
        return self._swap_in([s / max(self._num, 1) for s in self._sum],
                             need_restore)


class PipelineOptimizer:
    """The 1.8 pipeline-training wrapper (parity: ``fluid/optimizer.py:
    3666``), as the reference's: it validates the configuration and
    delegates to the inner optimizer (``minimize`` and every other
    attribute); the microbatches are ``distributed.pipeline_apply``'s
    (``num_microbatches``), not a host scheduler's."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be a positive value.")
        if start_cpu_core_id < 0:
            raise ValueError(
                "start_cpu_core_id must be greater than or equal to 0.")
        self._optimizer = optimizer
        self._num_microbatches = num_microbatches
        self._start_cpu_core_id = start_cpu_core_id

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self._optimizer.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)


class RecomputeOptimizer:
    """The 1.8 recompute (activation checkpointing) wrapper: the inner
    optimizer's API (``backward``, ``apply_gradients``, ``apply_optimize``,
    ``minimize`` and every other attribute), and ``_set_checkpoints``,
    whose ``nn.Module`` entries then run under ``nn.remat.Remat('full')``
    whenever gradients are being recorded."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None
        self.remat = _remat.Remat('full')

    def _set_checkpoints(self, checkpoints):
        if not isinstance(checkpoints, (list, tuple)):
            raise ValueError("checkpoints should be a list or tuple")
        self._checkpoints = list(checkpoints)
        for m in self._checkpoints:
            if isinstance(m, torch.nn.Module):
                self._wrap(m)

    def _wrap(self, module):
        inner = vars(module).get('_recompute_inner', module.forward)
        remat = self.remat

        def forward(*args, **kwargs):
            if not torch.is_grad_enabled():
                return inner(*args, **kwargs)
            fn = functools.partial(inner, **kwargs) if kwargs else inner
            return remat(fn, *args)

        module._recompute_inner = inner
        module.forward = forward

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def load(self, state_dict):
        raise NotImplementedError(
            "RecomputeOptimizer.load is not supported (the reference raises "
            "here too); call set_state_dict on the inner optimizer")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self._optimizer.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
