"""Optimizer base, ``Adam`` and ``AdamW``. Counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer.step`` /
``clear_grad`` / ``minimize``, ``init_state_values`` /
``functional_update``, ``Adam._init_state``/``_rule``, ``AdamW._rule`` and
``AdamW.step``).

The reference's update is a pure function that returns new parameters and
a new state (XLA code outside any Pallas kernel, with the old buffers
donated). The port keeps the same per-parameter state — ``moment1``,
``moment2``, ``beta1_pow``, ``beta2_pow`` — and the same arithmetic, in
plain torch ops (``torch._foreach_*``; on a ``FlatFusedUpdate``'s one
buffer the tensor's own ops, ``_each``), and updates parameters and
moments IN PLACE: there is no donation to port. ``beta*_pow`` are 0-dim
tensors of the parameter's dtype on its device, as in the reference, so a
step that a loss scaler or a NaN guard skips on the device keeps them too,
and no step reads a number back to the host. The states that
``init_state_values`` makes share one pair of them (a new pair replaces it
at each step), so a step forms ``1 - beta_pow`` once for every parameter
that steps together.

``functional_update(..., ok=)`` takes a 0-dim bool tensor: where it is
False the parameters, moments and ``beta*_pow`` stay bitwise as they were
(a device-side select; nothing waits for the device).

``AdamW`` follows the reference's FUNCTIONAL rule, the one its train step
uses: decoupled decay ``- lr * coeff * p`` on the old value, for every
parameter when no ``apply_decay_param_fun`` is given. When one is given it
is honoured (the reference's functional rule ignores it; its eager
``step()`` honours it — ROADMAP.md, Queue 3).

The eager API takes ``parameters=``: tensors, or ``(name, tensor)`` pairs
such as ``module.named_parameters()`` (the names are what
``apply_decay_param_fun`` sees; bare tensors are named by their position).
``step()`` updates every parameter that has a ``.grad``, ``clear_grad()``
drops the gradients, ``minimize(loss)`` is backward, step and clear.

Not ported yet: learning-rate schedulers, gradient clipping, per-parameter
regularizers and learning rates, ``amsgrad``.
"""
import torch

__all__ = ['Optimizer', 'Adam', 'AdamW']


class Optimizer:
    def __init__(self, learning_rate=0.001, weight_decay=None, grad_clip=None,
                 parameters=None):
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
        self._parameters = None
        if parameters is not None:
            self._parameters = [
                item if isinstance(item, tuple) else (str(i), item)
                for i, item in enumerate(parameters)]
        self._accumulators = {}       # name -> state, for the eager step
        self._global_step = 0

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
                          lr=None, ok=None):
        """Apply one update IN PLACE to every parameter that has a
        gradient: ``param_values[k]`` and ``opt_state[k]`` change, the rest
        stays. ``ok``: None, or a 0-dim bool tensor on the device; where it
        is False nothing changes. Returns ``(param_values, opt_state)``, the
        same objects."""
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
                         lr, ok)
        return param_values, opt_state

    def _update(self, names, params, grads, states, lr, ok, decay=None):
        raise NotImplementedError

    # -- the eager API --------------------------------------------------------
    def _named_parameters(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=model.parameters() (or "
                             "model.named_parameters())")
        return self._parameters

    @torch.no_grad()
    def step(self):
        """One update of every parameter that requires grad and has a
        ``.grad``, with the state kept on the optimizer."""
        pairs = [(n, p) for n, p in self._named_parameters()
                 if p.grad is not None and p.requires_grad]
        self.functional_update({n: p for n, p in pairs},
                               {n: p.grad for n, p in pairs},
                               self._accumulators)
        self._global_step += 1

    def clear_grad(self):
        for _, p in self._parameters or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()
        return [], []


def _each(op, *args, **kwargs):
    """``torch._foreach_<op>`` over lists of tensors, or, on lists of ONE
    tensor (a ``FlatFusedUpdate`` buffer), the tensor's own ``op``: one
    launch, where ``multi_tensor_apply`` would cut a 340M-element buffer
    into ~16 launches of its largest chunk. The same elementwise
    arithmetic either way."""
    if len(args[0]) == 1:
        first = args[0][0]
        rest = [a[0] if isinstance(a, (list, tuple)) else a
                for a in args[1:]]
        return [getattr(first, op)(*rest, **kwargs)]
    return getattr(torch, '_foreach_' + op)(*args, **kwargs)


def _select(ok, new, old):
    """``old`` becomes ``new`` where the 0-dim ``ok`` is True, in place,
    tensor by tensor; where it is False ``old`` keeps its bits."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=o)


class Adam(Optimizer):
    """``m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments, the
    reference's ``Adam._rule``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=None, grad_clip=None,
                 amsgrad=False, parameters=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        if amsgrad:
            raise NotImplementedError("Adam: amsgrad is not ported yet")
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _pows(self, value):
        one = torch.ones((), dtype=value.dtype, device=value.device)
        return one, one.clone()

    def _init_state(self, value, pows=None):
        b1p, b2p = pows if pows is not None else self._pows(value)
        return {'moment1': torch.zeros_like(value),
                'moment2': torch.zeros_like(value),
                'beta1_pow': b1p, 'beta2_pow': b2p}

    def init_state_values(self, param_values):
        # one pair of beta*_pow for each (dtype, device): the parameters of
        # one step advance it together (_update)
        shared = {}
        out = {}
        for k, v in param_values.items():
            key = (v.dtype, v.device)
            if key not in shared:
                shared[key] = self._pows(v)
            out[k] = self._init_state(v, shared[key])
        return out

    def _decay(self, names, params, lr, in_place):
        """Hook for AdamW: decay the old values (in place, or into new
        tensors) -> the list to take the Adam step from."""
        return params

    def _update(self, names, params, grads, states, lr, ok, decay=None):
        """The rule over lists. ``decay``: a replacement for ``_decay``
        (``FlatFusedUpdate``'s masked decay)."""
        decay = decay or self._decay
        b1, b2 = self._beta1, self._beta2
        m = [s['moment1'] for s in states]
        v = [s['moment2'] for s in states]
        if ok is not None:          # new tensors, selected at the end
            m, v = _each('mul', m, b1), _each('mul', v, b2)
        else:
            _each('mul_', m, b1)
            _each('mul_', v, b2)
        _each('add_', m, grads, alpha=1 - b1)
        _each('addcmul_', v, grads, grads, value=1 - b2)
        # the beta*_pow pairs these states hold (usually one), each advanced
        # once; 1 - beta_pow divides every tensor of its group
        groups = {}
        for i, s in enumerate(states):
            pair = (s['beta1_pow'], s['beta2_pow'])
            groups.setdefault(tuple(map(id, pair)), (pair, []))[1].append(i)
        groups = list(groups.values())
        new1 = _each('mul', [p[0] for p, _ in groups], b1)
        new2 = _each('mul', [p[1] for p, _ in groups], b2)
        c1 = _each('mul', new1, -1.0)
        _each('add_', c1, 1.0)                  # 1 - beta1_pow
        c2 = _each('mul', new2, -1.0)
        _each('add_', c2, 1.0)
        m_hat, denom = [None] * len(m), [None] * len(v)
        for j, (_, idx) in enumerate(groups):
            for i, mh, vh in zip(idx, _each('div', [m[i] for i in idx], c1[j]),
                                 _each('div', [v[i] for i in idx], c2[j])):
                m_hat[i], denom[i] = mh, vh
        _each('sqrt_', denom)
        _each('add_', denom, self._eps)
        # the decay falls on the old values
        if ok is None:
            decay(names, params, lr, True)
            _each('addcdiv_', params, m_hat, denom, value=-lr)
        else:
            new_p = _each('addcdiv', decay(names, params, lr, False), m_hat,
                          denom, value=-lr)
            _select(ok, new_p, params)
            _select(ok, m, [s['moment1'] for s in states])
            _select(ok, v, [s['moment2'] for s in states])
            new1 = [torch.where(ok, n, p[0]) for n, (p, _) in
                    zip(new1, groups)]
            new2 = [torch.where(ok, n, p[1]) for n, (p, _) in
                    zip(new2, groups)]
        for j, (_, idx) in enumerate(groups):
            for i in idx:
                states[i]['beta1_pow'] = new1[j]
                states[i]['beta2_pow'] = new2[j]


class AdamW(Adam):
    """Adam with decoupled weight decay ``- lr * coeff * p`` on the old
    value; ``apply_decay_param_fun(name) -> bool`` exempts parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 parameters=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, None,
                         grad_clip, parameters=parameters)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._apply_decay_fn = apply_decay_param_fun

    def _decay(self, names, params, lr, in_place):
        fn = self._apply_decay_fn
        chosen = [i for i, k in enumerate(names) if fn is None or fn(k)]
        if not chosen:
            return params
        factor = 1.0 - lr * self._coeff
        if in_place:
            _each('mul_', [params[i] for i in chosen], factor)
            return params
        out = list(params)
        for i, p in zip(chosen, _each('mul', [params[i] for i in chosen],
                                      factor)):
            out[i] = p
        return out
