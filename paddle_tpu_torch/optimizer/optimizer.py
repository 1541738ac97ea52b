"""Optimizer base and the optimizers. Counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``Optimizer`` with its learning
rate, state dict, decay and clip plumbing, eager ``step`` / ``minimize`` /
``backward`` / ``apply_gradients``, ``init_state_values`` /
``functional_update``; ``SGD``, ``Momentum``, ``Adam`` (``amsgrad``),
``AdamW``, ``Adamax``, ``Adadelta``, ``Adagrad``, ``RMSProp``, ``Lamb``,
``LarsMomentum``, ``Ftrl``, ``DecayedAdagrad``, ``Dpsgd``).

The reference's update is a pure per-parameter rule ``_rule(g, p, state,
lr)`` (XLA code outside any Pallas kernel, the old buffers donated). The
port keeps each optimizer's per-parameter state under the reference's
names (``moment1``, ``velocity``, ``inf_norm``, ``avg_squared_grad``, ...)
and its arithmetic, in plain torch ops over lists of tensors
(``torch._foreach_*``; on a ``FlatFusedUpdate``'s one buffer the
tensor's own ops, ``_each``), and updates the parameters IN PLACE: there
is no donation to port. ``beta*_pow`` are 0-dim tensors of the
parameter's dtype on its device; the states ``init_state_values`` makes
share one of each (a new one replaces it at each step), so a step forms
``1 - beta_pow`` once for every parameter that steps together.

``functional_update(param_values, grad_values, opt_state, lr=None,
ok=None, params_meta=None)`` follows the reference's order: each
gradient gets its parameter's regularizer (``params_meta[k].regularizer``,
from ``nn.initializer.ParamAttr``), else the optimizer's ``weight_decay``
(a float is an ``L2Decay``); then the ``grad_clip`` (honouring
``need_clip``); then the rule at ``lr * optimize_attr['learning_rate']``.
The learning rate is read from the optimizer (``get_lr()``: a float, or an
``lr.LRScheduler``'s current value) at every call, as a Python number: a
step never copies it to the device and never waits for it. ``ok``: None,
or a 0-dim bool tensor on the device; where it is False the parameters and
every state tensor stay bitwise as they were (the update is computed out
of place and selected with ``torch.where(ok, new, old, out=old)``).

Where the port departs from the reference (ROADMAP.md, Queue 3):
``AdamW`` honours ``apply_decay_param_fun`` and ``Lamb`` honours
``exclude_from_weight_decay_fn`` (both called with the parameter's name);
the reference's functional rules decay every parameter. ``Lamb``'s and
``LarsMomentum``'s per-tensor norms and ``Dpsgd``'s clip are 0-dim
tensors and their ratios ``torch.where`` selects, never a Python ``if``.
``Dpsgd`` draws its noise from one ``torch.Generator`` a parameter, seeded
from ``seed`` and the parameter's index, as the reference folds the index
into its key.

The eager API takes ``parameters=``: tensors, or ``(name, tensor)`` pairs
such as ``module.named_parameters()`` (bare tensors are named by their
position). ``step()`` updates every parameter that requires grad and has a
``.grad``; ``clear_grad()``, ``minimize(loss)``, the split-phase
``backward`` / ``apply_gradients`` / ``apply_optimize``, and
``state_dict`` / ``set_state_dict`` (``global_step``, ``LR_Scheduler``,
matching by name or, for a renamed copy of the model, by position) are
the reference's. Its static-graph branches wait for ``static/``.
"""
import warnings

import numpy as np
import torch

from ..nn.clip import ClipGradBase
from ..nn.regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ['Optimizer', 'SGD', 'Momentum', 'Adam', 'AdamW', 'Adamax',
           'Adadelta', 'Adagrad', 'RMSProp', 'Lamb', 'LarsMomentum', 'Ftrl',
           'DecayedAdagrad', 'Dpsgd', 'DpsgdOptimizer',
           'DecayedAdagradOptimizer']


class _NoMeta:
    """What a parameter without attributes looks like to the clip."""
    need_clip = True
    regularizer = None
    optimize_attr = {}


def _lr_mult(meta):
    return float(getattr(meta, 'optimize_attr', {}).get('learning_rate',
                                                         1.0))


class Optimizer:
    def __init__(self, learning_rate=0.001, weight_decay=None, grad_clip=None,
                 parameters=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"optimizer: learning_rate must be a float or an "
                f"optimizer.lr.LRScheduler, got {learning_rate!r}")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(
                f"optimizer: grad_clip must be an nn.clip clip "
                f"(ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm), "
                f"got {grad_clip!r}")
        if isinstance(weight_decay, (int, float)) and not isinstance(
                weight_decay, bool):
            weight_decay = L2Decay(float(weight_decay))
        if weight_decay is not None and not isinstance(
                weight_decay, WeightDecayRegularizer):
            raise TypeError(
                f"optimizer: weight_decay must be a float or an "
                f"nn.regularizer regularizer, got {weight_decay!r}")
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._parameters = None
        if parameters is not None:
            self._parameters = [
                item if isinstance(item, tuple) else (str(i), item)
                for i, item in enumerate(parameters)]
        self._accumulators = {}       # name -> state, for the eager step
        self._global_step = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- state ---------------------------------------------------------------
    def _init_state(self, value):
        return {}

    def init_state_values(self, param_values):
        """``param_values``: ``{name: tensor}`` -> ``{name: state}``."""
        return {k: self._init_state(v) for k, v in param_values.items()}

    def state_dict(self):
        """``{'<param>.<slot>': tensor, ..., 'global_step': n}`` plus
        ``'LR_Scheduler'`` under a scheduler; parameter order."""
        out = {}
        order = [n for n, _ in (self._parameters or [])
                 if n in self._accumulators]
        order += [n for n in self._accumulators if n not in order]
        for pname in order:
            for sname, v in self._accumulators[pname].items():
                out[f"{pname}.{sname}"] = v
        out['global_step'] = self._global_step
        if isinstance(self._lr, LRScheduler):
            out['LR_Scheduler'] = self._lr.state_dict()
        return out

    def set_state_dict(self, state_dict):
        """Restore ``state_dict()``'s output: by parameter name, or by
        position when the names are all new and the counts agree (a
        renamed copy of the model); mis-shaped slots raise."""
        self._global_step = int(state_dict.get('global_step', 0))
        if 'LR_Scheduler' in state_dict and isinstance(self._lr,
                                                       LRScheduler):
            self._lr.set_state_dict(state_dict['LR_Scheduler'])
        grouped = {}
        for k, v in state_dict.items():
            if k in ('global_step', 'LR_Scheduler'):
                continue
            pname, _, sname = k.rpartition('.')
            if isinstance(v, np.ndarray) or np.isscalar(v):
                v = torch.as_tensor(np.asarray(v))
            grouped.setdefault(pname, {})[sname] = v
        cur = list(self._parameters or [])
        cur_names = [n for n, _ in cur]
        overlap = set(grouped) & set(cur_names)
        if cur_names and not overlap and len(grouped) == len(cur_names):
            for (name, p), (old, slots) in zip(cur, grouped.items()):
                for sname, v in slots.items():
                    if _shape_of(v) and _shape_of(v) != tuple(p.shape):
                        raise ValueError(
                            "optimizer.set_state_dict: cannot positionally "
                            "map saved state '%s.%s' (shape %s) onto "
                            "parameter '%s' (shape %s); the checkpoint was "
                            "saved from a different model" %
                            (old, sname, _shape_of(v), name,
                             tuple(p.shape)))
            grouped = dict(zip(cur_names, grouped.values()))
        elif cur_names and grouped and not overlap:
            raise ValueError(
                "optimizer.set_state_dict: none of the %d saved state "
                "group(s) match the %d current parameter(s) by name, and "
                "the counts differ so they cannot be mapped positionally "
                "(saved e.g. %s; current e.g. %s)"
                % (len(grouped), len(cur_names), sorted(grouped)[:3],
                   cur_names[:3]))
        elif cur_names and overlap and set(grouped) != set(cur_names):
            unmatched = sorted(set(grouped) - set(cur_names))
            if unmatched:
                warnings.warn(
                    "optimizer.set_state_dict: %d saved state group(s) have "
                    "no matching parameter and were ignored: %s"
                    % (len(unmatched), unmatched[:5]))
                grouped = {k: v for k, v in grouped.items()
                           if k in cur_names}
        by_name = dict(cur)
        shared = {}

        def restored(sname, v, device):
            # copies: the restored slots are updated in place later; the
            # 0-dim ones of one value (beta*_pow) become one tensor again,
            # as init_state_values makes them
            if not isinstance(v, torch.Tensor):
                return v
            if v.dim():
                return v.detach().to(device, copy=True)
            key = (sname, v.dtype, str(device), v.detach().cpu().reshape(1)
                   .view(torch.uint8).numpy().tobytes())
            if key not in shared:
                shared[key] = v.detach().to(device, copy=True)
            return shared[key]
        for pname, slots in grouped.items():
            p = by_name.get(pname)
            if p is not None:
                for sname, v in slots.items():
                    if _shape_of(v) and _shape_of(v) != tuple(p.shape):
                        raise ValueError(
                            "optimizer.set_state_dict: saved state '%s.%s' "
                            "has shape %s but parameter '%s' has shape %s; "
                            "the checkpoint was saved from a different model"
                            % (pname, sname, _shape_of(v), pname,
                               tuple(p.shape)))
            slots = {s: restored(s, v, p.device if p is not None
                                 else getattr(v, 'device', None))
                     for s, v in slots.items()}
            self._accumulators.setdefault(pname, {}).update(slots)

    set_dict = set_state_dict

    # -- the update ----------------------------------------------------------
    @torch.no_grad()
    def functional_update(self, param_values, grad_values, opt_state,
                          lr=None, ok=None, params_meta=None):
        """Apply one update IN PLACE to every parameter that has a
        gradient: ``param_values[k]`` and ``opt_state[k]`` change, the rest
        stays. ``params_meta``: optional ``{name: parameter}`` whose
        ``ParamAttr`` attributes (learning rate, regularizer, ``need_clip``)
        apply. ``ok``: None, or a 0-dim bool tensor on the device; where it
        is False nothing changes. Returns ``(param_values, opt_state)``, the
        same objects."""
        lr = self.get_lr() if lr is None else float(lr)
        names = [k for k, g in grad_values.items() if g is not None]
        if not names:
            return param_values, opt_state
        missing = {k: param_values[k] for k in names if k not in opt_state}
        if missing:
            # made together, so that they share one pair of beta*_pow (the
            # Adam family), which a step advances and divides by once
            opt_state.update(self.init_state_values(missing))
        metas = [(params_meta or {}).get(k, _NoMeta) for k in names]
        params = [param_values[k] for k in names]
        grads = [grad_values[k].to(param_values[k].dtype) for k in names]
        grads = self._regularize(params, grads, metas)
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(metas, grads)))]
        states = [opt_state[k] for k in names]
        groups = {}
        for i, m in enumerate(metas):
            groups.setdefault(_lr_mult(m), []).append(i)
        for mult, idx in groups.items():
            self._update([names[i] for i in idx], [params[i] for i in idx],
                         [grads[i] for i in idx], [states[i] for i in idx],
                         lr * mult, ok)
        return param_values, opt_state

    def _regularize(self, params, grads, metas):
        """Each gradient plus its parameter's regularizer term (the
        parameter's own, else the optimizer's)."""
        by_reg = {}
        for i, m in enumerate(metas):
            reg = getattr(m, 'regularizer', None) or self._weight_decay
            if reg is not None:
                by_reg.setdefault(id(reg), (reg, []))[1].append(i)
        if not by_reg:
            return grads
        grads = list(grads)
        for reg, idx in by_reg.values():
            for i, g in zip(idx, reg.add_grad_terms(
                    [grads[i] for i in idx], [params[i] for i in idx])):
                grads[i] = g
        return grads

    def _update(self, names, params, grads, states, lr, ok):
        """The rule over lists of one learning rate ``lr`` (a float, or on
        a ``FlatFusedUpdate``'s buffer possibly a tensor of per-element
        rates)."""
        raise NotImplementedError

    # -- the eager API --------------------------------------------------------
    def _named_parameters(self):
        if self._parameters is None:
            raise ValueError("Optimizer created without parameters; pass "
                             "parameters=model.parameters() (or "
                             "model.named_parameters())")
        return self._parameters

    def _apply(self, pairs):
        """One update of ``(name, param, grad)`` triples with the state
        kept on the optimizer."""
        self.functional_update({n: p for n, p, _ in pairs},
                               {n: g for n, _, g in pairs},
                               self._accumulators,
                               params_meta={n: p for n, p, _ in pairs})
        self._global_step += 1

    @torch.no_grad()
    def step(self):
        """One update of every parameter that requires grad and has a
        ``.grad``, with the state kept on the optimizer."""
        self._apply([(n, p, p.grad) for n, p in self._named_parameters()
                     if p.grad is not None and p.requires_grad])

    def clear_grad(self):
        for _, p in self._parameters or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return [], []

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """The 1.8 split-phase API: compute the gradients -> ``[(param,
        grad)]``."""
        loss.backward()
        params = parameter_list if parameter_list is not None else \
            [p for _, p in self._parameters or []]
        return [(p, p.grad) for p in params if p.grad is not None]

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        """The 1.8 split-phase API: apply the ``(param, grad)`` pairs given
        (the gradients given, not the stored ``.grad``)."""
        names = {id(p): n for n, p in self._parameters or []}
        self._apply([(names.get(id(p), str(i)), p, g)
                     for i, (p, g) in enumerate(params_grads)
                     if g is not None])
        return []

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)


def _shape_of(v):
    return tuple(getattr(v, 'shape', ()))


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
    return list(getattr(torch, '_foreach_' + op)(*args, **kwargs))


def _select(ok, new, old):
    """``old`` becomes ``new`` where the 0-dim ``ok`` is True, in place,
    tensor by tensor; where it is False ``old`` keeps its bits."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=o)


def _set_slot(states, slot, new, ok):
    """``states[i][slot]`` becomes ``new[i]``: the new tensor itself, or
    under ``ok`` a select into the old one."""
    if ok is None:
        for s, t in zip(states, new):
            s[slot] = t
    else:
        _select(ok, new, [s[slot] for s in states])


def _descend(params, delta, ok):
    """``p -= delta`` in place (where ``ok``)."""
    if ok is None:
        _each('sub_', params, delta)
    else:
        _select(ok, _each('sub', params, delta), params)


def _times_lr(xs, lr):
    """``lr * x`` for each ``x``: ``lr`` a float, or a tensor of rates."""
    return _each('mul', xs, lr)


def _scalar_groups(states, slot):
    """The distinct 0-dim ``slot`` tensors the states hold (usually one,
    shared) -> ``[(tensor, [state indices])]``."""
    groups = {}
    for i, s in enumerate(states):
        groups.setdefault(id(s[slot]), (s[slot], []))[1].append(i)
    return list(groups.values())


def _advance_pow(states, slot, beta, ok):
    """Multiply each distinct ``slot`` power by ``beta`` (kept where not
    ``ok``) -> ``[(1 - new power, [state indices])]``."""
    out = []
    for old, idx in _scalar_groups(states, slot):
        new = old * beta
        if ok is not None:
            new = torch.where(ok, new, old)
        for i in idx:
            states[i][slot] = new
        out.append((1.0 - new, idx))
    return out


def _per_group(xs, groups, op):
    """``op(x, group value)`` for each ``x``, the group value of its
    state; -> a list in ``xs``'s order."""
    out = [None] * len(xs)
    for value, idx in groups:
        for i, r in zip(idx, _each(op, [xs[i] for i in idx], value)):
            out[i] = r
    return out


def _norms(tensors):
    """Each tensor's L2 norm, stacked into one fp32 vector."""
    return torch.stack([n.float() for n in torch._foreach_norm(tensors)])


def _pows(value):
    one = torch.ones((), dtype=value.dtype, device=value.device)
    return one, one.clone()


class SGD(Optimizer):
    """``p - lr * g``."""

    def _update(self, names, params, grads, states, lr, ok):
        _descend(params, _times_lr(grads, lr), ok)


class Momentum(Optimizer):
    """``v = mu v + g``; ``p - lr v``, or with Nesterov ``p - lr (g + mu
    v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, value):
        return {'velocity': torch.zeros_like(value)}

    def _update(self, names, params, grads, states, lr, ok):
        v = _each('mul', [s['velocity'] for s in states], self._momentum)
        _each('add_', v, grads)
        if self._nesterov:
            step = _each('add', grads, v, alpha=self._momentum)
        else:
            step = v
        _descend(params, _times_lr(step, lr), ok)
        _set_slot(states, 'velocity', v, ok)


class Adam(Optimizer):
    """``m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments, the
    reference's ``Adam._rule``; ``amsgrad`` divides by the running maximum
    of the second moment (``moment2_max``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=None, grad_clip=None,
                 amsgrad=False, parameters=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._amsgrad = bool(amsgrad)

    def _init_state(self, value, pows=None):
        b1p, b2p = pows if pows is not None else _pows(value)
        st = {'moment1': torch.zeros_like(value),
              'moment2': torch.zeros_like(value),
              'beta1_pow': b1p, 'beta2_pow': b2p}
        if self._amsgrad:
            st['moment2_max'] = torch.zeros_like(value)
        return st

    def init_state_values(self, param_values):
        # one pair of beta*_pow for each (dtype, device): the parameters of
        # one step advance it together (_update)
        shared = {}
        out = {}
        for k, v in param_values.items():
            key = (v.dtype, v.device)
            if key not in shared:
                shared[key] = _pows(v)
            out[k] = self._init_state(v, shared[key])
        return out

    def _decay(self, names, params, lr, in_place):
        """Hook for AdamW: decay the old values (in place, or into new
        tensors) -> the list to take the Adam step from."""
        return params

    def _moments(self, grads, states, ok):
        """The new first and second moments (in the states' own tensors
        when there is no ``ok``, else new ones), the denominator's second
        moment (amsgrad: the running maximum) and the two ``(1 - beta_pow,
        indices)`` group lists."""
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
        v_den = v
        if self._amsgrad:
            v_den = _each('maximum', [s['moment2_max'] for s in states], v)
            _set_slot(states, 'moment2_max', v_den, ok)
        if ok is not None:
            _select(ok, m, [s['moment1'] for s in states])
            _select(ok, v, [s['moment2'] for s in states])
        # the beta*_pow pairs these states hold (usually one), each advanced
        # once; 1 - beta_pow divides every tensor of its group
        c1 = _advance_pow(states, 'beta1_pow', b1, ok)
        c2 = _advance_pow(states, 'beta2_pow', b2, ok)
        return m, v_den, c1, c2

    def _direction(self, grads, states, ok):
        """``m_hat / (sqrt(v_hat) + eps)`` as new tensors, the moments and
        powers advanced (kept where not ``ok``)."""
        m, v, c1, c2 = self._moments(grads, states, ok)
        m_hat = _per_group(m, c1, 'div')
        denom = _per_group(v, c2, 'div')
        _each('sqrt_', denom)
        _each('add_', denom, self._eps)
        return m_hat, denom

    def _update(self, names, params, grads, states, lr, ok, decay=None):
        """The rule over lists. ``decay``: a replacement for ``_decay``
        (``FlatFusedUpdate``'s masked decay)."""
        decay = decay or self._decay
        m_hat, denom = self._direction(grads, states, ok)
        if isinstance(lr, torch.Tensor):            # per-element rates
            m_hat = _each('mul', m_hat, lr)
            value = -1.0
        else:
            value = -lr
        # the decay falls on the old values
        if ok is None:
            decay(names, params, lr, True)
            _each('addcdiv_', params, m_hat, denom, value=value)
        else:
            new_p = _each('addcdiv', decay(names, params, lr, False), m_hat,
                          denom, value=value)
            _select(ok, new_p, params)


class AdamW(Adam):
    """Adam with decoupled weight decay ``- lr * coeff * p`` on the old
    value; ``apply_decay_param_fun(name) -> bool`` exempts parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 parameters=None, amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, None,
                         grad_clip, amsgrad, parameters=parameters)
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


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``; ``p - lr / (1 -
    b1^t) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, value, pow1=None):
        return {'moment': torch.zeros_like(value),
                'inf_norm': torch.zeros_like(value),
                'beta1_pow': pow1 if pow1 is not None else _pows(value)[0]}

    def init_state_values(self, param_values):
        shared = {}
        out = {}
        for k, v in param_values.items():
            key = (v.dtype, v.device)
            if key not in shared:
                shared[key] = _pows(v)[0]
            out[k] = self._init_state(v, shared[key])
        return out

    def _update(self, names, params, grads, states, lr, ok):
        b1, b2 = self._beta1, self._beta2
        m = _each('mul', [s['moment'] for s in states], b1)
        _each('add_', m, grads, alpha=1 - b1)
        u = _each('maximum', _each('mul', [s['inf_norm'] for s in states],
                                   b2), _each('abs', grads))
        c1 = _advance_pow(states, 'beta1_pow', b1, ok)
        # lr / (1 - b1p) * m / (u + eps), in the reference's order
        delta = _per_group(m, [(lr / c, idx) for c, idx in c1], 'mul')
        _each('div_', delta, _each('add', u, self._eps))
        _descend(params, delta, ok)
        _set_slot(states, 'moment', m, ok)
        _set_slot(states, 'inf_norm', u, ok)


class Adadelta(Optimizer):
    """``E[g^2]``, ``update = g sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps)``,
    ``E[dx^2]``; ``p - lr * update``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._rho, self._eps = rho, epsilon

    def _init_state(self, value):
        return {'avg_squared_grad': torch.zeros_like(value),
                'avg_squared_update': torch.zeros_like(value)}

    def _update(self, names, params, grads, states, lr, ok):
        rho, eps = self._rho, self._eps
        asg = _each('mul', [s['avg_squared_grad'] for s in states], rho)
        _each('addcmul_', asg, grads, grads, value=1 - rho)
        old_asu = [s['avg_squared_update'] for s in states]
        update = _each('mul', grads, _each('sqrt', _each('add', old_asu,
                                                         eps)))
        _each('div_', update, _each('sqrt', _each('add', asg, eps)))
        asu = _each('mul', old_asu, rho)
        _each('addcmul_', asu, update, update, value=1 - rho)
        _descend(params, _times_lr(update, lr), ok)
        _set_slot(states, 'avg_squared_grad', asg, ok)
        _set_slot(states, 'avg_squared_update', asu, ok)


class Adagrad(Optimizer):
    """``m = m + g^2``; ``p - lr g / (sqrt(m) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, value):
        return {'moment': torch.full_like(value, self._init_acc)}

    def _update(self, names, params, grads, states, lr, ok):
        m = _each('addcmul', [s['moment'] for s in states], grads, grads)
        _scaled_root_step(params, grads, m, lr, self._eps, ok)
        _set_slot(states, 'moment', m, ok)


def _scaled_root_step(params, grads, m, lr, eps, ok):
    """``p - lr * g / (sqrt(m) + eps)`` (Adagrad, DecayedAdagrad)."""
    denom = _each('sqrt', m)
    _each('add_', denom, eps)
    _descend(params, _each('div', _times_lr(grads, lr), denom), ok)


class RMSProp(Optimizer):
    """``E[g^2]`` (centered: minus ``E[g]^2``), ``mom = momentum mom + lr g /
    sqrt(. + eps)``; ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, value):
        st = {'mean_square': torch.zeros_like(value),
              'momentum': torch.zeros_like(value)}
        if self._centered:
            st['mean_grad'] = torch.zeros_like(value)
        return st

    def _update(self, names, params, grads, states, lr, ok):
        rho, eps = self._rho, self._eps
        ms = _each('mul', [s['mean_square'] for s in states], rho)
        _each('addcmul_', ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = _each('mul', [s['mean_grad'] for s in states], rho)
            _each('add_', mg, grads, alpha=1 - rho)
            denom = _each('addcmul', ms, mg, mg, value=-1.0)
            _each('add_', denom, eps)
        else:
            denom = _each('add', ms, eps)
        _each('sqrt_', denom)
        mom = _each('mul', [s['momentum'] for s in states], self._momentum)
        _each('add_', mom, _each('div', _times_lr(grads, lr), denom))
        _descend(params, mom, ok)
        _set_slot(states, 'mean_square', ms, ok)
        _set_slot(states, 'momentum', mom, ok)
        if self._centered:
            _set_slot(states, 'mean_grad', mg, ok)


class Lamb(Optimizer):
    """Adam's bias-corrected direction plus ``lamb_weight_decay * p``,
    scaled per tensor by the trust ratio ``||p|| / ||r||`` (1 where either
    norm is 0). ``exclude_from_weight_decay_fn(name) -> bool`` exempts
    parameters from the decay (the reference stores it and decays every
    parameter: ROADMAP.md, Queue 3)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, None, grad_clip, parameters)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn
        self._amsgrad = False

    _init_state = Adam._init_state
    init_state_values = Adam.init_state_values
    _moments = Adam._moments
    _direction = Adam._direction

    def _update(self, names, params, grads, states, lr, ok):
        r = _each('div', *self._direction(grads, states, ok))
        fn = self._exclude_fn
        decayed = [i for i, k in enumerate(names) if fn is None or not fn(k)]
        if decayed and self._wd:
            for i, t in zip(decayed, _each(
                    'add', [r[i] for i in decayed],
                    [params[i] for i in decayed], alpha=self._wd)):
                r[i] = t
        w_norm, r_norm = _norms(params), _norms(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        step = torch._foreach_mul(_times_lr(r, lr), list(trust.unbind(0)))
        _descend(params, step, ok)


class LarsMomentum(Optimizer):
    """``local_lr = coeff ||p|| / (||g|| + wd ||p|| + eps)`` per tensor (1
    where either norm is 0); ``v = mu v + lr local_lr (g + wd p)``; ``p -
    v``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, name=None):
        super().__init__(learning_rate, None, grad_clip, parameters)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._eps = epsilon

    def _init_state(self, value):
        return {'velocity': torch.zeros_like(value)}

    def _update(self, names, params, grads, states, lr, ok):
        w_norm, g_norm = _norms(params), _norms(grads)
        local = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + self._wd * w_norm + self._eps),
            torch.ones_like(w_norm))
        gw = _each('add', grads, params, alpha=self._wd)
        torch._foreach_mul_(gw, list((lr * local).unbind(0)))
        v = _each('mul', [s['velocity'] for s in states], self._momentum)
        _each('add_', v, gw)
        _descend(params, v, ok)
        _set_slot(states, 'velocity', v, ok)


class Ftrl(Optimizer):
    """FTRL-proximal: ``n += g^2``, ``z += g - (n_new^-k - n^-k) / lr p``;
    ``p = 0`` where ``|z| <= l1``, else ``(sign(z) l1 - z) / (n_new^-k / lr
    + 2 l2)`` (``k`` = ``lr_power``)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, None, grad_clip, parameters)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_state(self, value):
        return {'squared': torch.zeros_like(value),
                'linear': torch.zeros_like(value)}

    def _update(self, names, params, grads, states, lr, ok):
        k = -self._lr_power
        n = [s['squared'] for s in states]
        new_n = _each('addcmul', n, grads, grads)
        pn_new = _each('pow', new_n, k)
        sigma = _each('div', _each('sub', pn_new, _each('pow', n, k)), lr)
        z = _each('add', [s['linear'] for s in states], grads)
        _each('sub_', z, _each('mul', sigma, params))
        denom = _each('div', pn_new, lr)
        _each('add_', denom, 2 * self._l2)
        shrunk = _each('mul', _each('sign', z), self._l1)
        _each('sub_', shrunk, z)
        _each('div_', shrunk, denom)
        new_p = [torch.where(zi.abs() <= self._l1, torch.zeros_like(si), si)
                 for zi, si in zip(z, shrunk)]
        if ok is None:
            _each('copy_', params, new_p)
        else:
            _select(ok, new_p, params)
        _set_slot(states, 'squared', new_n, ok)
        _set_slot(states, 'linear', z, ok)


class DecayedAdagrad(Optimizer):
    """Adagrad with an exponentially decayed accumulator: ``m = decay m +
    (1 - decay) g^2``; ``p - lr g / (sqrt(m) + eps)``."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-06,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, weight_decay, grad_clip, parameters)
        self._decay, self._eps = decay, epsilon

    def _init_state(self, value):
        return {'moment': torch.zeros_like(value)}

    def _update(self, names, params, grads, states, lr, ok):
        m = _each('mul', [s['moment'] for s in states], self._decay)
        _each('addcmul_', m, grads, grads, value=1 - self._decay)
        _scaled_root_step(params, grads, m, lr, self._eps, ok)
        _set_slot(states, 'moment', m, ok)


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to an L2 norm of
    ``clip`` (divided by ``max(||g|| / clip, 1)``), plus one Gaussian
    sample ``N(0, sigma) / batch_size`` added to every element; ``p - lr
    (g / scale + noise)``. The noise of parameter ``i`` (in the order the
    states are made) comes from its own ``torch.Generator`` (``key`` in the
    state), seeded from ``(seed, i)``, so no two tensors share a stream
    and drawing never waits for the device. A step skipped under ``ok``
    keeps the parameters but not the stream's position (the reference's
    select keeps its key)."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, parameters=None, seed=0):
        super().__init__(learning_rate, None, None, parameters)
        self._dp_clip, self._batch_size, self._sigma = clip, batch_size, sigma
        self._seed = seed
        self._n_keys = 0

    def _init_state(self, value):
        self._n_keys += 1
        seed = np.random.SeedSequence([int(self._seed), self._n_keys]
                                      ).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=value.device)
        gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
        return {'key': gen}

    def _update(self, names, params, grads, states, lr, ok):
        norm = _norms(grads)
        scale = torch.clamp_min(norm / self._dp_clip, 1.0)
        clipped = torch._foreach_div(
            grads, [s.to(g.dtype) for s, g in zip(scale.unbind(0), grads)])
        noise = [(torch.randn((), generator=s['key'], device=p.device)
                  * self._sigma / self._batch_size).to(p.dtype)
                 for s, p in zip(states, params)]
        _each('add_', clipped, noise)
        _descend(params, _times_lr(clipped, lr), ok)


DpsgdOptimizer = Dpsgd
DecayedAdagradOptimizer = DecayedAdagrad
