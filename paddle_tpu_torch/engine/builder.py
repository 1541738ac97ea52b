"""One train step: forward, backward, optimizer update. Counterpart of
``paddle_tpu/engine/builder.py`` (``build_train_step``, ``TrainStep``
with ``_one_step``, ``_advance_scaler`` and ``sync``, ``StepResult``,
``DeviceLoss``).

The reference compiles a pure function ``(state, batch, key) -> (state,
loss, outputs)`` with ``jax.jit`` and donates the old state. PyTorch runs
eagerly, so the port's step is a plain callable with the same shape of
call — ``state, result = step(state, batch)`` — that differentiates with
``torch.autograd.grad`` and lets the optimizer update parameters and
moments in place; ``state`` is returned for the reference's calling
convention and is the same object. There is no key: a model's dropout
draws from its own ``DropoutState``. **A step never waits for the
device**: the loss stays there until ``float()`` is called on it, and the
loss scaler and the NaN guard run on the device too.

- ``scaler=`` (an ``amp.GradScaler``; a disabled one counts as none): the
  loss is multiplied by the scale in ``state['scaler']['scale']``, the
  gradients divided by it; the step is ``ok`` when the loss and every
  gradient are finite, and the scaler's dynamic policy advances on the
  device (``state['scaler']``: ``scale``, ``good``, ``bad``).
- ``nan_guard=True``: the step is ``ok`` only with a finite loss; the
  counters ``steps``, ``skipped``, ``consecutive`` and ``peak`` live in
  ``state['guard']``.
- A step that is not ``ok`` leaves parameters, moments and ``beta*_pow``
  bitwise unchanged: a device-side select (``Optimizer.functional_update
  (ok=)``), not a Python ``if`` on a tensor. ``TrainStep.sync`` reads the
  counters (the one host sync, at the caller's cadence) into the host
  ``GradScaler`` and ``resilience.NanGuard``.
- ``microbatch=k``: one call runs k full steps, one update each, on batch
  leaves with a leading k axis, as the reference's ``lax.scan`` does;
  ``result.losses`` holds the k losses, and outputs are returned only when
  k == 1.
- ``optimizer=`` a ``FlatFusedUpdate``: the parameters are packed into its
  fp32 master buffer, which becomes ``state['params']`` and which the
  given parameters become views of. Each step casts the master once to the
  update's ``compute_dtype`` (when one is set), hands the model views of
  that buffer (detached, each its own autograd leaf: a gradient through
  slices of one buffer would build a buffer-sized zero tensor per slice),
  gathers their gradients into one flat buffer, casts it to the master's
  dtype once and runs the flat update.

- The optimizer's regularizers and clip run inside the step, after the
  gradients are unscaled and before the ``ok`` select, with each
  parameter's ``ParamAttr`` settings (``params_meta``: by default the
  net's named parameters, or ``params``); the learning rate is read from
  the optimizer (a float, or its scheduler's current value) at every
  call, so ``scheduler.step()`` between calls takes effect at once.
- ``remat=`` ``'full'`` / ``'dots'`` / a selective-checkpoint policy
  (``nn.remat``): every ``TransformerEncoder`` layer the loss runs
  through is checkpointed (``torch.utils.checkpoint``, non-reentrant),
  its dropout masks and precision replayed in the recompute. A ``net``
  that holds no ``TransformerEncoder``, or a ``loss_fn``, is checkpointed
  whole from the first call, as the reference's ``jax.checkpoint`` of the
  loss.

Mixed precision: ``amp.auto_cast`` around the step (the model's
``Linear``s cast their inputs), or, as in the reference's ``bench_bert``,
a ``loss_fn`` that casts the fp32 parameters with ``.to(torch.bfloat16)``
(differentiable) and runs the model on the copies through
``torch.func.functional_call``, or a ``FlatFusedUpdate`` with
``compute_dtype``. ``sharding=`` and ``in_shardings=`` raise
``NotImplementedError``: sharding comes with ``distributed/``.
"""
import numpy as np
import torch

from ..device import resolve_device
from ..nn import remat as _remat
from ..nn.layer.transformer import TransformerEncoder
from ..optimizer.fused import FlatFusedUpdate
from ..optimizer.optimizer import _each

__all__ = ['build_train_step', 'TrainStep', 'StepResult', 'DeviceLoss']


class DeviceLoss:
    """A loss that stays on the device until someone needs the number:
    ``float(loss)`` (or ``.value()``) copies it to the host once."""

    __slots__ = ('_value', '_host')

    def __init__(self, value):
        self._value = value
        self._host = None

    def is_ready(self):
        return self._host is not None

    @property
    def raw(self):
        """The 0-dim tensor on the device (no sync)."""
        return self._value

    def value(self):
        if self._host is None:
            self._host = float(self._value)
        return self._host

    def __float__(self):
        return self.value()

    def __format__(self, spec):
        return format(self.value(), spec)

    def __repr__(self):
        if self._host is not None:
            return f'DeviceLoss({self._host})'
        return 'DeviceLoss(<on device>)'


class StepResult:
    """What one call hands back (besides the state)."""

    __slots__ = ('loss', 'losses', 'outputs')

    def __init__(self, loss, losses, outputs):
        self.loss = loss          # DeviceLoss of the (last microbatch's) loss
        self.losses = losses      # the loss, or the k losses, on the device
        self.outputs = outputs    # the model's outputs (detached), k == 1


def _net_loss_fn(net, loss, functional):
    """The loss over an ``nn.Module``: ``batch = (batch_x, batch_y)``;
    ``batch_x`` is a tuple of positional feeds or a dict of keyword feeds,
    and list losses are summed, as the reference's eager path does. With
    ``functional`` the module runs on the ``params`` it is given
    (``torch.func.functional_call``), else on its own parameters."""
    def loss_fn(params, batch):
        batch_x, batch_y = batch
        args, kwargs = ((), batch_x) if isinstance(batch_x, dict) \
            else (tuple(batch_x), {})
        out = torch.func.functional_call(net, params, args, kwargs) \
            if functional else net(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        losses = loss(*outs, *batch_y)
        losses = losses if isinstance(losses, (list, tuple)) else [losses]
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        return total, tuple(outs)
    return loss_fn


_LATER = {
    'sharding': "sharded state comes with the distributed slice",
    'in_shardings': "sharded feeds come with the distributed slice",
}


def build_train_step(loss_fn=None, optimizer=None, *, net=None, loss=None,
                     params=None, params_meta=None, trainable=None,
                     scaler=None, nan_guard=False, microbatch=1, remat=None,
                     in_shardings=None, sharding=None, device=None):
    """Build ONE train step.

    Either pass ``net=`` and ``loss=`` — the step calls ``net`` on
    ``batch_x`` and ``loss(*outputs, *batch_y)`` — or a ``loss_fn(params,
    batch) -> loss | (loss, outputs)`` with ``params=`` (``{name: leaf
    tensor}``). ``optimizer`` is a ``paddle_tpu_torch.optimizer``
    optimizer (its ``functional_update`` is the update) or a
    ``FlatFusedUpdate`` over those parameters.

    - ``params_meta``: ``{name: parameter}`` whose ``ParamAttr``
      attributes (learning rate, regularizer, ``need_clip``) the update
      honours; by default the parameters themselves.
    - ``trainable``: optional set of parameter names to update (an empty
      set updates nothing); the others flow through untouched.
    - ``scaler``, ``nan_guard``, ``microbatch``, ``remat``: see the
      module docstring.
    - ``device``: where the step runs — the CUDA device unless
      ``device='cpu'``; the parameters must already live there, feeds are
      moved there.
    """
    asked = {'sharding': sharding is not None,
             'in_shardings': in_shardings is not None}
    k = int(microbatch)
    if k < 1:
        raise ValueError(f"build_train_step: microbatch must be >= 1, got "
                         f"{microbatch}")
    for option, on in asked.items():
        if on:
            raise NotImplementedError(
                f"build_train_step: {option}= is not ported yet: "
                f"{_LATER[option]}")
    if scaler is not None and not scaler.is_enable():
        scaler = None
    flat = isinstance(optimizer, FlatFusedUpdate)
    if net is not None:
        if loss_fn is not None:
            raise ValueError("build_train_step: pass loss_fn OR net+loss, "
                             "not both")
        if loss is None:
            raise ValueError("build_train_step: net= needs loss=")
        loss_fn = _net_loss_fn(net, loss, flat)
        if params is None:
            params = dict(net.named_parameters())
    if loss_fn is None:
        raise ValueError("build_train_step: need loss_fn= or net=+loss=")
    if params is None:
        raise ValueError("build_train_step: loss_fn= needs params=")
    if optimizer is None:
        raise ValueError("build_train_step: optimizer is required")
    if flat and trainable is not None:
        raise ValueError("build_train_step: trainable= filters the "
                         "per-parameter update; a FlatFusedUpdate updates "
                         "its whole buffer")
    remat = _remat.resolve(remat)
    by_layer = remat is not None and net is not None and any(
        isinstance(m, TransformerEncoder) for m in net.modules())
    return TrainStep(loss_fn, optimizer, dict(params),
                     frozenset(trainable) if trainable is not None else None,
                     resolve_device(device), scaler=scaler,
                     nan_guard=bool(nan_guard), microbatch=k,
                     params_meta=(dict(params) if params_meta is None
                                  else dict(params_meta)),
                     remat=remat, remat_by_layer=by_layer)


def _unscale_and_check(grads, scale):
    """Divide ``grads`` by the 0-dim ``scale`` in place (the reference's
    ``g / scale``) -> a 0-dim bool tensor: every gradient finite."""
    _each('div_', grads, scale)
    found = torch.zeros((), dtype=torch.float32, device=scale.device)
    one = torch.ones((), dtype=torch.float32, device=scale.device)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        # multiplies by 1 (no change) and sets `found` on a non-finite value
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, one)
    return found == 0


class TrainStep:
    """A train step: ``state, result = step(state, batch)``."""

    def __init__(self, loss_fn, optimizer, params, trainable, device,
                 scaler=None, nan_guard=False, microbatch=1,
                 params_meta=None, remat=None, remat_by_layer=False):
        self.optimizer = optimizer
        self.device = device
        self.scaler = scaler
        self.guard_enabled = nan_guard
        self.k = microbatch
        self.remat = remat
        self.remat_by_layer = remat_by_layer
        self._loss_fn = loss_fn
        self._trainable = trainable
        self._params_meta = params_meta
        for name, p in params.items():
            if p.device != device:
                raise ValueError(
                    f"build_train_step: parameter {name} is on {p.device}, "
                    f"the step runs on {device}; build the model there or "
                    f"pass device=")
        self._flat = optimizer if isinstance(optimizer, FlatFusedUpdate) \
            else None
        if self._flat is not None:
            # the master owns the weights: the parameters become its views
            master = self._flat.flatten(params)
            self._flat.bind(params, master)
            self._params = master
        else:
            self._params = params

    def init_state(self, opt_state=None, nan_guard=None, scaler=None):
        """``{'params': ..., 'opt': ...}`` (plus ``'guard'`` and
        ``'scaler'`` when the step has them): the live parameters (or the
        flat master) and fresh optimizer slots (or ``opt_state``, to
        resume). ``nan_guard`` / ``scaler`` host objects seed the device
        counters, so a resumed run continues its skip and scale history."""
        if opt_state is None:
            opt_state = (self._flat.init_state(self._params) if self._flat
                         else self.optimizer.init_state_values(self._params))
        state = {'params': self._params, 'opt': opt_state}

        def i32(v):
            # a fill, not a copy from the host: nothing waits
            return torch.full((), int(v), dtype=torch.int32,
                              device=self.device)
        if self.guard_enabled:
            g = nan_guard
            state['guard'] = {
                'steps': i32(g.total_steps if g else 0),
                'skipped': i32(g.skipped_steps if g else 0),
                'consecutive': i32(g.consecutive_skips if g else 0),
                # the longest streak SINCE THE LAST SYNC, so that a
                # limit-length streak that ends between two syncs still
                # aborts at the next one; sync() sets it back to 0
                'peak': i32(0)}
        if self.scaler is not None:
            s = scaler or self.scaler
            state['scaler'] = {
                'scale': torch.full((), float(s.get_loss_scaling()),
                                    dtype=torch.float32, device=self.device),
                'good': i32(s._good_steps), 'bad': i32(s._bad_steps)}
        return state

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return tuple(self._to_device(v) for v in batch)
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    def _microbatch(self, batch, i):
        if isinstance(batch, dict):
            return {k: self._microbatch(v, i) for k, v in batch.items()}
        if isinstance(batch, tuple):
            return tuple(self._microbatch(v, i) for v in batch)
        return batch[i] if isinstance(batch, torch.Tensor) else batch

    def __call__(self, state, batch):
        """Run one call (k steps) on ``batch``. Parameters, optimizer slots
        and the guard and scaler counters in ``state`` are updated in
        place. Returns ``(state, StepResult)``; nothing here waits for the
        device."""
        batch = self._to_device(batch)
        if self.k == 1:
            loss, outs = self._one_step(state, batch)
            return state, StepResult(DeviceLoss(loss), loss, outs)
        losses = torch.stack([self._one_step(
            state, self._microbatch(batch, i))[0] for i in range(self.k)])
        return state, StepResult(DeviceLoss(losses[-1]), losses, None)

    def _leaves(self, state):
        """-> ``(the params the loss_fn gets, names to differentiate)``."""
        if self._flat is None:
            params = state['params']
            return params, [n for n, p in params.items() if p.requires_grad
                            and (self._trainable is None
                                 or n in self._trainable)]
        master, dt = state['params'], self._flat.compute_dtype
        work = master.detach() if dt is None or dt == master.dtype \
            else master.detach().to(dt)          # the one cast
        leaves = {k: v.detach().requires_grad_()
                  for k, v in self._flat.unflatten(work).items()}
        return leaves, list(leaves)

    def _flat_grad(self, grads, master):
        """The leaves' gradients (the list is emptied) gathered into one
        flat buffer of their dtype, zero in the gaps, then cast to the
        master's dtype once."""
        buf = torch.zeros(self._flat.numel, dtype=grads[0].dtype,
                          device=master.device)
        views = self._flat.unflatten(buf)
        torch._foreach_copy_([views[n] for n in self._flat.names], grads)
        grads.clear()
        return buf.to(master.dtype)

    def _loss(self, leaves, batch):
        """The loss function, under the step's rematerialisation: each
        encoder layer checkpointed, or the whole loss."""
        r = self.remat
        if r is None:
            return self._loss_fn(leaves, batch)
        if not self.remat_by_layer:
            return r(self._loss_fn, leaves, batch)
        with _remat.scope(r):
            return self._loss_fn(leaves, batch)

    def _one_step(self, state, batch):
        use_scaler = self.scaler is not None
        use_guard = self.guard_enabled
        leaves, names = self._leaves(state)
        out = self._loss(leaves, batch)
        loss, outs = out if isinstance(out, tuple) else (out, None)
        scale = state['scaler']['scale'] if use_scaler else None
        ok = torch.isfinite(loss) if (use_scaler or use_guard) else None
        loss_ok = ok
        if names:
            grads = list(torch.autograd.grad(
                loss * scale if use_scaler else loss,
                [leaves[n] for n in names], allow_unused=True,
                materialize_grads=True))
            if self._flat is not None:
                # the compute-dtype views and their gradients go before
                # the update, whose temporaries make the step's peak
                leaves = None
                grads = [self._flat_grad(grads, state['params'])]
            if use_scaler:
                ok = ok & _unscale_and_check(grads, scale)
            if self._flat is not None:
                self._flat.update(state['params'], grads[0], state['opt'],
                                  ok=ok)
            else:
                self.optimizer.functional_update(
                    state['params'], dict(zip(names, grads)), state['opt'],
                    ok=ok, params_meta=self._params_meta)
        if use_guard:
            g = state['guard']
            skipped = ~loss_ok
            streak = torch.where(skipped, g['consecutive'] + 1,
                                 torch.zeros_like(g['consecutive']))
            state['guard'] = {
                'steps': g['steps'] + 1,
                'skipped': g['skipped'] + skipped.to(torch.int32),
                'consecutive': streak,
                'peak': torch.maximum(g['peak'], streak)}
        if use_scaler:
            state['scaler'] = self._advance_scaler(state['scaler'], ok)
        loss = loss.detach()
        if outs is not None:
            outs = tuple(o.detach() for o in outs)
        return loss, outs

    def _advance_scaler(self, sc, ok):
        """``GradScaler.update`` on the device (the same policy)."""
        s = self.scaler
        if not s._dynamic:
            return sc
        zero = torch.zeros_like(sc['good'])
        bad1 = sc['bad'] + 1
        dec = bad1 >= s._decr_every
        scale_bad = torch.where(
            dec, torch.clamp_min(sc['scale'] * s._decr_ratio, 1.0),
            sc['scale'])
        good1 = sc['good'] + 1
        inc = good1 >= s._incr_every
        scale_good = torch.where(inc, sc['scale'] * s._incr_ratio,
                                 sc['scale'])
        return {'scale': torch.where(ok, scale_good, scale_bad),
                'good': torch.where(ok, torch.where(inc, zero, good1), zero),
                'bad': torch.where(ok, zero, torch.where(dec, zero, bad1))}

    def sync(self, state, nan_guard=None, scaler=None, raise_on_limit=True):
        """Bring the host objects up to the counters the steps kept on the
        device (the one host sync; call it at the log cadence and before
        checkpointing): the live loss scale into the ``GradScaler``, the
        guard's counters into ``NanGuard`` (warning about the steps skipped
        since the last sync), which raises ``NanStepError`` at its limit.
        -> ``{'guard': {...}, 'scaler': {...}}`` as numbers, read in one
        copy."""
        keys = [(slot, k) for slot in ('guard', 'scaler') if slot in state
                for k in state[slot]]
        if not keys:
            return {}
        # float64 holds every int32 counter and the fp32 scale exactly
        values = torch.stack([state[slot][k].to(torch.float64)
                              for slot, k in keys]).tolist()
        fetched = {}
        for (slot, k), v in zip(keys, values):
            fetched.setdefault(slot, {})[k] = v if k == 'scale' else int(v)
        if 'guard' in fetched:
            # rebase the since-last-sync streak maximum BEFORE judging, so
            # that a caught NanStepError does not re-raise at every sync
            state['guard']['peak'] = torch.zeros_like(
                state['guard']['peak'])
        scaler = scaler or self.scaler
        if 'scaler' in fetched and scaler is not None:
            sv = fetched['scaler']
            scaler._scale = float(sv['scale'])
            scaler._good_steps = int(sv['good'])
            scaler._bad_steps = int(sv['bad'])
        if 'guard' in fetched and nan_guard is not None:
            gv = fetched['guard']
            nan_guard.absorb_device_counts(
                gv['steps'], gv['skipped'], gv['consecutive'],
                # the scaler's decrement already ran on the device;
                # marking it again on the host would decay it twice
                mark_scaler=self.scaler is None,
                raise_on_limit=raise_on_limit,
                peak_consecutive=gv['peak'])
        return fetched
