"""The eager convenience loop over the train step. Counterpart of
``paddle_tpu/engine/loop.py`` (``fit``, ``write_back_state``,
``adopt_optimizer_state``, ``_grouped``, ``_finish``, ``_to_manager``)::

    report = engine.fit(net, loss_fn, opt, batches, epochs=2, microbatch=2)

``fit`` builds one ``build_train_step(net=, loss=, optimizer=, scaler=,
nan_guard=, microbatch=, remat=)`` and feeds it ``data``'s ``(inputs,
labels)`` batches (``inputs`` a tuple of positional feeds or a dict of
keyword feeds; numpy arrays or tensors) through the device prefetcher
(``io.DevicePrefetcher``, ``prefetch`` batches ahead). With
``microbatch=k`` every k consecutive batches go to one call on a new
leading axis; a batch whose shapes differ from the first one's, and an
incomplete last group, are dropped with a warning, as the reference's
``_grouped`` does. Losses stay on the device and are read at the
``log_every`` cadence only (and after the first call); the guard's and the
scaler's device counters are brought to the host objects every
``min(log_every, ceil(max_consecutive_skips / k))`` calls and once at the
end (``TrainStep.sync``, one copy each). Nothing else in the loop waits
for the device. Like the reference's, ``fit`` never steps a learning-rate
scheduler: the caller does, between calls, or through the schedule's own
arithmetic.

The port's step updates the network's parameters in place, so the state
needs no writing back into the network; ``write_back_state`` mirrors the
optimizer slots into the optimizer's eager accumulators (so its
``state_dict()`` sees them) and ``adopt_optimizer_state`` seeds a run from
them, as the reference's do.

``donate`` and ``matmul_precision`` are accepted and do nothing (there is
no buffer donation in eager PyTorch; fp32 products follow
``torch.backends.cuda.matmul.allow_tf32``).

Checkpointing, as the reference's (``resilience.CheckpointManager``, the
sharded format with one rank):

- ``checkpoint=`` (a directory or a ``CheckpointManager``, keeping
  ``checkpoint_max_keep``): the step's whole state (parameters, optimizer
  slots, the guard's and the scaler's counters) and the RNG streams
  (``resilience.capture_rng``: the network's ``DropoutState`` offsets,
  numpy's state, an optimizer's generators) are saved every
  ``checkpoint_every`` calls (0: at each epoch's end) and at the end;
  with ``async_save`` the leaves are cloned on the device, in stream
  order, and written on a background thread, one save in flight.
- ``resume_from=`` (default: ``checkpoint=``): the newest intact
  checkpoint is copied into the network's parameters and the step's
  slots (``TrainStep.adopt_state``), the RNG streams are set back, and the
  loop position replayed: a resume in mid-epoch skips the groups already
  trained without sending them to the device. With a deterministic
  ``data`` the resumed run equals an uninterrupted one bit for bit.
- ``preempt_save`` (with a checkpoint): a SIGTERM is caught at the next
  call; the in-flight save is fenced (finished or abandoned) first, then a
  last synchronous save commits, and the report has ``preempted: True``.

Telemetry (``PADDLE_TPU_TELEMETRY=1`` or ``observability.enable()``), as
the reference's: the step's ``engine.step`` / ``engine.steps`` /
``engine.dispatches`` and its cost-ledger entry (``build_train_step``),
the prefetcher's ``dataloader.prefetch_depth``, a ``DataLoader``'s own,
the checkpoints' ``checkpoint.*``, the guard's ``nan_guard.*``, and the
loop's ``engine.dropped_batches`` (microbatch groups it could not fill)
and ``checkpoint.preempt_fence_error`` event (a preemption's fence that
failed). It changes no launch and no loss; host syncs grow by the
``engine.step`` span's sampled waits only.

Multi-process runs (``world``, ``rank``), ``sharding`` and the serving
export (``serve_artifacts``, ``serve_generative``) raise
``NotImplementedError``.
"""
import itertools
import time
import warnings

import numpy as np
import torch

from .. import observability as _obs
from ..device import resolve_device
from ..io import DevicePrefetcher
from ..resilience import (CheckpointManager, PreemptionGuard, capture_rng,
                          restore_rng)
from .builder import build_train_step

__all__ = ['fit', 'write_back_state', 'adopt_optimizer_state']

_LATER = {
    'world': "multi-process runs come with the distributed slice",
    'rank': "multi-process runs come with the distributed slice",
    'sharding': "sharded state comes with the distributed slice",
    'serve_artifacts': "the train-to-serve export comes with compilecache/ "
                       "(ROADMAP.md, Queue 1 item 7)",
    'serve_generative': "the generative serving export comes with "
                        "compilecache/ (ROADMAP.md, Queue 1 item 7)",
}


def adopt_optimizer_state(network, optimizer, param_values):
    """Optimizer slots seeded from the optimizer's eager accumulators (a
    ``set_state_dict`` before the run) instead of fresh zeros, so a resumed
    run continues its moments."""
    opt_state = optimizer.init_state_values(param_values)
    acc = optimizer._accumulators
    for key in opt_state:
        if acc.get(key):
            opt_state[key] = dict(acc[key])
    return opt_state


def write_back_state(network, optimizer, state):
    """Mirror the step's optimizer slots into ``optimizer``'s eager
    accumulators (the parameters are the network's own, updated in
    place)."""
    if optimizer is not None and state.get('opt'):
        for key, slots in state['opt'].items():
            if slots:
                optimizer._accumulators[key] = dict(slots)


def _split(batch):
    """``(inputs, labels)`` of one batch: ``inputs`` a dict or a tuple,
    ``labels`` a tuple."""
    if isinstance(batch, (list, tuple)) and len(batch) >= 2:
        x, y = batch[0], batch[1]
    elif isinstance(batch, (list, tuple)) and len(batch) == 1:
        x, y = batch[0], ()
    else:
        x, y = batch, ()
    if not isinstance(x, dict):
        x = tuple(x) if isinstance(x, (list, tuple)) else (x,)
    y = tuple(y) if isinstance(y, (list, tuple)) else (y,)
    return x, y


def _values(part):
    return list(part.values()) if isinstance(part, dict) else list(part)


def _stack(items):
    if all(isinstance(v, np.ndarray) for v in items):
        return np.stack(items)
    return torch.stack([torch.as_tensor(v) for v in items])


def _grouped(data, k):
    """``data``'s batches as ``(inputs, labels)``; with ``k > 1``, k
    consecutive ones stacked on a new leading axis (the microbatch axis).
    A batch whose shapes differ from the first one's is dropped, and so is
    an incomplete last group."""
    if k == 1:
        for batch in data:
            yield _split(batch)
        return
    group, dropped, canon = [], 0, None
    for batch in data:
        bx, by = _split(batch)
        sig = (tuple(np.shape(v) for v in _values(bx)),
               tuple(np.shape(v) for v in by))
        if canon is None:
            canon = sig
        if sig != canon:
            dropped += 1
            continue
        group.append((bx, by))
        if len(group) == k:
            x0 = group[0][0]
            if isinstance(x0, dict):
                gx = {n: _stack([g[0][n] for g in group]) for n in x0}
            else:
                gx = tuple(_stack([g[0][i] for g in group])
                           for i in range(len(x0)))
            gy = tuple(_stack([g[1][i] for g in group])
                       for i in range(len(group[0][1])))
            yield gx, gy
            group = []
    dropped += len(group)
    if dropped:
        if _obs.enabled():
            _obs.counter('engine.dropped_batches').inc(dropped)
        warnings.warn(
            "engine.fit(microbatch=%d): dropped %d batch(es) whose shape "
            "differed from the first batch, or that did not fill the last "
            "group; pad or bucket the batches, or use microbatch=1"
            % (k, dropped), RuntimeWarning, stacklevel=2)


def fit(network, loss, optimizer, data, *, epochs=1, microbatch=1,
        log_every=10, nan_guard=None, scaler=None, prefetch=2,
        remat=None, donate='auto', matmul_precision='auto', sharding=None,
        checkpoint=None, checkpoint_every=0, async_save=True,
        resume_from=None, preempt_save=True, checkpoint_max_keep=3,
        world=None, rank=None, serve_artifacts=None, serve_generative=None,
        device=None):
    """Train ``network`` over ``data`` for ``epochs`` through one train
    step -> the report: ``loss`` (the losses read at the log cadence),
    ``steps``, ``dispatches`` (calls of the step, counted from the start
    of the run a resume continues), ``microbatch``, ``donated`` (False),
    ``checkpoints`` (saves this call made), ``resumed_from`` (the
    dispatches of the checkpoint resumed, or None), ``preempted``,
    ``steps_per_sec`` and ``state`` (the step's state, already mirrored
    into ``optimizer``).

    ``nan_guard``: a ``resilience.NanGuard`` or True for a default one;
    ``scaler``: an ``amp.GradScaler``; ``checkpoint``, ``checkpoint_every``,
    ``async_save``, ``resume_from``, ``preempt_save``,
    ``checkpoint_max_keep``: see the module docstring; ``device``: where
    the step runs (the CUDA device unless ``device='cpu'``; ``network``
    must live there). ``data`` is iterated once an epoch."""
    asked = {'world': world is not None, 'rank': rank is not None,
             'sharding': sharding is not None,
             'serve_artifacts': serve_artifacts is not None,
             'serve_generative': serve_generative is not None}
    for option, on in asked.items():
        if on:
            raise NotImplementedError(
                f"engine.fit: {option} is not ported yet: {_LATER[option]}")
    if nan_guard is True:
        from ..resilience import NanGuard
        nan_guard = NanGuard()
    if nan_guard is not None and scaler is not None:
        nan_guard.attach_scaler(scaler)
    device = resolve_device(device)
    step = build_train_step(net=network, loss=loss, optimizer=optimizer,
                            scaler=scaler, nan_guard=nan_guard is not None,
                            microbatch=microbatch, remat=remat,
                            device=device)
    network.train()
    params = dict(network.named_parameters())
    state = step.init_state(
        opt_state=adopt_optimizer_state(network, optimizer, params),
        nan_guard=nan_guard, scaler=scaler)
    k = step.k
    mgr = _to_manager(checkpoint, checkpoint_max_keep)
    resume_mgr = _to_manager(resume_from, checkpoint_max_keep) or mgr
    start_epoch = skip = 0
    report = {'loss': [], 'steps': 0, 'dispatches': 0, 'microbatch': k,
              'donated': False, 'checkpoints': 0, 'resumed_from': None,
              'preempted': False}
    if resume_mgr is not None:
        got = resume_mgr.restore(return_extra=True)
        if got is not None:
            loaded, meta, extra = got
            state = step.adopt_state(loaded)
            start_epoch = int(meta.get('epoch', 0))
            skip = int(meta.get('dispatch_in_epoch', 0))
            report['dispatches'] = int(meta.get('dispatches', 0))
            report['steps'] = report['dispatches'] * k
            report['resumed_from'] = report['dispatches']
            if extra and extra.get('rng') is not None:
                restore_rng(extra['rng'], network, state['opt'])
    guard = None
    if mgr is not None and preempt_save:
        guard = PreemptionGuard().install()   # inert off the main thread

    def save_now(epoch, dispatch_in_epoch, async_ok=True):
        meta = {'epoch': int(epoch),
                'dispatch_in_epoch': int(dispatch_in_epoch),
                'dispatches': report['dispatches'], 'microbatch': k,
                'world': 1}
        mgr.save(_saveable(state), step=report['dispatches'], meta=meta,
                 async_=bool(async_save and async_ok),
                 extra={'rng': capture_rng(network, state['opt'])})
        report['checkpoints'] += 1

    # the reconcile cadence is in calls, and a call advances a skip streak
    # by up to k steps: reconcile every ceil(limit / k) calls, so that a
    # diverging run cannot overshoot the guard's limit k-fold
    guard_cap = (-(-nan_guard.max_consecutive_skips // k)
                 if nan_guard is not None else log_every)
    sync_every = max(1, min(int(log_every), guard_cap))
    needs_sync = nan_guard is not None or step.scaler is not None
    log_every = max(int(log_every), 1)
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, int(epochs)):
            source = _grouped(data, k)
            if skip:
                # resumed in mid-epoch: these groups were trained before
                # the checkpoint; skipped before the prefetcher, so they
                # never reach the device
                source = itertools.islice(source, skip, None)
            if prefetch:
                source = DevicePrefetcher(source, device, depth=prefetch)
            dispatch_in_epoch = skip
            for batch in source:
                state, out = step(state, batch)
                report['dispatches'] += 1
                report['steps'] += k
                dispatch_in_epoch += 1
                n = report['dispatches']
                if needs_sync and n % sync_every == 0:
                    step.sync(state, nan_guard=nan_guard, scaler=scaler)
                if n % log_every == 0 or n == 1:
                    report['loss'].append(float(out.loss))
                if guard is not None and guard.preempted:
                    # fence the in-flight save (finished or abandoned)
                    # BEFORE the last synchronous one; a failure of an
                    # earlier background save must not stop this one
                    try:
                        mgr.fence(timeout=_PREEMPT_FENCE_S, abandon=True)
                    except Exception as e:
                        _obs.event('checkpoint.preempt_fence_error',
                                   error=repr(e))
                    save_now(epoch, dispatch_in_epoch, async_ok=False)
                    report['preempted'] = True
                    return _finish(report, t0, step, state, network,
                                   optimizer, nan_guard, scaler, needs_sync,
                                   mgr, guard)
                if mgr is not None and checkpoint_every and \
                        n % int(checkpoint_every) == 0:
                    save_now(epoch, dispatch_in_epoch)
            skip = 0
            if mgr is not None and not checkpoint_every:
                save_now(epoch + 1, 0)
        if mgr is not None and checkpoint_every:
            save_now(int(epochs), 0)
    except BaseException:
        _cleanup(step, state, network, optimizer, nan_guard, scaler,
                 needs_sync, mgr, guard, raise_on_limit=False)
        raise
    return _finish(report, t0, step, state, network, optimizer, nan_guard,
                   scaler, needs_sync, mgr, guard)


# how long a preemption waits for the in-flight save before abandoning it
_PREEMPT_FENCE_S = 5.0


def _to_manager(source, max_keep):
    if source is None:
        return None
    if isinstance(source, CheckpointManager):
        return source
    return CheckpointManager(source, max_keep=max_keep)


def _saveable(state):
    """The state without the optimizer's generators (their positions are
    part of the RNG snapshot)."""
    if isinstance(state, dict):
        return {k: _saveable(v) for k, v in state.items()
                if not isinstance(v, torch.Generator)}
    return state


def _finish(report, t0, step, state, network, optimizer, nan_guard, scaler,
            needs_sync, mgr, guard):
    _cleanup(step, state, network, optimizer, nan_guard, scaler, needs_sync,
             mgr, guard)
    elapsed = time.perf_counter() - t0
    if elapsed > 0:
        report['steps_per_sec'] = round(report['steps'] / elapsed, 3)
    report['state'] = state
    return report


def _cleanup(step, state, network, optimizer, nan_guard, scaler, needs_sync,
             mgr=None, guard=None, raise_on_limit=True):
    """Mirror the optimizer slots, reconcile the host guard and scaler one
    last time, put the SIGTERM handler back and wait for the last save; on
    the error path, never raise from here."""
    write_back_state(network, optimizer, state)
    try:
        if needs_sync:
            try:
                step.sync(state, nan_guard=nan_guard, scaler=scaler,
                          raise_on_limit=raise_on_limit)
            except Exception:
                if raise_on_limit:
                    raise
    finally:
        if guard is not None:
            guard.uninstall()
        if mgr is not None:
            # the last async save lands before fit returns; on the normal
            # path its failure is the caller's
            try:
                mgr.fence()
            except Exception:
                if raise_on_limit:
                    raise
