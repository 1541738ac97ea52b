"""The eager convenience loop over the train step. Counterpart of
``paddle_tpu/engine/loop.py`` (``fit``, ``write_back_state``,
``adopt_optimizer_state``, ``_grouped``, ``_finish``)::

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
``torch.backends.cuda.matmul.allow_tf32``). Checkpointing and resuming
(``checkpoint``, ``resume_from``, ``preempt_save`` with a checkpoint),
multi-process runs (``world``, ``rank``), ``sharding`` and the serving
export (``serve_artifacts``, ``serve_generative``) raise
``NotImplementedError``.
"""
import time
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..io import DevicePrefetcher
from .builder import build_train_step

__all__ = ['fit', 'write_back_state', 'adopt_optimizer_state']

_LATER = {
    'checkpoint': "checkpointing comes with the resilience slice "
                  "(resilience.CheckpointManager)",
    'resume_from': "resuming comes with the resilience slice "
                   "(resilience.CheckpointManager)",
    'world': "multi-process runs come with the distributed slice",
    'rank': "multi-process runs come with the distributed slice",
    'sharding': "sharded state comes with the distributed slice",
    'serve_artifacts': "the train-to-serve export comes with the "
                       "compilecache and serving slices",
    'serve_generative': "the generative serving export comes with the "
                        "generative serving slice (text/gpt.py, paged KV)",
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
    ``steps``, ``dispatches`` (calls of the step), ``microbatch``,
    ``donated`` (False), ``checkpoints`` (0), ``resumed_from`` (None),
    ``preempted`` (False), ``steps_per_sec`` and ``state`` (the step's
    state, already mirrored into ``optimizer``).

    ``nan_guard``: a ``resilience.NanGuard`` or True for a default one;
    ``scaler``: an ``amp.GradScaler``; ``device``: where the step runs
    (the CUDA device unless ``device='cpu'``; ``network`` must live
    there). ``data`` is iterated once an epoch."""
    asked = {'checkpoint': checkpoint is not None,
             'resume_from': resume_from is not None,
             'world': world is not None, 'rank': rank is not None,
             'sharding': sharding is not None,
             'serve_artifacts': serve_artifacts is not None,
             'serve_generative': serve_generative is not None}
    for option, on in asked.items():
        if on:
            raise NotImplementedError(
                f"engine.fit: {option}= is not ported yet: {_LATER[option]}")
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
    report = {'loss': [], 'steps': 0, 'dispatches': 0, 'microbatch': k,
              'donated': False, 'checkpoints': 0, 'resumed_from': None,
              'preempted': False}
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
        for _ in range(int(epochs)):
            source = _grouped(data, k)
            if prefetch:
                source = DevicePrefetcher(source, device, depth=prefetch)
            for batch in source:
                state, out = step(state, batch)
                report['dispatches'] += 1
                report['steps'] += k
                n = report['dispatches']
                if needs_sync and n % sync_every == 0:
                    step.sync(state, nan_guard=nan_guard, scaler=scaler)
                if n % log_every == 0 or n == 1:
                    report['loss'].append(float(out.loss))
    except BaseException:
        _cleanup(step, state, network, optimizer, nan_guard, scaler,
                 needs_sync, raise_on_limit=False)
        raise
    _cleanup(step, state, network, optimizer, nan_guard, scaler, needs_sync)
    elapsed = time.perf_counter() - t0
    if elapsed > 0:
        report['steps_per_sec'] = round(report['steps'] / elapsed, 3)
    report['state'] = state
    return report


def _cleanup(step, state, network, optimizer, nan_guard, scaler, needs_sync,
             raise_on_limit=True):
    """Mirror the optimizer slots and reconcile the host guard and scaler
    one last time; on the error path, never raise from here."""
    write_back_state(network, optimizer, state)
    if needs_sync:
        try:
            step.sync(state, nan_guard=nan_guard, scaler=scaler,
                      raise_on_limit=raise_on_limit)
        except Exception:
            if raise_on_limit:
                raise
