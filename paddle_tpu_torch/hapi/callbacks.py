"""Training callbacks. Counterpart of ``paddle_tpu/hapi/callbacks.py``
(``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``CheckpointSaver``, ``LRScheduler``, ``EarlyStopping``, ``VisualDL``).

``CheckpointSaver`` runs on the port's ``resilience.CheckpointManager``
and ``PreemptionGuard``. The port has no global generator: the RNG it
saves is ``resilience.capture_rng(network, opt_state)`` — numpy's state,
each ``DropoutState`` of the network by module path, an optimizer's
generators — at the save point and at the epoch's start. An async save
snapshots the state on the training thread in stream order
(``CheckpointManager.save(async_=True)`` through ``secure_for_async``),
because the eager ``optimizer.step()`` updates the saved tensors in place.
``VisualDL`` stamps its records with ``observability.wall_ts()``.
``TelemetryCallback`` lives in ``observability.callback`` and is exported
here lazily (it subclasses ``Callback``).
"""
import json
import os

import numpy as np

from .progressbar import ProgressBar

__all__ = ['Callback', 'ProgBarLogger', 'ModelCheckpoint', 'LRScheduler',
           'EarlyStopping', 'VisualDL', 'CallbackList', 'CheckpointSaver',
           'TelemetryCallback']


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith('on_'):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


def _numbers(logs):
    return [(k, v) for k, v in (logs or {}).items()
            if isinstance(v, (int, float, np.floating))]


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get('steps')
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")
        self.bar = ProgressBar(num=self.steps, verbose=self.verbose)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            self.bar.update(step + 1, _numbers(logs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            self.bar.update(self.steps or 0, _numbers(logs))

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            info = ' - '.join(f"{k}: {v}" for k, v in logs.items())
            print(f"Eval: {info}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, 'final'))


class CheckpointSaver(Callback):
    """Preemption-safe training checkpoints (``resilience.
    CheckpointManager``).

    Saves the whole resumable state — network parameters, optimizer slots,
    the RNG streams (numpy's and the network's ``DropoutState``s), the AMP
    loss scale, the NaN guard's counters, the epoch/step position — as
    CRC-stamped rotating checkpoints:

    - every ``save_freq`` epochs at the epoch boundary;
    - at the next batch boundary after a SIGTERM (fleet preemption), then
      stops training cleanly.

    Resume with ``Model.fit(..., resume_from=<same dir>)``: training
    continues bitwise as a run that was never interrupted (the epoch-start
    RNG snapshot lets a mid-epoch resume replay the epoch's shuffle, skip
    the completed steps, then take the exact mid-epoch RNG state).

    ``async_save=True`` commits the epoch-boundary checkpoints on a
    background thread: the training thread's stall is the device-side
    snapshot. The preemption checkpoint is always synchronous, and it
    first fences any save in flight (finished, or abandoned after
    ``preempt_fence_s`` seconds), so the two never interleave.
    """

    def __init__(self, save_dir, save_freq=1, max_keep=3,
                 save_on_preempt=True, async_save=False,
                 preempt_fence_s=5.0):
        super().__init__()
        self.save_dir = save_dir
        self.save_freq = save_freq
        self.max_keep = max_keep
        self.save_on_preempt = save_on_preempt
        self.async_save = bool(async_save)
        self.preempt_fence_s = float(preempt_fence_s)
        self._mgr = None
        self._guard = None
        self._epoch = 0
        self._preempt_saved = False

    def manager(self):
        if self._mgr is None:
            from ..resilience import CheckpointManager
            self._mgr = CheckpointManager(self.save_dir,
                                          max_keep=self.max_keep)
        return self._mgr

    def on_train_begin(self, logs=None):
        self.manager()
        self._preempt_saved = False
        if self.save_on_preempt and self._guard is None:
            from ..resilience import PreemptionGuard
            self._guard = PreemptionGuard().install()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        if self._guard is not None and self._guard.preempted and \
                not self._preempt_saved:
            # fence the async save in flight (finish, or abandon its
            # uncommitted files) BEFORE the preemption checkpoint starts;
            # an earlier background failure must not stop this last save
            try:
                self.manager().fence(timeout=self.preempt_fence_s,
                                     abandon=True)
            except Exception:
                pass
            # step + 1 batches of this epoch are done; a resume skips them
            self._save(epoch=self._epoch, step_in_epoch=step + 1,
                       async_ok=False)
            self._preempt_saved = True
            self.model.stop_training = True

    def on_epoch_end(self, epoch, logs=None):
        if self._preempt_saved:
            return   # the preemption checkpoint already holds this position
        if (epoch + 1) % self.save_freq == 0:
            self._save(epoch=epoch + 1, step_in_epoch=0)

    def on_train_end(self, logs=None):
        if self._guard is not None:
            self._guard.uninstall()
            self._guard = None
        if self._mgr is not None:
            # the last async save lands before the process can exit
            self._mgr.fence()

    @property
    def preempted(self):
        return self._preempt_saved

    def _save(self, epoch, step_in_epoch, async_ok=True):
        from ..resilience import capture_rng
        model = self.model
        model._sync_jit_state()
        state = {
            'model': model.network.state_dict(),
            'rng': capture_rng(model.network, model._opt_slots()),
            'epoch_start_rng': model._epoch_start_rng,
        }
        if model._optimizer is not None:
            state['opt'] = model._optimizer.state_dict()
        if model._scaler is not None:
            state['scaler'] = model._scaler.state_dict()
        if model._nan_guard is not None:
            state['nan_guard'] = model._nan_guard.state_dict()
        self.manager().save(state, meta={'epoch': int(epoch),
                                         'step_in_epoch': int(step_in_epoch)},
                            async_=self.async_save and async_ok)


class LRScheduler(Callback):
    """Steps the optimizer's ``optimizer.lr`` scheduler after every batch
    (``by_step``) and/or every epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, '_optimizer', None)
        lr = getattr(opt, '_lr', None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor='loss', mode='auto', patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == 'min' or (mode == 'auto' and 'loss' in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
        self.best = None
        self.wait = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            return
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.best is None or self.monitor_op(current - self.min_delta,
                                                self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: best {self.monitor}={self.best}")


class VisualDL(Callback):
    """Scalar logger writing JSONL to ``log_dir/scalars.jsonl`` (VisualDL
    itself is not bundled): one record a train batch, its number-valued
    logs and a wall-clock stamp."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = None
        self._step = 0

    def on_train_begin(self, logs=None):
        self._f = open(os.path.join(self.log_dir, 'scalars.jsonl'), 'a')

    def on_train_batch_end(self, step, logs=None):
        from ..observability import wall_ts
        rec = {'step': self._step, 'ts': wall_ts()}
        for k, v in _numbers(logs):
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + '\n')
        self._step += 1

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


def __getattr__(name):
    # TelemetryCallback lives in observability (which imports Callback from
    # this module); resolved lazily to keep the import graph acyclic
    if name == 'TelemetryCallback':
        from ..observability.callback import TelemetryCallback
        return TelemetryCallback
    raise AttributeError(name)
