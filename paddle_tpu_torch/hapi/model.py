"""``Model``: the high-level train / eval / predict API. Counterpart of
``paddle_tpu/hapi/model.py``::

    model = Model(net, device=None)            # the CUDA device
    model.prepare(optimizer, loss, metrics, jit=False)
    model.fit(train_dataset, eval_data=eval_dataset, batch_size=8,
              epochs=2, callbacks=[...])
    model.evaluate(eval_dataset, batch_size=8)
    model.predict(test_dataset, batch_size=8)

The network's parameters must live on ``device`` (the CUDA device unless
``device='cpu'``); the data go through the port's ``io.DataLoader`` onto
it. A batch is ``(inputs, labels)``: ``inputs`` positional feeds, or a dict
of keyword feeds (the convention of the port's ``engine``), ``labels``
what ``loss(*outputs, *labels)`` takes after the network's outputs.

- The eager step (``prepare(jit=False)``): autograd, then
  ``optimizer.step()`` and ``clear_grad()``; with a ``GradScaler``
  (``amp_configs``) the scaled backward and ``scaler.step``; with
  ``nan_guard`` a non-finite loss skips the backward and the update.
- ``prepare(jit=True)``: the port's ``engine.build_train_step`` — the
  update, the scaler and the guard on the device, slots seeded from the
  optimizer's own (``adopt_optimizer_state``) and mirrored back into it
  (``write_back_state``) before evaluation, checkpoints and saves. In
  ``fit`` its loss stays on the device (``engine.DeviceLoss``) except at
  the ``log_freq`` cadence, where the guard and scaler counters are
  brought to the host too (``TrainStep.sync``).
- ``prepare`` names the optimizer's parameters by their module paths in
  the network (the names the jit step keys its slots by), so that the
  eager and jit slots, ``save``/``load`` and checkpoints agree; an
  optimizer made without ``parameters=`` gets the network's.
- ``fit(resume_from=)`` reads both layouts the reference reads: a
  ``CheckpointSaver`` directory (network, optimizer, scaler, guard, both
  RNG snapshots, the epoch and step) and an ``engine.fit`` checkpoint
  (the step's state in the sharded format, adopted through
  ``TrainStep.adopt_state``, its RNG from the side payload).
- Metric values are read to the host at every step (``float``), as in the
  reference's loop; ``Accuracy`` computes on the device and moves only
  its (..., maxk) correctness tensor.

- Telemetry on (``PADDLE_TPU_TELEMETRY=1`` or ``observability.enable()``):
  ``fit`` puts an ``observability.TelemetryCallback`` first among the
  callbacks unless the caller passed one (step events and spans, the
  ``hapi.*`` metrics, ``events.jsonl`` and ``trace.json`` at the end, the
  doctor's findings), and ``evaluate`` emits an ``eval_result`` event.

- ``strategy=`` (``prepare`` or ``fit``: a ``distributed.ShardingConfig``,
  a fleet ``DistributedStrategy`` or None; by default the config a
  ``fleet.distributed_optimizer`` carries) runs the jit path's step
  sharded (``engine.build_train_step(sharding=)``: the FSDP step in a
  process group) and so implies ``jit=True``; the state is gathered into
  the network and the optimizer before evaluation, checkpoints and saves.
  A knobs-off strategy turns a sharded model back to unsharded, and
  changes nothing on a model that never was.

Raises ``NotImplementedError``: ``save(training=False)`` (the inference
export, with ``jit/`` and ``inference/``, ROADMAP.md Queue 1 item 7).
"""
import os
import warnings

import numpy as np
import torch

from .. import observability
from ..device import resolve_device
from ..io import DataLoader
from ..io.prefetch import upload
from ..metric import Metric
from .callbacks import CallbackList, ProgBarLogger

__all__ = ['Model']

_LATER = {
    'training=False': "the inference export comes with jit/ and "
                      "inference/ (ROADMAP.md, Queue 1 item 7)",
}


def _later(option, where):
    return NotImplementedError(f"{where}: {option} is not ported yet: "
                               f"{_LATER[option]}")


class Model:
    """``network`` (an ``nn.Module`` on ``device``) with its training
    setup. ``inputs`` / ``labels`` (the reference's input specs) are
    accepted; the inference export that reads them is not ported."""

    def __init__(self, network, inputs=None, labels=None, device=None):
        self.network = network
        self.device = resolve_device(device)
        for name, p in network.named_parameters():
            if p.device != self.device:
                raise ValueError(
                    f"Model: parameter {name} is on {p.device}, the model "
                    f"runs on {self.device}; build the network there or "
                    f"pass device=")
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._use_jit = False
        self._sharding_cfg = None
        self._jit_step_fn = None
        self._jit_state = None
        self._scaler = None
        self._nan_guard = None
        self._epoch_start_rng = None
        self._fit_log_freq = 10
        self._steps_since_engine_sync = 0

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, jit=False,
                amp_configs=None, nan_guard=None, strategy=None):
        self._optimizer = optimizer
        if optimizer is not None:
            self._bind_optimizer(optimizer)
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        from ..amp import GradScaler
        self._scaler = None
        if isinstance(amp_configs, GradScaler):
            self._scaler = amp_configs
        elif isinstance(amp_configs, dict) and \
                isinstance(amp_configs.get('scaler'), GradScaler):
            self._scaler = amp_configs['scaler']
        self._nan_guard = None
        if nan_guard:
            from ..resilience import NanGuard
            self._nan_guard = nan_guard if isinstance(nan_guard, NanGuard) \
                else NanGuard()
            if self._scaler is not None:
                self._nan_guard.attach_scaler(self._scaler)
        self._set_strategy(strategy)
        self._use_jit = bool(jit) or self._sharding_cfg is not None
        self._jit_state = None
        self._jit_step_fn = self._new_step() if self._use_jit else None
        self._steps_since_engine_sync = 0
        return self

    def _set_strategy(self, strategy):
        """Resolve a sharding strategy; with none given, adopt the config a
        ``fleet.distributed_optimizer`` wrapper carries (the fleet knobs
        and ``strategy=`` mean the same thing)."""
        from ..distributed.strategy import resolve_sharding
        cfg = resolve_sharding(strategy)
        if cfg is None and strategy is None:
            cfg = getattr(self._optimizer, 'sharding_config', None)
        self._sharding_cfg = cfg

    def _bind_optimizer(self, opt):
        """Name ``opt``'s parameters by their module paths in the network
        (moving slots it already holds under the old names)."""
        paths = {id(p): n for n, p in self.network.named_parameters()}
        if opt._parameters is None:
            opt._parameters = list(self.network.named_parameters())
            return
        bound = []
        for name, p in opt._parameters:
            path = paths.get(id(p), name)
            if path != name and name in opt._accumulators:
                opt._accumulators[path] = opt._accumulators.pop(name)
            bound.append((path, p))
        opt._parameters = bound

    def _new_step(self):
        """The engine's train step over this model's network, loss,
        optimizer, scaler and guard."""
        from ..engine import build_train_step
        scaler = self._scaler if (self._scaler is not None and
                                  self._scaler.is_enable()) else None
        return build_train_step(net=self.network, loss=self._loss,
                                optimizer=self._optimizer, scaler=scaler,
                                nan_guard=self._nan_guard is not None,
                                sharding=self._sharding_cfg,
                                device=self.device)

    # -- steps --------------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        self.network.train()
        inputs, labels = self._feeds(inputs), self._feeds(labels)
        if self._use_jit:
            return self._jit_train_batch(inputs, labels)
        outs = self._forward(inputs)
        losses = self._loss(*outs, *labels)
        losses = list(losses) if isinstance(losses, (list, tuple)) \
            else [losses]
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        if self._nan_guard is not None and \
                self._nan_guard.check(total.detach()):
            # poisoned loss: no backward, no update; the guard also backs
            # the attached GradScaler's scale off
            self._optimizer.clear_grad()
            return [float(l.detach()) for l in losses], \
                self._update_metrics(outs, labels)
        if self._scaler is not None and self._scaler.is_enable():
            self._scaler.scale(total).backward()
            self._scaler.step(self._optimizer)   # skips on inf gradients
        else:
            total.backward()
            self._optimizer.step()
        self._optimizer.clear_grad()
        return [float(l.detach()) for l in losses], \
            self._update_metrics(outs, labels)

    def _jit_train_batch(self, inputs, labels, lazy=False):
        from ..engine import adopt_optimizer_state
        step = self._jit_step_fn
        if self._jit_state is None:
            params = dict(self.network.named_parameters())
            # continue the optimizer's own slots (a resume's
            # set_state_dict, an earlier eager run) rather than zeros
            self._jit_state = step.init_state(
                opt_state=adopt_optimizer_state(self.network,
                                                self._optimizer, params),
                nan_guard=self._nan_guard, scaler=self._scaler)
            self._steps_since_engine_sync = 0
        batch_x = inputs if isinstance(inputs, dict) else tuple(inputs)
        self._jit_state, out = step(self._jit_state,
                                    (batch_x, tuple(labels)))
        if step.guard_enabled or step.scaler is not None:
            self._steps_since_engine_sync += 1
            if not lazy or self._steps_since_engine_sync >= \
                    self._engine_sync_every():
                self._engine_sync()
        metrics = self._update_metrics(list(out.outputs), labels)
        return [out.loss if lazy else float(out.loss)], metrics

    def _engine_sync_every(self):
        """The guard/scaler reconcile cadence inside ``fit``: the log
        cadence, tightened so that a diverging run cannot overshoot the
        guard's consecutive-skip limit by more than one cadence."""
        every = self._fit_log_freq
        if self._nan_guard is not None:
            every = min(every, self._nan_guard.max_consecutive_skips)
        return max(int(every), 1)

    def _engine_sync(self, raise_on_limit=True):
        """The device counters into the host guard and scaler (may raise
        ``NanStepError`` at the consecutive-skip limit)."""
        self._steps_since_engine_sync = 0
        if self._jit_state is None:
            return
        self._jit_step_fn.sync(self._jit_state, nan_guard=self._nan_guard,
                               scaler=self._scaler,
                               raise_on_limit=raise_on_limit)

    def _fit_train_batch(self, inputs, labels):
        """``train_batch`` with the fit loop's contract: on the jit path
        the loss is an ``engine.DeviceLoss`` and the guard and scaler are
        reconciled at the cadence, not every step."""
        if not self._use_jit:
            return self.train_batch(inputs, labels)
        self.network.train()
        return self._jit_train_batch(self._feeds(inputs),
                                     self._feeds(labels), lazy=True)

    def _sync_jit_state(self):
        """Mirror the jit step's optimizer slots into the optimizer (the
        parameters are the network's own, updated in place) and the device
        counters into the host guard and scaler, never raising: this also
        runs in ``fit``'s ``finally``."""
        if self._jit_state is not None:
            step = self._jit_step_fn
            step.write_back(self._jit_state, self._optimizer)
            step.sync(self._jit_state,
                                   nan_guard=self._nan_guard,
                                   scaler=self._scaler, raise_on_limit=False)

    def _opt_slots(self):
        """The optimizer slots the run draws from (``capture_rng``'s
        ``opt_state``: an optimizer's generators live there)."""
        if self._jit_state is not None:
            return self._jit_state['opt']
        return self._optimizer._accumulators if self._optimizer is not None \
            else None

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        self._sync_jit_state()
        inputs, labels = self._feeds(inputs), self._feeds(labels)
        losses = []
        with torch.no_grad():
            outs = self._forward(inputs)
            if self._loss is not None and labels:
                l = self._loss(*outs, *labels)
                losses = [float(x) for x in
                          (l if isinstance(l, (list, tuple)) else [l])]
        return losses, self._update_metrics(outs, labels)

    def predict_batch(self, inputs):
        """The network's outputs on ``inputs`` as numpy arrays."""
        self.network.eval()
        self._sync_jit_state()
        with torch.no_grad():
            outs = self._forward(self._feeds(inputs))
        return [o.cpu().numpy() for o in outs]

    def test_batch(self, inputs):
        """The reference's alias of ``predict_batch``."""
        return self.predict_batch(inputs)

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            resume_from=None, strategy=None):
        """Train for ``epochs`` epochs over ``train_data`` (a dataset, or a
        ``DataLoader``), evaluating ``eval_data`` every ``eval_freq``.

        ``resume_from``: a directory (or ``resilience.CheckpointManager``)
        a ``CheckpointSaver`` or ``engine.fit`` wrote. The newest intact
        checkpoint restores the network, the optimizer slots, the loss
        scale, the guard's counters and the RNG streams, and training
        continues from its epoch and step — bitwise as an uninterrupted run
        (``CheckpointSaver``'s layout) on a deterministic device. With none
        there, training starts fresh with a warning. A SIGTERM while a
        ``CheckpointSaver`` is active checkpoints at the next batch
        boundary and stops."""
        if strategy is not None:
            prev = self._sharding_cfg
            self._set_strategy(strategy)
            changed = self._sharding_cfg is not prev
            if self._sharding_cfg is not None and \
                    (changed or not self._use_jit):
                # sharding lives in the jit step: write earlier progress
                # back into the network first, the new state starts from it
                self._sync_jit_state()
                self._use_jit = True
                self._jit_step_fn, self._jit_state = self._new_step(), None
            elif changed and prev is not None and self._use_jit:
                # a knobs-off strategy turns sharding OFF
                self._sync_jit_state()
                self._jit_step_fn, self._jit_state = self._new_step(), None
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False, False,
                                      num_workers) \
            if eval_data is not None else None
        user_cbks = list(callbacks or [])
        if observability.enabled() and not any(
                isinstance(c, observability.TelemetryCallback)
                for c in user_cbks):
            # telemetry on: every fit() emits step events and spans without
            # code changes
            user_cbks.insert(0, observability.TelemetryCallback())
        cbks = CallbackList([ProgBarLogger(log_freq, verbose)] + user_cbks)
        cbks.set_model(self)
        # jit path: the loss stays on the device between log points; this
        # is the materialisation (and guard/scaler reconcile) cadence
        self._fit_log_freq = max(int(log_freq), 1)
        self._steps_since_engine_sync = 0
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks.set_params({'epochs': epochs, 'steps': steps,
                         'verbose': verbose})
        start_epoch, skip_steps, resume_rng = 0, 0, None
        if resume_from is not None:
            start_epoch, skip_steps, resume_rng = \
                self._restore_checkpoint(resume_from)
        cbks.on_train_begin()
        self.stop_training = False
        try:
            self._fit_loop(train_loader, eval_loader, cbks, epochs,
                           start_epoch, skip_steps, resume_rng, eval_freq,
                           save_dir, save_freq)
        finally:
            # always: on_train_end uninstalls CheckpointSaver's SIGTERM
            # handler, which must not outlive an exception
            self._sync_jit_state()
            cbks.on_train_end()
            # a run that skipped poisoned samples is not a clean run
            quarantined = train_loader.quarantine_report() \
                if isinstance(train_loader, DataLoader) else []
            if quarantined:
                warnings.warn(
                    f"DataLoader quarantined {len(quarantined)} poisoned "
                    f"sample(s) during fit(): {quarantined}",
                    RuntimeWarning, stacklevel=2)

    def _fit_loop(self, train_loader, eval_loader, cbks, epochs, start_epoch,
                  skip_steps, resume_rng, eval_freq, save_dir, save_freq):
        from ..resilience import capture_rng, restore_rng

        def restore(snapshot):
            restore_rng(snapshot, self.network, self._opt_slots())

        for epoch in range(start_epoch, epochs):
            resuming = resume_rng is not None and epoch == start_epoch
            if resuming and skip_steps == 0:
                # epoch-boundary resume: the streams continue where the
                # checkpoint left them, before this epoch's shuffle
                restore(resume_rng['save_point'])
            elif resuming:
                # mid-epoch resume: rewind to the epoch's start, so that
                # the loader below replays the interrupted epoch's shuffle
                restore(resume_rng['epoch_start'])
            # taken BEFORE the loader draws its shuffle: a preemption
            # checkpoint in this epoch replays the batch order from it
            self._epoch_start_rng = capture_rng(self.network,
                                                self._opt_slots())
            cbks.on_epoch_begin(epoch)
            logs = {}
            mid_restore_pending = resuming and skip_steps > 0
            for step, batch in enumerate(train_loader):
                if resuming and step < skip_steps:
                    continue   # trained before the preemption
                if mid_restore_pending:
                    # shuffle replayed, done steps skipped: now the exact
                    # streams of the preemption point
                    restore(resume_rng['save_point'])
                    mid_restore_pending = False
                cbks.on_train_batch_begin(step)
                ins, lbs = self._split_batch(batch)
                losses, metrics = self._fit_train_batch(ins, lbs)
                loss0 = losses[0]
                if step % self._fit_log_freq == 0 and \
                        not isinstance(loss0, float):
                    # the log cadence: where a jit step's loss reaches
                    # the host
                    loss0 = float(loss0)
                logs = {'loss': loss0}
                for m, res in zip(self._metrics, metrics):
                    names = m.name() if isinstance(m.name(), list) else \
                        [m.name()]
                    vals = res if isinstance(res, (list, tuple)) else [res]
                    for n, v in zip(names, vals):
                        logs[n] = float(v)
                cbks.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            if mid_restore_pending:
                # preempted on the epoch's last batch: nothing to retrain,
                # but the streams continue from the preemption point
                restore(resume_rng['save_point'])
            if self.stop_training:
                # preempted mid-epoch: the checkpoint holds this position;
                # no epoch-end bookkeeping for a partial epoch
                break
            if 'loss' in logs and not isinstance(logs['loss'], float):
                logs['loss'] = float(logs['loss'])   # epoch-boundary read
            cbks.on_epoch_end(epoch, logs)
            for m in self._metrics:
                m.reset()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                cbks.on_eval_end(eval_logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break

    def _restore_checkpoint(self, resume_from):
        """Restore the newest intact checkpoint -> ``(start_epoch,
        skip_steps, rng snapshots)``; with none, ``(0, 0, None)`` and a
        warning (the first run of a preemptible job has none yet)."""
        from ..resilience import CheckpointManager
        mgr = resume_from if isinstance(resume_from, CheckpointManager) \
            else CheckpointManager(resume_from)
        loaded = mgr.load()
        if loaded is None:
            warnings.warn(
                "Model.fit(resume_from=%r): no loadable checkpoint found — "
                "starting from scratch" % (mgr.path,))
            return 0, 0, None
        state, meta = loaded
        if 'model' not in state and 'params' in state:
            return self._restore_engine_checkpoint(mgr, state, meta)
        self.network.load_state_dict(state['model'])
        if self._optimizer is not None and state.get('opt') is not None:
            self._optimizer.set_state_dict(state['opt'])
        self._jit_state = None   # re-seeded from the optimizer's slots
        if self._scaler is not None and state.get('scaler') is not None:
            self._scaler.load_state_dict(state['scaler'])
        if self._nan_guard is not None and \
                state.get('nan_guard') is not None:
            self._nan_guard.load_state_dict(state['nan_guard'])
        rng = {'save_point': state.get('rng'),
               'epoch_start': state.get('epoch_start_rng')}
        return int(meta.get('epoch', 0)), int(meta.get('step_in_epoch', 0)), \
            rng

    def _restore_engine_checkpoint(self, mgr, state, meta):
        """An ``engine.fit`` checkpoint (the step's state: parameters by
        module path, the optimizer's slots, the guard's and the scaler's
        counters): copied into the network and the optimizer through a
        train step's ``adopt_state``. It skips the batches the checkpoint's
        dispatches consumed (dispatches x microbatch) and holds one RNG
        snapshot, its save point: exact for an epoch-boundary resume or an
        unshuffled loader (``engine.fit`` never shuffles)."""
        step = self._jit_step_fn if self._use_jit else self._new_step()
        live = step.adopt_state(state)
        step.write_back(live, self._optimizer)
        self._jit_state = live if self._use_jit else None
        if self._scaler is not None and 'scaler' in state:
            sc = state['scaler']
            self._scaler._scale = float(np.asarray(sc['scale']))
            self._scaler._good_steps = int(np.asarray(sc['good']))
            self._scaler._bad_steps = int(np.asarray(sc['bad']))
        if self._nan_guard is not None and 'guard' in state:
            g = state['guard']
            self._nan_guard.load_state_dict({
                'total_steps': int(np.asarray(g['steps'])),
                'skipped_steps': int(np.asarray(g['skipped'])),
                'consecutive_skips': int(np.asarray(g['consecutive']))})
        skip = int(meta.get('dispatch_in_epoch', 0)) * \
            int(meta.get('microbatch', 1))
        rng = None
        extra = mgr.load_extra(step=int(meta['dispatches'])
                               if meta.get('dispatches') is not None
                               else None)
        if extra is not None and extra.get('rng') is not None:
            rng = {'save_point': extra['rng'], 'epoch_start': extra['rng']}
        elif skip:
            # a position to honour but no streams: skip, streams as they are
            rng = {'save_point': None, 'epoch_start': None}
        return int(meta.get('epoch', 0)), skip, rng

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """-> ``{'loss': mean batch loss, <metric name>: value, ...}``;
        with telemetry on, also an ``eval_result`` event of them."""
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        total_loss, n = 0.0, 0
        for batch in loader:
            ins, lbs = self._split_batch(batch)
            losses, _ = self.eval_batch(ins, lbs)
            if losses:
                total_loss += losses[0]
                n += 1
        logs = {}
        if n:
            logs['loss'] = total_loss / n
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for nm, v in zip(names, vals):
                logs[nm] = v
        if observability.enabled():
            # the numbers reach the event log whether or not the console
            # line below is printed
            observability.event('eval_result', **{
                k: float(v) for k, v in logs.items()
                if isinstance(v, (int, float))})
        if verbose:
            print(' - '.join(f"{k}: {v:.4f}" for k, v in logs.items()))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """-> one list of numpy outputs a batch, or with ``stack_outputs``
        each output concatenated over the batches."""
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and
        ``path.pdopt`` (the optimizer's), through ``framework.save``."""
        if not training:
            raise _later('training=False', 'Model.save')
        self._sync_jit_state()
        from ..framework import save as fsave
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fsave(self.network.state_dict(), path + '.pdparams')
        if self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + '.pdopt')

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The counterpart of ``save``; ``skip_mismatch`` is accepted as
        the reference accepts it, and loading stays strict."""
        from ..framework import load as fload
        self.network.load_state_dict(fload(path + '.pdparams'))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + '.pdopt'):
            self._optimizer.set_state_dict(fload(path + '.pdopt'))
            self._jit_state = None   # re-seeded from the loaded slots

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtypes=dtype)

    # -- helpers ------------------------------------------------------------
    def _tensor(self, x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            x = np.asarray(x)
        return upload(x, self.device)

    def _feeds(self, x):
        """A batch part as the network takes it: a dict of keyword feeds,
        or a list of positional ones, each a tensor on the device."""
        if x is None:
            return []
        if isinstance(x, dict):
            return {k: self._tensor(v) for k, v in x.items()}
        return [self._tensor(v)
                for v in (x if isinstance(x, (list, tuple)) else [x])]

    def _forward(self, inputs):
        outs = self.network(**inputs) if isinstance(inputs, dict) \
            else self.network(*inputs)
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            return (batch[0], batch[1]) if len(batch) >= 2 else \
                (batch[0], [])
        return batch, []

    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers,
                          device=self.device)

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            computed = m.compute(outs[0], *labels)
            if isinstance(computed, (list, tuple)):
                results.append(m.update(*computed))
            else:
                results.append(m.update(computed))
        return results
