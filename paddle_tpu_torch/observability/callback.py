"""TelemetryCallback: hapi.Model.fit instrumentation. The port's own copy
of ``paddle_tpu/observability/callback.py``.

Wires the high-level training loop into the telemetry spine: a span per
step and per epoch, ``hapi.steps``/``hapi.step_ms``/``hapi.steps_per_sec``
metrics, a ``step`` event per batch (epoch, step, loss, step_ms) in the
step-event log, and — at train end — the JSONL event log plus the Chrome
trace written under ``log_dir``, a ``train_end`` summary event carrying
the interposed counters (kernel builds, host-transfer bytes, the
training tallies) and the doctor's findings as ``diagnosis`` events.

``Model.fit`` attaches one automatically while telemetry is enabled
(``PADDLE_TPU_TELEMETRY=1`` or ``observability.enable()``), so a
production run gets step events without code changes; pass your own
instance to control ``log_dir``. The reference's ``hapi.jit_cache_size``
gauge reads the size of its jitted step's XLA cache; an eager step has no
such cache, so the port has no such gauge.
"""
import os

from ..hapi.callbacks import Callback
from . import (doctor, endpoint, events, flight, flush, interpose, registry,
               spans, state, timeseries, timing)

__all__ = ['TelemetryCallback']


class TelemetryCallback(Callback):
    def __init__(self, log_dir=None, live_events=False):
        """``log_dir``: where ``events.jsonl`` / ``trace.json`` land at train
        end (default ``PADDLE_TPU_TELEMETRY_DIR``). ``live_events=True``
        additionally streams each event to ``events.jsonl`` as it is emitted
        (crash-tolerant, one extra host write per step)."""
        super().__init__()
        self.log_dir = log_dir
        self.live_events = live_events
        self._epoch = 0
        self._step_span = None
        self._epoch_timer = None
        self._train_sw = None
        self._steps_per_sec = None
        self._own_flusher = False
        self._own_sampler = False

    def _dir(self):
        return self.log_dir or state.log_dir()

    # -- train lifecycle ----------------------------------------------------
    def on_train_begin(self, logs=None):
        # the flight recorder's crash hooks ride along regardless of the
        # telemetry switch: a SIGTERM'd fit leaves its black box behind
        flight.install_crash_hooks()
        if not state.enabled():
            return
        self._train_sw = timing.Stopwatch()
        if self.live_events:
            d = self._dir()
            os.makedirs(d, exist_ok=True)
            events.set_sink(os.path.join(d, 'events.jsonl'))
        # mission control: inside a supervised cluster run, stream this
        # rank's telemetry to the run dir; with PADDLE_TPU_TELEMETRY_HTTP
        # set, export the live /metrics + /healthz endpoint for this fit
        had = flush.active_flusher() is not None
        self._own_flusher = (flush.start_rank_flusher() is not None
                             and not had)
        # the ring sampler runs for every telemetry-on fit (not just
        # supervised cluster runs): live /timeseries and the doctor's
        # trend detectors want timelines even single-process
        had_sampler = timeseries.active_sampler() is not None
        self._own_sampler = (timeseries.start_sampler() is not None
                             and not had_sampler)
        endpoint.maybe_start_from_env()
        events.emit('train_begin', epochs=self.params.get('epochs'),
                    steps=self.params.get('steps'))

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        if not state.enabled():
            return
        self._epoch_timer = timing.timer('hapi.epoch', epoch=epoch)
        self._epoch_timer.__enter__()
        events.emit('epoch_begin', epoch=epoch)

    def on_train_batch_begin(self, step, logs=None):
        if not state.enabled():
            return
        self._step_span = timing.timer('hapi.step', epoch=self._epoch,
                                       step=step)
        self._step_span.__enter__()

    def on_train_batch_end(self, step, logs=None):
        if self._step_span is None:
            return
        t = self._step_span
        self._step_span = None
        t.__exit__(None, None, None)
        if not state.enabled():
            return
        registry.counter('hapi.steps').inc()
        step_s = t.elapsed_ms / 1e3
        if step_s > 0:
            sps = 1.0 / step_s
            # EMA so the gauge reads steady-state throughput, not the last
            # batch's jitter
            self._steps_per_sec = sps if self._steps_per_sec is None else \
                0.9 * self._steps_per_sec + 0.1 * sps
            registry.gauge('hapi.steps_per_sec').set(
                round(self._steps_per_sec, 3))
        rec = {'epoch': self._epoch, 'step': step,
               'step_ms': round(t.elapsed_ms, 3)}
        loss = (logs or {}).get('loss')
        if isinstance(loss, (int, float)):
            rec['loss'] = float(loss)
        elif loss is not None:
            # engine DeviceLoss: record it only when the fit loop already
            # materialized it (log cadence) — the step event must never add
            # a host sync the steady-state pipeline would not have had
            ready = getattr(loss, 'is_ready', None)
            if ready is not None and ready():
                rec['loss'] = float(loss)
            elif ready is None:
                rec['loss'] = float(loss)
        events.emit('step', **rec)

    def on_epoch_end(self, epoch, logs=None):
        if self._epoch_timer is not None:
            self._epoch_timer.__exit__(None, None, None)
            self._epoch_timer = None
        if not state.enabled():
            return
        rec = {'epoch': epoch}
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float)):
                rec[k] = float(v)
        events.emit('epoch_end', **rec)

    def on_eval_end(self, logs=None):
        if not state.enabled():
            return
        rec = {k: float(v) for k, v in (logs or {}).items()
               if isinstance(v, (int, float))}
        events.emit('eval_end', **rec)

    def on_train_end(self, logs=None):
        if self._step_span is not None:   # interrupted mid-batch
            self._step_span.__exit__(None, None, None)
            self._step_span = None
        if self._epoch_timer is not None:
            self._epoch_timer.__exit__(None, None, None)
            self._epoch_timer = None
        if not state.enabled():
            return
        events.emit('train_end',
                    total_s=round(self._train_sw.elapsed(), 3)
                    if self._train_sw else None,
                    counters=interpose.summary())
        # anomaly doctor over this run's own stream (input-boundness,
        # checkpoint stalls): the findings land as `diagnosis` events so the
        # JSONL export below carries them
        try:
            doctor.run_doctor(events=events.events(),
                              snapshot=registry.snapshot(), emit=True)
        except Exception:
            pass   # diagnosis must never fail a training run
        # final per-rank flush so the aggregator sees the whole fit; the
        # flusher is only torn down when this fit started it (one started
        # by the caller outlives the fit)
        sm = timeseries.active_sampler()
        if sm is not None:
            sm.sample_now()   # the run's tail lands in the ring
            if self._own_sampler:
                timeseries.stop_sampler()
                self._own_sampler = False
        fl = flush.active_flusher()
        if fl is not None:
            if self._own_flusher:
                flush.stop_rank_flusher()
                self._own_flusher = False
            else:
                fl.flush_now()
        if self.live_events:
            events.close_sink()
        d = self._dir()
        try:
            os.makedirs(d, exist_ok=True)
            events.dump_jsonl(os.path.join(d, 'events.jsonl'))
            spans.dump_chrome_trace(os.path.join(d, 'trace.json'))
        except OSError:
            pass   # telemetry export must never fail a training run
