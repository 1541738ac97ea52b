"""paddle_tpu_torch.observability: the port's telemetry spine.
Counterpart of ``paddle_tpu/observability``.

- a process-wide **metrics registry** (``counter``/``gauge``/``histogram``)
  with JSONL event export and Prometheus text exposition, byte-identical
  to the reference's for the same calls;
- a **span tracer** emitting Chrome trace-event JSON that bridges into
  ``torch.profiler.record_function`` while a profiler session is active,
  with a sampled device wait (``spans``);
- **interposed counters**: kernel builds (``kernels.builds``,
  ``kernels.build_ms``) and host-transfer bytes;
- the **SLO tracker** (``slo``), the always-on **flight recorder**
  (``flight``), the in-run **time series** (``timeseries``) and the live
  **endpoint** (``endpoint.MetricsServer``: ``/metrics``, ``/healthz``,
  ``/events``, ``/diagnosis``, ``/costs``, ``/timeseries``);
- **mission control**: per-rank telemetry flushed into a run dir
  (``flush``), merged into one cluster snapshot and a trace with a lane a
  rank (``aggregate``), diagnosed by the anomaly **doctor**'s detectors
  with fix-it hints (``doctor``), the cross-run registry (``baseline``);
- the **cost explorer** (``costs``): each program's FLOPs, bytes, peak
  memory and roofline, counted on its first dispatch.

Everything is off (one flag check a site) until ``PADDLE_TPU_TELEMETRY=1``
or ``observability.enable()``; the flight recorder's ring is on unless
``PADDLE_TPU_FLIGHT=0``. The serving engine and its runners,
``serving.admission``, ``engine.build_train_step`` and ``engine.fit``,
the optimizers' eager ``step()``, ``resilience`` (checkpoints, retries,
the NaN guard, the watchdog), ``io.DataLoader`` and ``hapi.Model.fit``
(``TelemetryCallback``, attached automatically) report here.

Modules here import nothing but the standard library and each other at
import time; torch is imported inside the functions that need it.
"""
from . import events as _events
from . import interpose, registry, spans, state, timing  # noqa: F401
from . import aggregate, doctor, endpoint, flush  # noqa: F401  mission ctl
from . import costs, flight, slo  # noqa: F401  cost explorer + black box
from . import baseline, timeseries  # noqa: F401  time series + sentinel
from .state import disable, enable, enabled, log_dir, sync_every
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       counter, gauge, get_registry, histogram, snapshot,
                       to_prometheus)
from .registry import reset as reset_metrics
from .spans import (Span, async_begin, async_end, async_instant,
                    dump_chrome_trace, span, trace_events)
from .timing import Stopwatch, timer
from .interpose import (install_build_hooks, record_collective,
                        record_host_transfer)
from .interpose import summary as counters_summary
from .flush import start_rank_flusher, stop_rank_flusher
from .endpoint import MetricsServer
from .doctor import diagnose, run_doctor

# event-log surface (module name 'events' is kept for the submodule; the
# buffered-event accessor is exported as event_log to avoid shadowing it)
event = _events.emit
event_log = _events.events
dump_jsonl = _events.dump_jsonl
set_sink = _events.set_sink
close_sink = _events.close_sink
wall_ts = _events.wall_ts

__all__ = [
    'enable', 'disable', 'enabled', 'log_dir', 'sync_every',
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry', 'get_registry',
    'counter', 'gauge', 'histogram', 'snapshot', 'to_prometheus',
    'reset_metrics', 'reset',
    'span', 'Span', 'dump_chrome_trace', 'trace_events',
    'async_begin', 'async_instant', 'async_end',
    'event', 'event_log', 'dump_jsonl', 'set_sink', 'close_sink', 'wall_ts',
    'Stopwatch', 'timer',
    'install_build_hooks', 'record_host_transfer', 'record_collective',
    'counters_summary', 'TelemetryCallback',
    # mission control
    'aggregate', 'doctor', 'endpoint', 'flush',
    'start_rank_flusher', 'stop_rank_flusher', 'MetricsServer',
    'diagnose', 'run_doctor',
    # cost explorer + SLO tracker + flight recorder
    'costs', 'slo', 'flight',
    # time series + cross-run regression sentinel
    'baseline', 'timeseries',
]


def reset():
    """Clear every buffer (metrics, events, spans, cost ledger, SLO
    tallies, flight ring, time-series ring): the test isolation hook."""
    reset_metrics()
    _events.clear()
    spans.clear()
    costs.reset()
    slo.reset()
    flight.clear()
    timeseries.clear()


def __getattr__(name):
    # TelemetryCallback subclasses hapi.Callback; resolving it lazily keeps
    # this package importable before hapi is
    if name == 'TelemetryCallback':
        from .callback import TelemetryCallback
        return TelemetryCallback
    raise AttributeError(name)


# honor PADDLE_TPU_TELEMETRY=1 from the environment: state already read the
# flag; bring the build hook up with it
if enabled():
    install_build_hooks()
