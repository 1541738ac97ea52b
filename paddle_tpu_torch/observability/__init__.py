"""paddle_tpu_torch.observability: the port's telemetry spine.
Counterpart of ``paddle_tpu/observability`` (its serving half).

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
  ``/events``, ``/timeseries``).

Everything is off (one flag check a site) until ``PADDLE_TPU_TELEMETRY=1``
or ``observability.enable()``; the flight recorder's ring is on unless
``PADDLE_TPU_FLIGHT=0``. The serving engine, its runners and
``serving.admission`` report here.

Not ported yet (ROADMAP.md, Queue 1 item 4b): ``doctor``, ``aggregate``,
``flush``, ``baseline``, ``costs`` and ``callback``
(``TelemetryCallback``), and the training side's telemetry: ``hapi.Model``
and ``engine.fit`` raise while telemetry is on.

Modules here import nothing but the standard library and each other at
import time; torch is imported inside the functions that need it.
"""
from . import events as _events
from . import (endpoint, flight, interpose, registry, slo,  # noqa: F401
               spans, state, timeseries, timing)
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
from .endpoint import MetricsServer

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
    'counters_summary', 'endpoint', 'MetricsServer', 'slo', 'flight',
    'timeseries',
]


def reset():
    """Clear every buffer (metrics, events, spans, SLO tallies, flight
    ring, time-series ring): the test isolation hook."""
    reset_metrics()
    _events.clear()
    spans.clear()
    slo.reset()
    flight.clear()
    timeseries.clear()


# honor PADDLE_TPU_TELEMETRY=1 from the environment: state already read the
# flag; bring the build hook up with it
if enabled():
    install_build_hooks()
