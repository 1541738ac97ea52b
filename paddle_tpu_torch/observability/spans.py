"""Span tracer: Chrome trace-event JSON + torch.profiler bridge.
The port's own copy of ``paddle_tpu/observability/spans.py``.

``span(name)`` times a host-side region and records a Chrome trace
"complete" event (``ph: "X"``, microsecond ``ts``/``dur``) into a bounded
in-process buffer; ``dump_chrome_trace(path)`` writes the buffer as a JSON
array that loads in Perfetto / chrome://tracing. ``async_begin`` /
``async_instant`` / ``async_end`` record nestable Chrome async events
(``ph: b/n/e``) sharing a ``cat`` + ``id`` pair: the serving engine
threads each request's id through them, so a request's life (admitted,
batched or prefilled and decoded, completed) reads as one flow.

Two parts differ from the reference, whose device is driven by JAX:

- **the bridge**: while a ``torch.profiler`` session is active, every span
  also enters ``torch.profiler.record_function(name)`` (the reference
  enters ``jax.profiler.TraceAnnotation``), so the same region shows in
  the profiler's trace. It engages with telemetry off too, and adds no
  device work: a host-side range only.
- **the sampled sync**: a span wrapping dispatched device work measures
  only the host's dispatch time unless it waits. ``span(name,
  sync=value)`` waits for the device work behind ``value`` (each CUDA
  tensor in it: a ``synchronize()`` of its device's current stream, the
  reference's ``jax.block_until_ready``) on a *sampled* subset of
  occurrences: the 1st and every ``PADDLE_TPU_TELEMETRY_SYNC_EVERY``-th
  per span name (default 16), so timing adds no unsampled host sync.
  Synced occurrences carry ``args.synced: true``. Where the reference
  swallows every exception of that wait, the port lets it propagate: a
  CUDA error raised there is a kernel's failure.
"""
import json
import os
import threading
import time

from . import state

__all__ = ['span', 'Span', 'dump_chrome_trace', 'trace_events',
           'async_begin', 'async_instant', 'async_end',
           'clear', 'MAX_TRACE_EVENTS']

MAX_TRACE_EVENTS = 65536

_lock = threading.Lock()
_events = []
_dropped = [0]
_sync_counts = {}
_EPOCH = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _EPOCH) * 1e6


def _device_trace_active():
    """True while a torch.profiler session is recording."""
    import torch
    return torch.autograd._profiler_enabled()


def _should_sync(name):
    every = state.sync_every()
    if every <= 0:
        return False
    with _lock:
        n = _sync_counts.get(name, 0)
        _sync_counts[name] = n + 1
    return n % every == 0


def _devices(value, out):
    """The CUDA devices of every tensor in ``value`` (through dict, list
    and tuple structure)."""
    if isinstance(value, dict):
        for v in value.values():
            _devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _devices(v, out)
    else:
        dev = getattr(value, 'device', None)
        if getattr(dev, 'type', None) == 'cuda':
            out.add(dev)
    return out


def wait_device(value):
    """Wait for the device work behind ``value``: its CUDA tensors'
    devices' current streams. Host values have none to wait for."""
    devices = _devices(value, set())
    if devices:
        import torch
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()


def _record(name, ts_us, dur_us, args):
    ev = {'name': name, 'ph': 'X', 'ts': round(ts_us, 3),
          'dur': round(dur_us, 3), 'pid': os.getpid(),
          'tid': threading.get_ident()}
    if args:
        ev['args'] = args
    with _lock:
        if len(_events) >= MAX_TRACE_EVENTS:
            _dropped[0] += 1
            return
        _events.append(ev)


class Span:
    """Reentrant-per-instance context manager; use via ``span(name, ...)``.

    The profiler bridge engages whenever a torch.profiler session is
    active, independent of the telemetry switch; the Chrome-trace record
    is only kept while telemetry is enabled.
    """

    __slots__ = ('name', 'sync', 'args', '_t0', '_bridge', '_recording')

    def __init__(self, name, sync=None, **attrs):
        self.name = name
        self.sync = sync
        self.args = dict(attrs) if attrs else None
        self._t0 = 0.0
        self._bridge = None
        self._recording = False

    def __enter__(self):
        self._recording = state.enabled()
        if _device_trace_active():
            import torch
            self._bridge = torch.profiler.record_function(self.name)
            self._bridge.__enter__()
        if self._recording:
            self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._recording:
                if self.sync is not None and exc_type is None and \
                        _should_sync(self.name):
                    # a callable defers capture to exit time, for values
                    # that only exist once the wrapped block ran
                    val = self.sync() if callable(self.sync) else self.sync
                    if val is not None:
                        wait_device(val)
                        self.args = dict(self.args or {})
                        self.args['synced'] = True
                t1 = _now_us()
                _record(self.name, self._t0, t1 - self._t0, self.args)
        finally:
            if self._bridge is not None:
                self._bridge.__exit__(exc_type, exc, tb)
                self._bridge = None
        return False


def span(name, sync=None, **attrs):
    """Context manager timing a named host region (see module docstring)."""
    return Span(name, sync=sync, **attrs)


def _record_async(ph, name, aid, cat, args):
    if not state.enabled():
        return
    ev = {'name': name, 'ph': ph, 'cat': cat, 'id': str(aid),
          'ts': round(_now_us(), 3), 'pid': os.getpid(),
          'tid': threading.get_ident()}
    if args:
        ev['args'] = args
    with _lock:
        if len(_events) >= MAX_TRACE_EVENTS:
            _dropped[0] += 1
            return
        _events.append(ev)


def async_begin(name, aid, cat='async', **args):
    """Open one async lane: events sharing ``(cat, id)`` until the matching
    ``async_end`` render as a single connected flow in Perfetto."""
    _record_async('b', name, aid, cat, args or None)


def async_instant(name, aid, cat='async', **args):
    """A point milestone on an open async lane (``ph: 'n'``)."""
    _record_async('n', name, aid, cat, args or None)


def async_end(name, aid, cat='async', **args):
    _record_async('e', name, aid, cat, args or None)


def trace_events():
    with _lock:
        return list(_events)


def dropped():
    return _dropped[0]


def clear():
    with _lock:
        _events.clear()
        _sync_counts.clear()
        _dropped[0] = 0


def dump_chrome_trace(path):
    """Write buffered spans as a Chrome trace-event JSON array (loads in
    Perfetto / chrome://tracing). Returns the number of events written."""
    evs = trace_events()
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(evs, f)
    return len(evs)
