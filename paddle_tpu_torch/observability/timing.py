"""Timing helpers. The port's own copy of
``paddle_tpu/observability/timing.py``.

- ``Stopwatch``: a monotonic elapsed-time reader for code that needs the
  number itself (deadlines, phase breakdowns).
- ``timer(name)``: context manager that times a block into the metrics
  registry (histogram ``<name>_ms`` + counter ``<name>.calls``) and emits a
  span: one line at a call site, and the duration is visible in the
  Prometheus exposition, the snapshot and the Chrome trace at once.

Timestamps (as opposed to durations) come from ``events.wall_ts()``.
"""
import time

from . import registry, spans, state

__all__ = ['Stopwatch', 'timer']


class Stopwatch:
    """Monotonic elapsed-time reader; starts at construction.

    ``perf_counter``-backed: immune to wall-clock steps (NTP), valid only
    for durations within one process.
    """

    __slots__ = ('_t0',)

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self):
        self._t0 = time.perf_counter()

    def elapsed(self):
        """Seconds since construction/restart."""
        return time.perf_counter() - self._t0

    def elapsed_ms(self):
        return self.elapsed() * 1e3


class _Timer:
    __slots__ = ('name', '_span', '_sw', 'elapsed_ms')

    def __init__(self, name, sync=None, **attrs):
        self.name = name
        self._span = spans.Span(name, sync=sync, **attrs)
        self._sw = None
        self.elapsed_ms = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._sw = Stopwatch()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed_ms = self._sw.elapsed_ms()
        out = self._span.__exit__(exc_type, exc, tb)
        if state.enabled():
            registry.counter(self.name + '.calls').inc()
            registry.histogram(self.name + '_ms').observe(self.elapsed_ms)
        return out


def timer(name, sync=None, **attrs):
    """Time a block into the registry + span buffer (no-op when disabled
    beyond a Stopwatch read). ``sync`` follows the span sampled-sync rule."""
    return _Timer(name, sync=sync, **attrs)
