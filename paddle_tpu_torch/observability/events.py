"""Step-event log: bounded in-memory buffer of structured events + JSONL.
The port's own copy of ``paddle_tpu/observability/events.py``.

Every noteworthy runtime occurrence (a served request, a shed, a page
stall) is one flat dict ``{'ev': kind, 'ts': wall seconds, ...fields}``.
Events accumulate in a bounded ring (newest win) and are exported as JSONL
by ``dump_jsonl()``. An optional live sink streams each event to disk as
it is emitted. Every emitted event is also mirrored into the flight
recorder's always-on ring (``flight.py``).
"""
import collections
import json
import threading
import time

from . import flight, state

__all__ = ['emit', 'events', 'clear', 'dump_jsonl', 'set_sink',
           'close_sink', 'wall_ts', 'MAX_EVENTS']

MAX_EVENTS = 16384

_lock = threading.Lock()
_buf = collections.deque(maxlen=MAX_EVENTS)
_sink = None          # open file object, or None
_dropped = [0]


def wall_ts():
    """Wall-clock timestamp for event records (seconds since epoch);
    durations go through ``observability.timer``."""
    return time.time()


def emit(kind, **fields):
    """Record one event. No-op unless telemetry is enabled."""
    if not state.enabled():
        return None
    rec = {'ev': str(kind), 'ts': round(wall_ts(), 6)}
    rec.update(fields)
    # the flight recorder's ring mirrors every event so a crash dump
    # carries the last seconds even if no flusher ever fired
    flight.note(rec)
    with _lock:
        if len(_buf) == _buf.maxlen:
            _dropped[0] += 1
        _buf.append(rec)
        if _sink is not None:
            try:
                _sink.write(json.dumps(rec, sort_keys=True,
                                       default=_jsonable) + '\n')
                _sink.flush()
            except (OSError, ValueError):
                pass
    return rec


def events():
    """Snapshot of the buffered events, oldest first."""
    with _lock:
        return list(_buf)


def dropped():
    return _dropped[0]


def clear():
    with _lock:
        _buf.clear()
        _dropped[0] = 0


def dump_jsonl(path):
    """Write every buffered event to ``path`` as JSON-lines; returns the
    number of events written."""
    recs = events()
    with open(path, 'w', encoding='utf-8') as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True, default=_jsonable) + '\n')
    return len(recs)


def set_sink(path):
    """Stream subsequent events live to ``path`` (append). Returns the path."""
    global _sink
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = open(path, 'a', encoding='utf-8')
    return path


def close_sink():
    global _sink
    with _lock:
        if _sink is not None:
            _sink.close()
            _sink = None


def _jsonable(o):
    """Last-resort encoder: numpy scalars and one-element tensors ->
    python, everything else repr."""
    try:
        return o.item()
    except (AttributeError, ValueError):
        return repr(o)
