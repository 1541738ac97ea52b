"""Flight recorder: an always-on black box for crash post-mortems.
The port's own copy of ``paddle_tpu/observability/flight.py``.

A bounded ring buffer of the most recent runtime events that is on **even
when full telemetry is off** (one deque append under a lock per record),
dumped atomically to ``flight_rank<R>.json`` when the process dies an
abnormal death: SIGTERM (the handler installed by ``install_crash_hooks``)
and unhandled exceptions on the main thread (``sys.excepthook``) and on
worker threads (``threading.excepthook``). ``ServingEngine.start()``
installs the hooks. Each hook chains the one it replaced: a SIGTERM still
reaches a ``resilience.PreemptionGuard`` installed before the hooks, and a
guard installed after them takes the signal itself.

While telemetry is enabled, every event (``observability.event``) is
mirrored into the ring; always-on sites call ``flight.record`` directly.
The dump is one JSON document committed by a staged write and
``os.replace`` (a reader never parses a torn file) and carries the ring,
a metrics snapshot, the interposed-counter summary and the cost ledger's
summary. ``resilience.NanGuard`` dumps on its abort and a
``resilience.watchdog.WatchdogTimeout`` records itself and dumps
(rate-limited) to a file of its own.

Env knobs (see also ``state.py``):

- ``PADDLE_TPU_FLIGHT=0``        disable the recorder entirely
- ``PADDLE_TPU_FLIGHT_EVENTS``   ring capacity (default 512 records)
- ``PADDLE_TPU_FLIGHT_DIR``      where dumps land (default: the cluster
                                 run dir when supervised, else the
                                 telemetry log dir)

Stdlib-only.
"""
import collections
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback

from . import state
from .state import _env_int

__all__ = ['record', 'note', 'records', 'dump', 'dump_path', 'enabled',
           'install_crash_hooks', 'uninstall_crash_hooks', 'hooks_installed',
           'clear', 'load_dump', 'MAX_RECORDS']

MAX_RECORDS = max(_env_int('PADDLE_TPU_FLIGHT_EVENTS', 512), 1)

_DISABLED = os.environ.get('PADDLE_TPU_FLIGHT', '') == '0'
_lock = threading.Lock()
_ring = collections.deque(maxlen=MAX_RECORDS)
_dumps = [0]
_last_dump = [None]


def enabled():
    """The recorder rides along unless PADDLE_TPU_FLIGHT=0 — deliberately
    NOT gated on the telemetry switch (a black box that only records when
    someone remembered to turn it on records nothing useful)."""
    return not _DISABLED


def record(kind, **fields):
    """Append one record to the ring (always-on; bounded memory)."""
    if _DISABLED:
        return None
    # wall timestamps, so that a post-mortem lines up with other logs
    rec = {'ev': str(kind), 'ts': round(time.time(), 6)}
    rec.update(fields)
    with _lock:
        _ring.append(rec)
    return rec


def note(rec):
    """Mirror an already-built event record (the events.emit hook)."""
    if _DISABLED:
        return
    with _lock:
        _ring.append(dict(rec))


def records():
    """Snapshot of the ring, oldest first."""
    with _lock:
        return list(_ring)


def clear():
    with _lock:
        _ring.clear()
    _dumps[0] = 0
    _last_dump[0] = None


rank_id = state.rank_id


def _dump_dir(run_dir=None):
    return (run_dir or os.environ.get('PADDLE_TPU_FLIGHT_DIR')
            or state.run_dir() or state.log_dir())


def dump_path(run_dir=None, filename=None):
    return os.path.join(_dump_dir(run_dir),
                        filename or f'flight_rank{rank_id()}.json')


def dump(reason, exc=None, run_dir=None, extra=None, filename=None):
    """Atomically write the black box; returns the path or None.

    Best-effort by contract: a failed dump must never mask the crash that
    triggered it. Repeated dumps overwrite the same file — each dump first
    records itself into the ring, so the final document still names every
    earlier trigger. ``filename`` redirects writers that must NOT clobber
    this rank's primary black box (the supervisor's rank-failure record,
    the watchdog's rate-limited dumps).
    """
    if _DISABLED:
        return None
    doc = {
        'schema': 1,
        'reason': str(reason),
        'ts': round(time.time(), 6),
        'rank': rank_id(),
        'pid': os.getpid(),
        'host': socket.gethostname(),
        'telemetry_enabled': state.enabled(),
        'dumps_before': _dumps[0],
    }
    if exc is not None:
        doc['exception'] = {
            'type': type(exc).__name__,
            'message': str(exc),
            'traceback': ''.join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
        }
    if extra:
        doc['extra'] = dict(extra)
    try:
        from . import costs, interpose, registry
        doc['metrics'] = registry.snapshot()
        doc['counters'] = interpose.summary()
        doc['costs'] = costs.summary()
    except Exception:
        pass   # a half-initialized process still gets its ring dumped
    doc['records'] = records()
    path = dump_path(run_dir, filename=filename)
    try:
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, 'w', encoding='utf-8') as f:   # atomic-ok: staged,
            f.write(json.dumps(doc, sort_keys=True,   # fsynced, then
                               default=repr))         # os.replace'd below
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        return None
    _dumps[0] += 1
    _last_dump[0] = path
    record('flight.dump', reason=str(reason), path=path)
    return path


def last_dump():
    return _last_dump[0]


def load_dump(path):
    """Parse a flight dump; None when the file is absent or torn (a
    partial write never parses — the atomic commit makes this the ONLY
    two outcomes)."""
    try:
        with open(path, 'r', encoding='utf-8') as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and 'reason' in doc else None


# -- crash hooks -------------------------------------------------------------

# the handlers each hook replaced, and this module's own ('mine'), so that
# an uninstall restores only where its own handler is still the one in place
_hooks = {'installed': False, 'sigterm': None, 'excepthook': None,
          'threading': None, 'mine': {}}


def hooks_installed():
    return _hooks['installed']


def install_crash_hooks():
    """Install the SIGTERM / sys.excepthook / threading.excepthook dump
    triggers (idempotent; previous handlers are chained, not replaced).
    The SIGTERM handler can only be installed from the main thread — the
    other two hooks still install elsewhere. Returns True when (already)
    installed."""
    if _DISABLED:
        return False
    if _hooks['installed']:
        return True

    prev_except = sys.excepthook

    def _excepthook(tp, val, tb):
        try:
            dump('unhandled_exception', exc=val)
        except Exception:
            pass
        prev_except(tp, val, tb)

    sys.excepthook = _excepthook
    _hooks['excepthook'] = prev_except
    _hooks['mine']['excepthook'] = _excepthook

    prev_thread = threading.excepthook

    def _threadhook(args):
        try:
            dump('worker_exception', exc=args.exc_value,
                 extra={'thread': getattr(args.thread, 'name', None)})
        except Exception:
            pass
        prev_thread(args)

    threading.excepthook = _threadhook
    _hooks['threading'] = prev_thread
    _hooks['mine']['threading'] = _threadhook

    try:
        prev_sig = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            try:
                dump('sigterm')
            except Exception:
                pass
            if callable(prev_sig):
                prev_sig(signum, frame)
            else:
                # restore the previous disposition and re-deliver so the
                # process still dies with the default SIGTERM semantics
                signal.signal(signal.SIGTERM,
                              prev_sig if prev_sig is not None
                              else signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
        _hooks['sigterm'] = prev_sig
        _hooks['mine']['sigterm'] = _on_sigterm
    except (ValueError, OSError, TypeError):
        pass   # not the main thread (or an embedded interpreter)
    _hooks['installed'] = True
    record('flight.hooks_installed')
    return True


def uninstall_crash_hooks():
    """Restore the chained handlers (``ServingEngine.stop()``, test
    isolation). Where a later handler replaced this module's own (a
    ``PreemptionGuard`` installed after the hooks), that one is left in
    place; the reference restores regardless."""
    if not _hooks['installed']:
        return
    mine = _hooks['mine']
    if _hooks['excepthook'] is not None:
        if sys.excepthook is mine.get('excepthook'):
            sys.excepthook = _hooks['excepthook']
        _hooks['excepthook'] = None
    if _hooks['threading'] is not None:
        if threading.excepthook is mine.get('threading'):
            threading.excepthook = _hooks['threading']
        _hooks['threading'] = None
    if _hooks['sigterm'] is not None:
        try:
            if signal.getsignal(signal.SIGTERM) is mine.get('sigterm'):
                signal.signal(signal.SIGTERM, _hooks['sigterm'])
        except (ValueError, OSError, TypeError):
            pass
        _hooks['sigterm'] = None
    mine.clear()
    _hooks['installed'] = False
