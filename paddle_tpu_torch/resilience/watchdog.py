"""Bounded waits and liveness: the primitives that keep one dead
participant from hanging the whole job. The port's own copy of
``paddle_tpu/resilience/watchdog.py`` (stdlib only).

Every blocking wait in library code (queue gets, thread and process joins,
child-process waits) goes through these helpers instead of the unbounded
stdlib calls, so a producer that died without posting its sentinel, or a
child that will never exit, becomes a loud ``WatchdogTimeout`` instead of
a silent stall:

- ``bounded_get(q, ...)``: ``queue.Queue.get`` in short ticks with an
  optional overall deadline and an optional ``alive()`` probe;
- ``join_thread`` / ``join_proc`` / ``wait_proc``: tick-based joins that
  stay interruptible and report (rather than swallow) expiry;
- ``Heartbeat``: a daemon thread touching a file every ``interval``
  seconds; supervisors read the mtime (``heartbeat_age``) to tell a busy
  participant from a wedged one.
"""
import os
import queue
import threading
import time

__all__ = ['WatchdogTimeout', 'bounded_get', 'join_thread', 'join_proc',
           'wait_proc', 'Heartbeat', 'heartbeat_age', 'DEFAULT_TICK']

# Tick between liveness probes: short enough that a dead producer is
# reported promptly, long enough that the poll is free next to any real
# batch-assembly work.
DEFAULT_TICK = 0.1

# rate limit of the watchdog's flight-recorder dumps: every timeout is
# RECORDED in the ring, but the disk dump is throttled (a client polling
# result(timeout=0.1) must not fsync a document per miss)
_FLIGHT_DUMP_EVERY_S = 5.0
_last_flight_dump = [None]


class WatchdogTimeout(RuntimeError):
    """A bounded wait expired (or every producer died) before the item
    arrived. ``.what`` names the wait; ``.waited`` is the elapsed seconds.

    Construction records into the observability flight recorder and dumps
    its black box (best-effort, always-on, at most one dump every
    ``_FLIGHT_DUMP_EVERY_S``): a watchdog firing usually means something
    is wedged or dead, and the ring's last seconds are the evidence. The
    dump goes to a file of its own (``flight_rank<R>_watchdog.json``) so a
    caught, routine client timeout never replaces the black box a real
    crash wrote. The import is lazy so this module stays safe to import
    from bare worker processes."""

    def __init__(self, message, what='wait', waited=0.0):
        super().__init__(message)
        self.what = what
        self.waited = waited
        try:
            from ..observability import flight
            flight.record('watchdog_timeout', what=what,
                          waited=round(waited, 3))
            now = time.monotonic()
            last = _last_flight_dump[0]
            if last is None or now - last >= _FLIGHT_DUMP_EVERY_S:
                _last_flight_dump[0] = now
                flight.dump(
                    'watchdog_timeout', exc=self,
                    extra={'what': what, 'waited': round(waited, 3)},
                    filename=f'flight_rank{flight.rank_id()}_watchdog.json')
        except Exception:
            pass   # the black box must never mask the timeout itself


def bounded_get(q, timeout=None, alive=None, what='queue item',
                tick=DEFAULT_TICK, on_dead=None):
    """``q.get()`` that cannot hang forever.

    Polls in ``tick``-second slices. Raises ``WatchdogTimeout`` when

    - ``timeout`` seconds pass with no item (``timeout=None`` = no overall
      deadline; the liveness probe still applies), or
    - ``alive()`` returns False while the queue is empty — the producers
      are gone and the sentinel/item can never arrive. ``on_dead()`` (when
      given) is called first and may raise a more specific error.
    """
    deadline = None if not timeout else time.monotonic() + timeout
    start = time.monotonic()
    while True:
        step = tick if deadline is None else \
            max(min(tick, deadline - time.monotonic()), 0.001)
        try:
            return q.get(timeout=step)
        except queue.Empty:
            pass
        waited = time.monotonic() - start
        if alive is not None and not alive():
            # one more bounded drain: the producer may have posted and died
            # between our get() and the probe (mp.Queue flushes through a
            # feeder thread, so allow a short grace period)
            try:
                return q.get(timeout=max(tick, 0.2))
            except queue.Empty:
                pass
            if on_dead is not None:
                on_dead()
            raise WatchdogTimeout(
                f"watchdog: every producer of {what} died without posting "
                f"it (waited {waited:.1f}s) — a worker crashed before its "
                "done sentinel", what=what, waited=waited)
        if deadline is not None and time.monotonic() >= deadline:
            raise WatchdogTimeout(
                f"watchdog: no {what} within {timeout:.1f}s "
                "(producers alive but not producing — deadlocked or hung "
                "worker)", what=what, waited=waited)


def join_thread(t, timeout=None, tick=0.5):
    """Join a thread in ticks (stays signal-interruptible). Returns True
    when the thread finished, False when ``timeout`` expired first
    (``timeout=None`` waits indefinitely, but never in one blocking call)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while t.is_alive():
        t.join(tick)
        if deadline is not None and time.monotonic() >= deadline \
                and t.is_alive():
            return False
    return True


def join_proc(p, timeout=None, tick=0.25):
    """Tick-based join for a multiprocessing.Process-like object (join/
    is_alive). Same contract as ``join_thread``."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while p.is_alive():
        p.join(tick)
        if deadline is not None and time.monotonic() >= deadline \
                and p.is_alive():
            return False
    return True


def wait_proc(popen, timeout=None, tick=0.25):
    """Tick-based ``subprocess.Popen.wait``. Returns the exit code, or
    None when ``timeout`` expired with the child still running."""
    import subprocess
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        try:
            return popen.wait(tick)
        except subprocess.TimeoutExpired:
            if deadline is not None and time.monotonic() >= deadline:
                return None


class Heartbeat:
    """Touch ``path`` every ``interval`` seconds from a daemon thread.

    A supervisor that can see the file tells "busy in a long kernel build"
    (fresh heartbeat) from "wedged in a wait that will never end" (stale
    heartbeat): liveness, not just existence.
    """

    def __init__(self, path, interval=0.5):
        self.path = os.fspath(path)
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread = None

    def _beat_once(self):
        try:
            with open(self.path, 'a'):
                os.utime(self.path, None)
        except OSError:
            pass   # result dir vanished (parent cleanup): nothing to report

    def _run(self):
        while not self._stop.wait(self.interval):
            self._beat_once()

    def start(self):
        if self._thread is None:
            self._beat_once()
            self._thread = threading.Thread(
                target=self._run, name='paddle-tpu-torch-heartbeat',
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            join_thread(self._thread, timeout=self.interval * 4)
            self._thread = None


def heartbeat_age(path):
    """Seconds since the heartbeat file was last touched, or None when it
    was never written (the participant died before its first beat, or no
    heartbeat was configured)."""
    try:
        # comparing against a file mtime needs the wall clock
        return max(time.time() - os.path.getmtime(path), 0.0)
    except OSError:
        return None
