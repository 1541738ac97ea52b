"""Bounded waits: the primitives that keep one dead participant from
hanging the whole job. The port's own copy of
``paddle_tpu/resilience/watchdog.py`` (stdlib only), without the
supervisor's ``Heartbeat`` and ``heartbeat_age`` (they come with the
fleet supervisor) and without the flight-recorder dump a timeout makes
there (the training side's telemetry, ROADMAP.md Queue 1 item 4b).

Every blocking wait in library code (queue gets, thread and process joins,
child-process waits) goes through these helpers instead of the unbounded
stdlib calls, so a producer that died without posting its sentinel, or a
child that will never exit, becomes a loud ``WatchdogTimeout`` instead of
a silent stall:

- ``bounded_get(q, ...)``: ``queue.Queue.get`` in short ticks with an
  optional overall deadline and an optional ``alive()`` probe;
- ``join_thread`` / ``join_proc`` / ``wait_proc``: tick-based joins that
  stay interruptible and report (rather than swallow) expiry.
"""
import queue
import time

__all__ = ['WatchdogTimeout', 'bounded_get', 'join_thread', 'join_proc',
           'wait_proc', 'DEFAULT_TICK']

# Tick between liveness probes: short enough that a dead producer is
# reported promptly, long enough that the poll is free next to any real
# batch-assembly work.
DEFAULT_TICK = 0.1


class WatchdogTimeout(RuntimeError):
    """A bounded wait expired (or every producer died) before the item
    arrived. ``.what`` names the wait; ``.waited`` is the elapsed seconds."""

    def __init__(self, message, what='wait', waited=0.0):
        super().__init__(message)
        self.what = what
        self.waited = waited


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
