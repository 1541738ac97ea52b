"""Preemption (SIGTERM) handling for training loops. The port's own copy
of ``paddle_tpu/resilience/preempt.py`` (stdlib only).

Fleet schedulers preempt with SIGTERM and a grace window; the default
Python behavior (immediate KeyboardInterrupt-style death) loses everything
since the last checkpoint. ``PreemptionGuard`` converts the signal into a
cooperative flag the training loop polls at step boundaries, so the loop can
checkpoint and exit cleanly inside the grace window.

Signal handlers can only be installed from the main thread; elsewhere the
guard degrades to an inert flag (``installed`` stays False) instead of
raising, so worker-thread training remains usable.
"""
import signal
import threading
import warnings

__all__ = ['PreemptionGuard']


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,), on_preempt=None):
        self._signals = tuple(signals)
        self._on_preempt = on_preempt
        self._prev = {}
        self.preempted = False
        self.installed = False

    def _handler(self, signum, frame):
        self.preempted = True
        if self._on_preempt is not None:
            self._on_preempt(signum)

    def install(self):
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            warnings.warn(
                "PreemptionGuard: not on the main thread — signal handlers "
                "cannot be installed; preemption will not be caught")
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        self.installed = True
        return self

    def uninstall(self):
        if not self.installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):   # interpreter shutting down
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
