"""Bounded retry with exponential backoff + jitter. The port's own copy
of ``paddle_tpu/resilience/retry.py`` (stdlib only), without its telemetry
counter and event (the training side's telemetry, ROADMAP.md Queue 1
item 4b).

One decorator for every transient-failure site (downloads, coordinator
bring-up, shell-outs) so backoff policy lives in one place instead of
ad-hoc while-loops.
"""
import functools
import random
import time

__all__ = ['retry', 'RetryError', 'backoff_delay']

# seam for tests: patch to a recorder to assert backoff schedules
# without real sleeping
_sleep = time.sleep


def backoff_delay(attempt, backoff=0.1, factor=2.0, max_backoff=30.0,
                  jitter=0.5):
    """Delay (seconds) before 1-indexed ``attempt`` under the same policy
    the :func:`retry` decorator applies: ``backoff * factor**(attempt-1)``
    capped at ``max_backoff``, jittered uniformly in ``[1-j, 1+j]``.

    Public so other backoff consumers (the serving router's circuit-breaker
    cooldown, supervisor relaunch pacing) share ONE backoff curve instead
    of each growing a private exponential."""
    delay = min(backoff * (factor ** (max(1, int(attempt)) - 1)), max_backoff)
    if jitter:
        delay *= 1.0 + random.uniform(-jitter, jitter)
    return delay


class RetryError(RuntimeError):
    """All attempts failed. ``last_exception`` holds the final cause and
    ``attempts`` how many calls were made."""

    def __init__(self, message, last_exception=None, attempts=0):
        super().__init__(message)
        self.last_exception = last_exception
        self.attempts = attempts


def retry(max_attempts=3, backoff=0.1, factor=2.0, max_backoff=30.0,
          jitter=0.5, timeout=None, retry_on=(OSError, ConnectionError,
                                              TimeoutError), on_retry=None,
          reraise=False):
    """Decorator: call the function up to ``max_attempts`` times.

    Delay before attempt k (1-indexed) is ``backoff * factor**(k-1)``, capped
    at ``max_backoff``, multiplied by a uniform jitter in
    ``[1 - jitter, 1 + jitter]`` so a preempted fleet does not stampede a
    coordinator in lockstep. ``timeout`` bounds total elapsed time across
    attempts (seconds, measured from the first call). Only exceptions matching
    ``retry_on`` are retried; anything else propagates immediately.
    ``on_retry(attempt, exc, delay)`` is invoked before each sleep.
    ``reraise=True`` re-raises the final exception unchanged on exhaustion
    (for callers whose API contract names specific exception types) instead
    of wrapping it in :class:`RetryError`.
    """
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    retry_on = tuple(retry_on) if isinstance(retry_on, (list, tuple, set)) \
        else (retry_on,)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            start = time.monotonic()
            last = None
            for attempt in range(1, max_attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    last = e
                    if attempt == max_attempts:
                        break
                    delay = backoff_delay(attempt, backoff=backoff,
                                          factor=factor,
                                          max_backoff=max_backoff,
                                          jitter=jitter)
                    if timeout is not None and \
                            time.monotonic() - start + delay > timeout:
                        if reraise:
                            raise e
                        raise RetryError(
                            "%s: retry timeout (%.1fs) exhausted after %d "
                            "attempt(s): %s" % (getattr(fn, '__name__', fn),
                                                timeout, attempt, e),
                            last_exception=e, attempts=attempt) from e
                    if on_retry is not None:
                        on_retry(attempt, e, delay)
                    _retry_sleep(delay)
            if reraise:
                raise last
            raise RetryError(
                "%s: all %d attempt(s) failed: %s"
                % (getattr(fn, '__name__', fn), max_attempts, last),
                last_exception=last, attempts=max_attempts) from last
        return wrapper
    return deco


def _retry_sleep(delay):
    # indirect so tests patching retry._sleep take effect after decoration
    _sleep(delay)
