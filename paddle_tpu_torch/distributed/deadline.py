"""The process-wide collective deadline. Counterpart of
``paddle_tpu/distributed/deadline.py``.

A collective that can never complete (a peer rank died, a wedged device)
must fail the job loudly within a bounded time, not stall it forever:

- ``set_timeout(seconds)`` / ``get_timeout()``: the deadline of the eager
  collectives, ``barrier()`` and the rendezvous. ``None`` or ``0``
  disables it (the default: a deadline on the hot path is the operator's
  decision); ``PADDLE_TPU_DIST_TIMEOUT`` seeds it from the environment;
- ``run_with_deadline(op, launch)``: ``launch(async_op)`` issues the
  collective. With no deadline it is issued as a plain (stream-ordered)
  call and nothing waits for it. With one, it is issued with
  ``async_op=True`` and its ``Work.wait(timeout)`` bounds it, on the
  calling thread (the reference joins a helper thread instead; PyTorch's
  process group carries its own timeout); expiry raises
  ``DistributedTimeoutError`` naming the op, the group and the ranks whose
  supervisor heartbeats went stale.

``faultinject.slow_collective`` installs ``_delay_hook``, called with the
op's name before the collective is issued; its delay counts against the
deadline, as in the reference.
"""
import datetime
import os
import time

from .. import observability as _obs

__all__ = ['DistributedTimeoutError', 'set_timeout', 'get_timeout',
           'run_with_deadline']


class DistributedTimeoutError(RuntimeError):
    """A collective or the rendezvous did not complete within the deadline.

    Attributes: ``op`` (collective name), ``group`` (group label),
    ``timeout`` (seconds), ``missing_ranks`` (list, possibly empty when
    unknown)."""

    def __init__(self, op, group=None, timeout=None, missing_ranks=()):
        self.op = op
        self.group = group
        self.timeout = timeout
        self.missing_ranks = list(missing_ranks)
        missing = (f"; ranks believed missing: {self.missing_ranks}"
                   if self.missing_ranks else
                   "; no rank reported missing — suspect a wedged device "
                   "or network partition")
        super().__init__(
            f"distributed: '{op}' over group "
            f"{group if group is not None else '<default>'} did not "
            f"complete within {timeout}s{missing}. The job is failing fast "
            "instead of hanging; inspect the slowest/missing rank's log, "
            "or raise the deadline via distributed.set_timeout() / "
            "PADDLE_TPU_DIST_TIMEOUT.")


def _env_timeout():
    raw = os.environ.get('PADDLE_TPU_DIST_TIMEOUT', '').strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


_timeout = [_env_timeout()]

# test/chaos hook (faultinject.slow_collective): called with the op name
# before the collective is issued; sleeping here models a slow peer
_delay_hook = [None]


def set_timeout(seconds):
    """Set the process-wide collective deadline (seconds). ``None`` or
    ``0`` disables. Returns the previous value."""
    prev = _timeout[0]
    if seconds is not None and seconds <= 0:
        seconds = None
    _timeout[0] = seconds
    return prev


def get_timeout():
    """The active collective deadline in seconds, or None when disabled."""
    return _timeout[0]


def _missing_ranks():
    """Ranks whose supervisor heartbeat has gone stale: best effort, []
    when no supervised launch is active."""
    hb_dir = os.environ.get('PADDLE_TPU_HEARTBEAT_DIR')
    if not hb_dir:
        return []
    from ..resilience.watchdog import heartbeat_age
    try:
        world = int(os.environ.get('PADDLE_TRAINERS_NUM', '0'))
    except ValueError:
        return []
    stale_after = max((get_timeout() or 10.0) / 2.0, 2.0)
    missing = []
    for rank in range(world):
        age = heartbeat_age(os.path.join(hb_dir, f'hb_{rank}'))
        if age is None or age > stale_after:
            missing.append(rank)
    return missing


def _expired(op, group, budget):
    if _obs.enabled():
        _obs.counter('distributed.timeouts').inc()
        _obs.event('dist_timeout', op=op,
                   group=str(group) if group is not None else None,
                   timeout_s=budget)
    return DistributedTimeoutError(op, group=group, timeout=budget,
                                   missing_ranks=_missing_ranks())


def run_with_deadline(op, launch, group=None, timeout=None):
    """Issue one collective under the deadline policy.

    ``launch(async_op)`` issues it and returns what ``torch.distributed``
    returns (a ``Work`` when ``async_op``). ``timeout=None`` uses the
    process-wide policy. Without a deadline the collective is issued
    synchronously in stream order and nothing here waits. With one, the
    chaos delay and the work's ``wait(remaining)`` share the budget;
    expiry raises ``DistributedTimeoutError``."""
    budget = get_timeout() if timeout is None else timeout
    hook = _delay_hook[0]
    t0 = time.monotonic()
    if hook is not None:
        hook(op)
    if not budget:
        launch(False)
        return
    remaining = budget - (time.monotonic() - t0)
    if remaining <= 0:
        raise _expired(op, group, budget)
    work = launch(True)
    if work is None:
        return
    try:
        done = work.wait(timeout=datetime.timedelta(seconds=remaining))
    except RuntimeError as e:
        # the process group reports its own timeout as a RuntimeError
        text = str(e).lower()
        if 'timeout' in text or 'timed out' in text:
            raise _expired(op, group, budget) from e
        raise
    if done is False:
        raise _expired(op, group, budget)
