"""Admission control + request lifecycle for the serving engine.
Counterpart of ``paddle_tpu/serving/scheduler.py``.

- **bounded admission queue**: ``capacity`` requests per model; a full
  queue rejects at submit time (``QueueFullError``, the HTTP-429 analogue)
  instead of growing a backlog whose tail can never meet its deadline.
- **per-request deadlines**: every request carries a budget measured from
  submit. A request that expires while still queued is completed with
  status ``'deadline'`` without running.
- **completion handoff**: the worker thread completes a request; the
  client blocks on ``PendingRequest.result()`` with a bounded, tick-based
  wait — a dead engine raises ``WatchdogTimeout`` instead of hanging the
  caller forever.

The reference's ``observability.timing.Stopwatch`` and
``resilience.watchdog.WatchdogTimeout`` are replaced by the small
``Stopwatch`` and ``WatchdogTimeout`` below. Cancellation and the
paged-KV admission hooks come with the generative path.
"""
import collections
import itertools
import threading
import time

__all__ = ['QueueFullError', 'WatchdogTimeout', 'Stopwatch', 'Request',
           'Response', 'PendingRequest', 'AdmissionQueue', 'STATUS_OK',
           'STATUS_DEADLINE', 'STATUS_ERROR']

STATUS_OK = 'ok'
STATUS_DEADLINE = 'deadline'
STATUS_ERROR = 'error'

_WAIT_TICK = 0.05
_ids = itertools.count(1)


class WatchdogTimeout(TimeoutError):
    """A bounded wait ran out (no response in time, or the engine stopped
    with the request in flight)."""


class Stopwatch:
    """Monotonic elapsed time since construction."""

    __slots__ = ('_t0',)

    def __init__(self):
        self._t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self._t0

    def elapsed_ms(self):
        return 1000.0 * self.elapsed()


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the request was shed (429-style).
    Raised at submit time; nothing was enqueued."""

    def __init__(self, model, capacity):
        super().__init__(
            f"serving: model {model!r} admission queue is full "
            f"(capacity {capacity}) — request shed; retry with backoff")
        self.model = model
        self.capacity = capacity


class Response:
    """What a completed request resolves to.

    ``status`` is ``'ok'``, ``'deadline'`` (expired; ``outputs`` None) or
    ``'error'`` (``error`` holds the exception). ``latency_ms`` is
    submit->complete, ``queue_ms`` the part spent waiting for a batch, and
    ``breakdown`` the per-phase wall time the runner attributes (``run``:
    the wall time of the batch the request rode in).
    """

    __slots__ = ('status', 'outputs', 'model', 'request_id', 'latency_ms',
                 'queue_ms', 'error', 'breakdown')

    def __init__(self, status, outputs, model, request_id, latency_ms,
                 queue_ms, error=None, breakdown=None):
        self.status = status
        self.outputs = outputs
        self.model = model
        self.request_id = request_id
        self.latency_ms = latency_ms
        self.queue_ms = queue_ms
        self.error = error
        self.breakdown = breakdown or {}

    @property
    def ok(self):
        return self.status == STATUS_OK

    def __repr__(self):
        return (f"Response(status={self.status!r}, model={self.model!r}, "
                f"id={self.request_id}, latency_ms={self.latency_ms:.1f})")


class Request:
    """One inference request moving through the engine. ``inputs`` is a
    dict name -> per-example numpy array (no batch axis)."""

    __slots__ = ('id', 'model', 'inputs', 'deadline_ms', 'sw', 'queue_ms',
                 'phase_ms', '_event', 'response')

    def __init__(self, model, inputs, deadline_ms=None):
        self.id = next(_ids)
        self.model = model
        self.inputs = inputs
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.sw = Stopwatch()          # lifetime clock, started at submit
        self.queue_ms = 0.0
        self.phase_ms = {}             # runner-attributed wall ms per phase
        self._event = threading.Event()
        self.response = None

    def add_phase_ms(self, phase, ms):
        self.phase_ms[phase] = self.phase_ms.get(phase, 0.0) + float(ms)

    def expired(self):
        return (self.deadline_ms is not None and
                self.sw.elapsed_ms() > self.deadline_ms)

    def complete(self, status, outputs=None, error=None):
        if self._event.is_set():
            return                     # first completion wins
        self.response = Response(status, outputs, self.model, self.id,
                                 self.sw.elapsed_ms(), self.queue_ms,
                                 error=error,
                                 breakdown={k: round(v, 3) for k, v
                                            in self.phase_ms.items()})
        self._event.set()

    def done(self):
        return self._event.is_set()


class PendingRequest:
    """Client-side handle: a future over one Request."""

    __slots__ = ('_req', '_alive')

    def __init__(self, req, alive):
        self._req = req
        self._alive = alive            # () -> bool: is the engine running?

    @property
    def request_id(self):
        return self._req.id

    def done(self):
        return self._req.done()

    def result(self, timeout=None):
        """Block (tick-based) for the Response. Raises ``WatchdogTimeout``
        when ``timeout`` seconds pass, or when the engine stops while the
        request is still in flight; re-raises the model's error for an
        ``'error'`` response."""
        sw = Stopwatch()
        while not self._req._event.wait(_WAIT_TICK):
            if timeout is not None and sw.elapsed() >= timeout:
                raise WatchdogTimeout(
                    f"serving: no response for request {self._req.id} "
                    f"within {timeout:.1f}s")
            if not self._alive():
                # one grace tick: stop() completes queued requests as
                # shaped errors just after the worker exits
                if self._req._event.wait(_WAIT_TICK):
                    break
                raise WatchdogTimeout(
                    f"serving: engine stopped with request {self._req.id} "
                    "still in flight")
        resp = self._req.response
        if resp.status == STATUS_ERROR and resp.error is not None:
            raise resp.error
        return resp


class AdmissionQueue:
    """Bounded FIFO per model, with deadline-aware pops."""

    def __init__(self, model, capacity=256):
        self.model = model
        self.capacity = int(capacity)
        self._dq = collections.deque()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._dq)

    def push(self, req):
        with self._lock:
            if len(self._dq) >= self.capacity:
                raise QueueFullError(self.model, self.capacity)
            self._dq.append(req)

    def pop_ready(self, max_n):
        """-> (ready, expired): up to ``max_n`` live requests in FIFO
        order, plus every expired request met on the way."""
        ready, expired = [], []
        with self._lock:
            while self._dq and len(ready) < max_n:
                req = self._dq.popleft()
                (expired if req.expired() else ready).append(req)
        for r in ready + expired:
            r.queue_ms = r.sw.elapsed_ms()
        return ready, expired

    def drain(self):
        """Remove and return every queued request (engine shutdown)."""
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
        return out
