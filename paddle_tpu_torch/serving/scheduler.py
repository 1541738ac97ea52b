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

The paged runner's admission hooks are here too: ``pop_ready_while``
(admission gated on free KV pages, strict FIFO), ``push_front``
(re-admission past the capacity check) and ``reap_expired``; and
``remove``, which ``ServingEngine.cancel`` withdraws a queued request
with (status ``'cancelled'``). Each request carries its ``tenant``
(``'default'`` unless the caller names one), which
``admission.WeightedFairQueue`` orders by.

The reference's ``resilience.watchdog.WatchdogTimeout`` is replaced by
the small ``WatchdogTimeout`` below.
"""
import collections
import itertools
import threading

from ..observability.timing import Stopwatch

__all__ = ['QueueFullError', 'WatchdogTimeout', 'Stopwatch', 'Request',
           'Response', 'PendingRequest', 'AdmissionQueue', 'STATUS_OK',
           'STATUS_DEADLINE', 'STATUS_ERROR', 'STATUS_CANCELLED']

STATUS_OK = 'ok'
STATUS_DEADLINE = 'deadline'
STATUS_ERROR = 'error'
STATUS_CANCELLED = 'cancelled'   # the caller withdrew it while queued

_WAIT_TICK = 0.05
_ids = itertools.count(1)


class WatchdogTimeout(TimeoutError):
    """A bounded wait ran out (no response in time, or the engine stopped
    with the request in flight)."""


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the request was shed (429-style).
    Raised at submit time; nothing was enqueued. ``reason`` tells the two
    ways a backlog builds apart: ``'queue_full'`` (offered load exceeds
    the drain rate) or ``'page_exhaustion'`` (the paged KV cache is out of
    pages, so admission stalled and the queue backed up behind it); the
    engine stamps it from the runner's ``page_starved()``."""

    def __init__(self, model, capacity, reason='queue_full'):
        super().__init__(
            f"serving: model {model!r} admission queue is full "
            f"(capacity {capacity}) — request shed ({reason}); retry "
            "with backoff")
        self.model = model
        self.capacity = capacity
        self.reason = reason


class Response:
    """What a completed request resolves to.

    ``status`` is ``'ok'``, ``'deadline'`` (expired; ``outputs`` holds
    any partial generative output, else None) or ``'error'`` (``error``
    holds the exception; a generative request stopped mid-decode keeps
    its partial tokens in ``outputs``). ``latency_ms`` is
    submit->complete, ``queue_ms`` the part spent waiting for a batch,
    and ``breakdown`` the per-phase wall time the runner attributes
    (``run`` for one-shot batches; ``prefill``/``decode``/``draft``/
    ``verify`` for generative models, each the wall time of the step the
    request rode in).
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
    dict name -> per-example numpy array (no batch axis), or
    ``{'tokens': int array [L]}`` (+ ``max_new_tokens``) for generative
    models; ``tenant`` names who sent it."""

    __slots__ = ('id', 'model', 'inputs', 'deadline_ms', 'max_new_tokens',
                 'tenant', 'sw', 'queue_ms', 'phase_ms', '_event', 'response')

    def __init__(self, model, inputs, deadline_ms=None, max_new_tokens=None,
                 tenant=None):
        self.id = next(_ids)
        self.model = model
        self.inputs = inputs
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant or 'default'   # admission.DEFAULT_TENANT
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

    def push_front(self, req):
        """Re-admit ``req`` at the head of the queue, bypassing the
        capacity check: the request was already admitted once (a paged
        runner stalling on KV pages) and must not be shed on its way
        back in."""
        with self._lock:
            self._dq.appendleft(req)

    def pop_ready(self, max_n):
        """-> (ready, expired): up to ``max_n`` live requests in FIFO
        order, plus every expired request met on the way."""
        return self.pop_ready_while(None, max_n)

    def pop_ready_while(self, admit, max_n):
        """Admission-gated pop: like ``pop_ready`` but stops at the first
        live request ``admit(req)`` declines (strict FIFO — no head-of-line
        jumping). The paged runner's predicate gates on free KV pages.
        ``admit=None`` admits everything."""
        ready, expired = [], []
        with self._lock:
            while self._dq and len(ready) < max_n:
                req = self._dq[0]
                if req.expired():
                    expired.append(self._dq.popleft())
                    continue
                if admit is not None and not admit(req):
                    break
                ready.append(self._dq.popleft())
        for r in ready + expired:
            r.queue_ms = r.sw.elapsed_ms()
        return ready, expired

    def remove(self, req):
        """Withdraw ``req`` if it is still queued. True when it was removed
        (no runner popped it), False when a runner already owns it: it
        then runs to completion."""
        with self._lock:
            try:
                self._dq.remove(req)
            except ValueError:
                return False
        return True

    def reap_expired(self):
        """Remove and return every expired request anywhere in the queue
        (used when no batch slot is free: a dead request must not wait for
        one just to be told it is dead)."""
        expired, live = [], []
        with self._lock:
            for r in self._dq:
                (expired if r.expired() else live).append(r)
            self._dq.clear()
            self._dq.extend(live)
        for r in expired:
            r.queue_ms = r.sw.elapsed_ms()
        return expired

    def drain(self):
        """Remove and return every queued request (engine shutdown)."""
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
        return out
