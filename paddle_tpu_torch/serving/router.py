"""FleetRouter: fault-tolerant dispatch across N ServingEngine replicas.
Counterpart of ``paddle_tpu/serving/router.py``.

One ``ServingEngine`` dies with every request it holds. The router is the
fleet tier above it, stdlib only, that keeps the service answering
through replica crashes, hangs, overload and rolling restarts:

- **health-gated dispatch**: a replica receives traffic only while its
  engine is dispatchable (worker alive, not killed), its admission queue
  is below the depth gate, its paged KV cache is not starved, and its
  **circuit breaker** allows it. The breaker is passive: ``trip_after``
  consecutive failures open it, a cooldown on the shared
  ``resilience.retry`` backoff curve must elapse before a **half-open**
  probe window re-admits it, and only ``half_open_probes`` consecutive
  probe successes close it again. A relaunched (cold) replica rejoins
  through the same half-open gate, so its warmup meets bounded traffic.
- **deadline-bounded budgets**: every fleet request carries one end-to-end
  deadline. Retries and hedges inherit the *remaining* budget, never a
  fresh one; when the budget is gone the router answers ``'deadline'``
  without dispatching.
- **failover retries**: a replica fault (death, hang timeout, engine stop)
  triggers a bounded re-dispatch on a *different* replica, but only for
  idempotent work: requests marked ``idempotent=False`` and generative
  failures that already carry partial output are never replayed.
- **tail-latency hedging**: ``hedge_after_ms`` fires one duplicate on a
  different replica when the primary straggles; the first response wins,
  the loser is cancelled (free while still queued) and counted.
- **graceful drain**: ``drain(name)`` stops new admits and waits (under a
  watchdog deadline) for the replica's queued and resident requests to
  finish, the rolling-restart primitive. ``readmit()`` returns it to
  rotation through the half-open gate.
- **shed ladder**: fleet-wide SLO burn (``observability.slo``) degrades
  service honestly: level 1 rejects tenants below the priority floor,
  level 2 also shrinks generative budgets, level 3 rejects everything
  (the 429 analogue), each shed shaped as ``FleetOverloadError``.
- **prefix affinity**: generative prompts route by rendezvous hash of
  their content-chain digest (``paged_kv.chain_hashes``), so identical
  prefixes land on the replica whose prefix cache already holds them.

Everything lands on the telemetry spine under the reference's names:
``serving.router.*`` counters (global and ``{replica=}``-labeled),
cumulative ``serving.router_stats`` events (``paddle_tpu_torch/tools/
telemetry_dump.py --serving`` renders the per-replica table),
circuit/failover/drain events for the doctor's ``replica_flapping`` and
``retry_storm`` detectors, flight-recorder entries for post-mortems, and a
``serving.fleet`` async trace lane per fleet request linking every attempt
to the replica that served (or failed) it.
"""
import hashlib
import itertools
import threading
import time

from .. import observability as _obs
from ..observability import slo as _slo
from ..observability.timing import Stopwatch
from ..resilience.retry import backoff_delay
from ..resilience.watchdog import WatchdogTimeout
from .admission import DEFAULT_TENANT, QuotaExceededError, record_shed
from .engine import EngineDeadError
from .paged_kv import chain_hashes
from .scheduler import (QueueFullError, Response, STATUS_CANCELLED,
                        STATUS_DEADLINE, STATUS_ERROR)

__all__ = ['FleetRouter', 'RouterPolicy', 'ReplicaHandle', 'CircuitBreaker',
           'FleetPending', 'ReplicaError', 'NoHealthyReplicaError',
           'FleetOverloadError', 'CIRCUIT_CLOSED', 'CIRCUIT_OPEN',
           'CIRCUIT_HALF_OPEN', 'SHED_NONE', 'SHED_PRIORITY', 'SHED_DEGRADE',
           'SHED_REJECT']

CIRCUIT_CLOSED = 'closed'
CIRCUIT_OPEN = 'open'
CIRCUIT_HALF_OPEN = 'half_open'

_POLL_TICK = 0.01              # router-side attempt poll (hedge resolution)
_fleet_ids = itertools.count(1)

# shed-ladder levels
SHED_NONE = 0                  # steady state
SHED_PRIORITY = 1              # reject tenants below the priority floor
SHED_DEGRADE = 2               # + shrink generative token budgets
SHED_REJECT = 3                # 429 everything
_SHED_NAMES = {SHED_NONE: 'none', SHED_PRIORITY: 'priority',
               SHED_DEGRADE: 'degrade', SHED_REJECT: 'reject'}


class ReplicaError(RuntimeError):
    """A fleet request failed because of replica faults — shaped with the
    replica id(s) that failed it so a post-mortem needs no log spelunking.
    ``replicas`` lists every replica tried, ``replica`` the last one."""

    def __init__(self, message, replica=None, replicas=(), request=None):
        super().__init__(message)
        self.replica = replica
        self.replicas = tuple(replicas) if replicas else (
            (replica,) if replica is not None else ())
        self.request = request


class NoHealthyReplicaError(ReplicaError):
    """Dispatch found no admittable replica (all dead, draining, tripped,
    or over the queue-depth gate)."""


class FleetOverloadError(RuntimeError):
    """The shed ladder rejected this request (429 analogue). ``level`` is
    the ladder rung (1 = priority shed, 3 = reject-all) and ``reason``
    the human-readable rung name."""

    def __init__(self, message, level, reason):
        super().__init__(message)
        self.level = level
        self.reason = reason


class RouterPolicy:
    """Knobs for the fleet layer; defaults favor fast CPU tests.

    ``max_retries`` bounds failover re-dispatches per request (on top of
    the first attempt). ``hedge_after_ms=None`` disables hedging.
    ``attempt_timeout_ms`` is the hang detector — an attempt older than
    this with no response is abandoned and failed over (``None``: rely on
    the request deadline / replica-death detection only).
    ``on_replica_death`` is ``'redispatch'`` (stranded idempotent work
    retries elsewhere) or ``'fail_fast'`` (shaped ``ReplicaError``
    immediately). The ``shed_burn_*`` thresholds map fleet SLO burn to
    ladder rungs; ``shed_priority_floor`` is the minimum priority admitted
    at level 1+. ``circuit_jitter=0`` keeps chaos tests deterministic;
    production fleets want the default retry jitter (0.5) so probes don't
    stampede."""

    def __init__(self, max_retries=2, hedge_after_ms=None,
                 attempt_timeout_ms=None, on_replica_death='redispatch',
                 trip_after=3, circuit_cooldown_s=0.25,
                 circuit_cooldown_factor=2.0, circuit_max_cooldown_s=30.0,
                 circuit_jitter=0.0, half_open_probes=2,
                 max_queue_depth=None, affinity_page_size=16,
                 shed_burn_soft=1.0, shed_burn_hard=2.0, shed_burn_stop=4.0,
                 shed_priority_floor=1, shed_max_new_tokens=8):
        if on_replica_death not in ('redispatch', 'fail_fast'):
            raise ValueError(
                "RouterPolicy: on_replica_death must be 'redispatch' or "
                f"'fail_fast', got {on_replica_death!r}")
        if max_retries < 0:
            raise ValueError("RouterPolicy: max_retries must be >= 0")
        self.max_retries = int(max_retries)
        self.hedge_after_ms = hedge_after_ms
        self.attempt_timeout_ms = attempt_timeout_ms
        self.on_replica_death = on_replica_death
        self.trip_after = int(trip_after)
        self.circuit_cooldown_s = float(circuit_cooldown_s)
        self.circuit_cooldown_factor = float(circuit_cooldown_factor)
        self.circuit_max_cooldown_s = float(circuit_max_cooldown_s)
        self.circuit_jitter = float(circuit_jitter)
        self.half_open_probes = int(half_open_probes)
        self.max_queue_depth = max_queue_depth
        self.affinity_page_size = int(affinity_page_size)
        self.shed_burn_soft = float(shed_burn_soft)
        self.shed_burn_hard = float(shed_burn_hard)
        self.shed_burn_stop = float(shed_burn_stop)
        self.shed_priority_floor = int(shed_priority_floor)
        self.shed_max_new_tokens = int(shed_max_new_tokens)


class CircuitBreaker:
    """Passive per-replica breaker: closed → (``trip_after`` consecutive
    failures) → open → (cooldown from the shared ``resilience.retry``
    backoff curve, doubling per trip) → half-open probe window →
    (``half_open_probes`` consecutive successes) → closed; any half-open
    failure re-opens with a longer cooldown. Every transition is an
    ``serving.router.circuit`` event — the doctor's ``replica_flapping``
    detector counts them."""

    def __init__(self, replica, trip_after=3, cooldown_s=0.25, factor=2.0,
                 max_cooldown_s=30.0, jitter=0.0, half_open_probes=2):
        self.replica = replica
        self.trip_after = int(trip_after)
        self.cooldown_s = float(cooldown_s)
        self.factor = float(factor)
        self.max_cooldown_s = float(max_cooldown_s)
        self.jitter = float(jitter)
        self.half_open_probes = int(half_open_probes)
        self.state = CIRCUIT_CLOSED
        self.trips = 0                 # lifetime opens
        self.closes = 0                # lifetime recoveries
        self._consecutive = 0
        self._opened = None            # Stopwatch started at last open
        self._probes_left = 0
        self._probe_successes = 0
        self._lock = threading.Lock()

    def _transition(self, state, **why):
        self.state = state
        if _obs.enabled():
            _obs.event('serving.router.circuit', replica=self.replica,
                       state=state, trips=self.trips, **why)
            _obs.counter('serving.router.circuit_transitions').inc()
        _obs.flight.record('router.circuit', replica=self.replica,
                           state=state)

    def cooldown(self):
        """Seconds the circuit stays open before the next half-open probe
        window — the shared retry backoff curve keyed by trip count, so a
        replica that keeps failing is probed exponentially less often."""
        return backoff_delay(self.trips, backoff=self.cooldown_s,
                             factor=self.factor,
                             max_backoff=self.max_cooldown_s,
                             jitter=self.jitter)

    def allow(self):
        """May the router dispatch to this replica right now? Transitions
        open → half-open as a side effect once the cooldown elapses."""
        with self._lock:
            if self.state == CIRCUIT_CLOSED:
                return True
            if self.state == CIRCUIT_OPEN:
                if self._opened is not None and \
                        self._opened.elapsed() >= self.cooldown():
                    self._probes_left = self.half_open_probes
                    self._probe_successes = 0
                    self._transition(CIRCUIT_HALF_OPEN, reason='cooldown')
                    return True
                return False
            return self._probes_left > 0   # half-open: bounded probes

    def on_dispatch(self):
        with self._lock:
            if self.state == CIRCUIT_HALF_OPEN and self._probes_left > 0:
                self._probes_left -= 1

    def record_success(self):
        with self._lock:
            self._consecutive = 0
            if self.state == CIRCUIT_HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self.closes += 1
                    self._transition(CIRCUIT_CLOSED, reason='probes_ok')

    def record_failure(self, reason=''):
        with self._lock:
            self._consecutive += 1
            if self.state == CIRCUIT_HALF_OPEN or (
                    self.state == CIRCUIT_CLOSED and
                    self._consecutive >= self.trip_after):
                self._open(reason)

    def trip(self, reason):
        """Open immediately (replica death — no need to wait for
        ``trip_after`` echoes of the same corpse). Idempotent."""
        with self._lock:
            if self.state != CIRCUIT_OPEN:
                self._open(reason)

    def force_half_open(self, reason='rejoin'):
        """Cold-rejoin gate: a relaunched/readmitted replica re-enters
        rotation probe-by-probe so its warmup meets bounded
        traffic, not the full request stream."""
        with self._lock:
            self._probes_left = self.half_open_probes
            self._probe_successes = 0
            self._opened = Stopwatch()
            self._transition(CIRCUIT_HALF_OPEN, reason=reason)

    def _open(self, reason):
        # callers hold self._lock
        self.trips += 1
        self._opened = Stopwatch()
        self._consecutive = 0
        self._transition(CIRCUIT_OPEN, reason=reason)


class ReplicaHandle:
    """Router-side view of one replica: the engine, its breaker, its
    drain state, and its dispatch ledger (the telemetry-dump columns)."""

    def __init__(self, name, engine, policy):
        self.name = name
        self.engine = engine
        self.policy = policy
        self.breaker = CircuitBreaker(
            name, trip_after=policy.trip_after,
            cooldown_s=policy.circuit_cooldown_s,
            factor=policy.circuit_cooldown_factor,
            max_cooldown_s=policy.circuit_max_cooldown_s,
            jitter=policy.circuit_jitter,
            half_open_probes=policy.half_open_probes)
        self.draining = False
        self.drained = False
        # the ledger lock serializes counter bumps: result() drives the
        # retry/hedge machine on arbitrary client threads, so different
        # requests' callers race on this one handle's counters
        self._ledger = threading.Lock()
        self.dispatched = 0
        self.completed = 0
        self.failed = 0
        self.retried = 0               # failover re-dispatches landing here
        self.hedged = 0                # hedge duplicates landing here
        self.hedge_wins = 0
        self.drained_requests = 0
        self.queue_full = 0
        self.deaths = 0
        self.restarts = 0              # supervisor relaunches

    def admittable(self, model):
        """Health gate: is this replica a valid dispatch target for
        ``model`` right now?"""
        if self.draining or not self.engine.dispatchable():
            return False
        if not self.engine.has_model(model):
            return False
        if self.engine.page_starved(model):
            return False
        lim = self.policy.max_queue_depth
        if lim is not None and self.engine.queued_count(model) >= int(lim):
            return False
        return self.breaker.allow()

    def bump(self, counter, n=1):
        """Atomically increment one dispatch-ledger counter."""
        with self._ledger:
            setattr(self, counter, getattr(self, counter) + n)

    def stats_row(self):
        with self._ledger:
            return {'dispatched': self.dispatched,
                    'completed': self.completed,
                    'failed': self.failed, 'retried': self.retried,
                    'hedged': self.hedged, 'hedge_wins': self.hedge_wins,
                    'drained': self.drained_requests,
                    'queue_full': self.queue_full, 'deaths': self.deaths,
                    'restarts': self.restarts,
                    'circuit': self.breaker.state,
                    'trips': self.breaker.trips, 'draining': self.draining}


class _FleetRequest:
    """Router-side record of one client request across all its attempts."""

    __slots__ = ('id', 'model', 'inputs', 'deadline_ms', 'max_new_tokens',
                 'priority', 'idempotent', 'generative', 'affinity', 'sw',
                 'attempts', 'tried', 'retries_used', 'hedged', 'fail_fast',
                 'lock', 'settled', 'tenant')

    def __init__(self, model, inputs, deadline_ms, max_new_tokens, priority,
                 idempotent, generative, affinity, tenant=None):
        self.id = next(_fleet_ids)
        self.model = model
        self.inputs = inputs
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.priority = int(priority)
        self.idempotent = idempotent
        self.generative = generative
        self.affinity = affinity
        self.sw = Stopwatch()
        self.attempts = []             # live _Attempts
        self.tried = []                # replica names, dispatch order
        self.retries_used = 0
        self.hedged = False
        self.fail_fast = False         # set by the fail_fast death policy
        self.lock = threading.Lock()   # one result() caller at a time
        self.settled = None            # ('response', resp) | ('raise', exc)

    def remaining_ms(self):
        if self.deadline_ms is None:
            return None
        return self.deadline_ms - self.sw.elapsed_ms()


class _Attempt:
    __slots__ = ('handle', 'pending', 'kind', 'sw')

    def __init__(self, handle, pending, kind):
        self.handle = handle
        self.pending = pending
        self.kind = kind               # 'first' | 'retry' | 'hedge'
        self.sw = Stopwatch()


class FleetPending:
    """Client handle for one routed request. ``result()`` drives the
    retry/hedge state machine on the calling thread — the router spawns
    no threads of its own; concurrency is the clients'."""

    __slots__ = ('_router', '_fr')

    def __init__(self, router, fr):
        self._router = router
        self._fr = fr

    @property
    def fleet_id(self):
        return self._fr.id

    @property
    def replicas_tried(self):
        return tuple(self._fr.tried)

    def done(self):
        return any(a.pending.done() for a in self._fr.attempts)

    def result(self, timeout=None):
        return self._router._await(self._fr, timeout=timeout)


class FleetRouter:
    """The fleet's front door. See the module docstring for the
    behavior contract; ``add_replica()`` engines may be background-started
    (``start()``) or manually pumped (the router never pumps for dispatch,
    but ``drain()`` will pump a manual-drive replica to completion)."""

    def __init__(self, policy=None, tenants=None):
        self.policy = policy or RouterPolicy()
        self.tenants = tenants         # admission.TenantArbiter or None
        self._handles = {}
        self._lock = threading.Lock()
        self._rr = itertools.count()   # tie-break rotation for _pick

    # -- fleet membership ----------------------------------------------
    def add_replica(self, name, engine):
        with self._lock:
            if name in self._handles:
                raise ValueError(f"router: replica {name!r} already in "
                                 "the fleet")
            self._handles[name] = ReplicaHandle(name, engine, self.policy)
        if _obs.enabled():
            _obs.event('serving.router.replica_added', replica=name)
            _obs.gauge('serving.router.replicas').set(len(self._handles))
        return self._handles[name]

    def remove_replica(self, name):
        with self._lock:
            h = self._handles.pop(name, None)
        if h is None:
            raise KeyError(f"router: no replica {name!r}")
        if _obs.enabled():
            _obs.gauge('serving.router.replicas').set(len(self._handles))
        return h.engine

    def replica(self, name):
        h = self._handles.get(name)
        if h is None:
            raise KeyError(f"router: no replica {name!r} "
                           f"(have {sorted(self._handles)})")
        return h

    def replicas(self):
        with self._lock:
            return list(self._handles.values())

    # -- shed ladder ----------------------------------------------------
    def shed_level(self):
        """Current ladder rung from peak per-model SLO burn
        (``observability.slo``): 0 none, 1 reject sub-floor priorities, 2
        also shrink generative budgets, 3 reject everything."""
        burns = _slo.burn_rates()
        peak = max(burns.values()) if burns else 0.0
        p = self.policy
        if peak >= p.shed_burn_stop:
            return SHED_REJECT
        if peak >= p.shed_burn_hard:
            return SHED_DEGRADE
        if peak >= p.shed_burn_soft:
            return SHED_PRIORITY
        return SHED_NONE

    def _shed_gate(self, model, priority, tenant=None):
        level = self.shed_level()
        # ladder level 1 is tenant-aware when an arbiter is attached:
        # "reject below THIS tenant's priority_floor" — a premium tenant
        # (floor 0) keeps flowing at level 1 while a batch tenant (high
        # floor) sheds first; without tenancy the global policy floor
        # applies as before
        floor = (self.tenants.priority_floor(tenant)
                 if self.tenants is not None
                 else self.policy.shed_priority_floor)
        if level >= SHED_REJECT or (
                level >= SHED_PRIORITY and priority < floor):
            reason = _SHED_NAMES[level]
            if _obs.enabled():
                _obs.counter('serving.router.shed').inc()
                _obs.event('serving.router.shed', model=model,
                           level=level, reason=reason, priority=priority,
                           tenant=tenant)
            raise FleetOverloadError(
                f"router: fleet shedding at level {level} ({reason}) — "
                f"request for {model!r} (priority {priority}, floor "
                f"{floor}) rejected; retry with backoff",
                level=level, reason=reason)
        return level

    # -- placement ------------------------------------------------------
    def _affinity_key(self, model, inputs, generative):
        if not generative or not isinstance(inputs, dict):
            return None
        toks = inputs.get('tokens')
        if toks is None:
            return None
        toks = [int(t) for t in toks]
        chain = chain_hashes(toks, self.policy.affinity_page_size)
        if chain:
            return chain[-1]
        # prompt shorter than one page: hash it whole — still deterministic
        return hashlib.sha256(repr(toks).encode()).hexdigest()

    @staticmethod
    def _rendezvous(key, handles):
        """Highest-random-weight placement: stable while the healthy set
        is stable, minimal movement when it changes — the property that
        makes per-replica prefix caches act fleet-wide."""
        return max(handles, key=lambda h: hashlib.sha256(
            (str(key) + '|' + h.name).encode()).digest())

    def _pick(self, model, affinity, exclude=()):
        with self._lock:
            handles = [h for h in self._handles.values()
                       if h.name not in exclude]
        cands = [h for h in handles if h.admittable(model)]
        if not cands:
            return None
        if affinity is not None:
            return self._rendezvous(affinity, cands)
        # least-loaded placement for affinity-free work; rotate the
        # tie-break so an idle fleet spreads instead of piling on one name
        off = next(self._rr) % len(cands)
        cands = cands[off:] + cands[:off]
        return min(cands, key=lambda h: h.engine.queued_count(model))

    # -- dispatch -------------------------------------------------------
    def _dispatch(self, fr, kind, required=True):
        """Place one attempt of ``fr`` on a not-yet-tried admittable
        replica. Submit-time rejections (queue full, raced death) fall
        through to the next candidate. Returns the live ``_Attempt``, or
        None / raises ``NoHealthyReplicaError`` when the fleet has no
        target (``required`` controls which — a hedge that finds no spare
        replica is simply not fired)."""
        exclude = set(fr.tried)
        while True:
            h = self._pick(fr.model, fr.affinity, exclude=exclude)
            if h is None:
                if not required:
                    return None
                raise NoHealthyReplicaError(
                    f"router: no healthy replica for {fr.model!r} "
                    f"(fleet request {fr.id}, tried "
                    f"{fr.tried or 'none'})", replicas=fr.tried,
                    request=fr.id)
            try:
                pending = h.engine.submit(
                    fr.model, fr.inputs, deadline_ms=fr.remaining_ms(),
                    max_new_tokens=fr.max_new_tokens, tenant=fr.tenant)
            except QuotaExceededError:
                # tenant-global, not replica-local: every replica would
                # answer the same, so burning failover candidates on it
                # only hides the real shed reason — surface it
                raise
            except QueueFullError as e:
                # backed-up replica: a health signal, not a breaker trip —
                # the queue-depth gate handles persistent backlog
                h.bump('queue_full')
                exclude.add(h.name)
                if _obs.enabled():
                    _obs.event('serving.router.queue_full', fleet=fr.id,
                               replica=h.name, reason=e.reason)
                continue
            except EngineDeadError:
                self._replica_died(h, fleet=fr.id)
                exclude.add(h.name)
                continue
            h.breaker.on_dispatch()
            h.bump('dispatched')
            if kind == 'retry':
                h.bump('retried')
                fr.retries_used += 1
            elif kind == 'hedge':
                h.bump('hedged')
            fr.tried.append(h.name)
            attempt = _Attempt(h, pending, kind)
            fr.attempts.append(attempt)
            if _obs.enabled():
                # one label set per family (the registry enforces it):
                # per-replica counters only — fleet totals are the sum
                # over labels (doctor._labeled / telemetry_dump do this)
                lbl = {'replica': h.name}
                _obs.counter('serving.router.dispatched',
                             labels=lbl).inc()
                if kind == 'retry':
                    _obs.counter('serving.router.retries', labels=lbl).inc()
                elif kind == 'hedge':
                    _obs.counter('serving.router.hedges', labels=lbl).inc()
                _obs.async_instant(
                    f'dispatch:{kind}', fr.id, cat='serving.fleet',
                    replica=h.name, engine_request=pending.request_id)
            return attempt

    def submit(self, model, inputs, deadline_ms=None, max_new_tokens=None,
               priority=1, idempotent=None, tenant=None):
        """Route one request into the fleet -> ``FleetPending``.

        ``priority`` feeds the shed ladder (higher survives longer;
        the default 1 sits exactly at the default floor). ``idempotent``
        is the retry/hedge contract: ``None`` (default) lets the router
        infer — one-shot requests are idempotent, generative requests are
        retried only while no partial output exists; ``False`` pins the
        request to its first replica (a continuation whose replay would
        double-generate). ``tenant`` names the submitting tenant: with a
        ``tenants=`` arbiter attached, the token-bucket quota is charged
        here (over-quota raises ``QuotaExceededError``, reason
        ``'quota'``) and ladder level 1 rejects below the *tenant's*
        ``priority_floor``. Raises ``FleetOverloadError`` when the shed
        ladder rejects, ``NoHealthyReplicaError`` when no replica can
        take it, ``KeyError`` when no replica serves ``model``."""
        with self._lock:
            handles = list(self._handles.values())
        if not any(h.engine.has_model(model) for h in handles):
            raise KeyError(f"router: no replica serves model {model!r}")
        if self.tenants is not None:
            # fleet front door owns the quota charge — replica engines in
            # this fleet must NOT share the same arbiter, or each request
            # is double-charged
            try:
                self.tenants.check(tenant, model)
            except QuotaExceededError as e:
                record_shed(tenant, e.reason)
                if _obs.enabled():
                    _obs.counter('serving.shed').inc()
                    _obs.counter('serving.shed.quota').inc()
                    _obs.event('serving.shed', model=model, reason=e.reason,
                               tenant=tenant or DEFAULT_TENANT)
                raise
        level = self._shed_gate(model, priority, tenant=tenant)
        generative = any(h.engine.has_model(model) and
                         h.engine.model_kind(model) == 'generative'
                         for h in handles)
        if level >= SHED_DEGRADE and generative:
            cap = self.policy.shed_max_new_tokens
            max_new_tokens = cap if max_new_tokens is None \
                else min(int(max_new_tokens), cap)
            if _obs.enabled():
                _obs.event('serving.router.degrade', model=model,
                           max_new_tokens=max_new_tokens)
        fr = _FleetRequest(model, inputs, deadline_ms, max_new_tokens,
                           priority, idempotent, generative,
                           self._affinity_key(model, inputs, generative),
                           tenant=tenant)
        if _obs.enabled():
            _obs.async_begin('fleet', fr.id, cat='serving.fleet',
                             model=model, priority=priority, tenant=tenant)
        try:
            self._dispatch(fr, kind='first')
        except NoHealthyReplicaError:
            if _obs.enabled():
                _obs.counter('serving.router.rejected').inc()
                _obs.async_end('fleet', fr.id, cat='serving.fleet',
                               status='no_replica')
            raise
        except QuotaExceededError:
            if _obs.enabled():
                _obs.async_end('fleet', fr.id, cat='serving.fleet',
                               status='shed', reason='quota')
            raise
        return FleetPending(self, fr)

    def predict(self, model, inputs, deadline_ms=None, max_new_tokens=None,
                priority=1, idempotent=None, timeout=None, tenant=None):
        """Blocking one-call convenience: submit + result."""
        return self.submit(model, inputs, deadline_ms=deadline_ms,
                           max_new_tokens=max_new_tokens, priority=priority,
                           idempotent=idempotent,
                           tenant=tenant).result(timeout=timeout)

    # -- the retry/hedge state machine ----------------------------------
    @staticmethod
    def _replica_fault(err):
        """Did this error come from the replica, not the request? Only
        replica faults are failover-retryable; a model error would fail
        identically everywhere."""
        if isinstance(err, (EngineDeadError, WatchdogTimeout)):
            return True
        return isinstance(err, RuntimeError) and \
            'engine stopped' in str(err)

    def _retryable(self, fr):
        if fr.idempotent is False or fr.fail_fast:
            return False
        return fr.retries_used < self.policy.max_retries

    def _replica_died(self, h, fleet=None):
        """Record an observed replica death (once per corpse: the breaker
        trip is idempotent, the death counter only moves on the opening
        transition)."""
        first = h.breaker.state != CIRCUIT_OPEN
        h.breaker.trip('replica_death')
        if first:
            h.bump('deaths')
            if _obs.enabled():
                _obs.counter('serving.router.replica_death').inc()
                _obs.event('serving.router.replica_death', replica=h.name,
                           fleet=fleet)
            _obs.flight.record('router.replica_death', replica=h.name)

    def _attempt_failed(self, fr, attempt, why, err=None):
        if attempt in fr.attempts:
            fr.attempts.remove(attempt)
        h = attempt.handle
        h.bump('failed')
        if why == 'replica_death':
            self._replica_died(h, fleet=fr.id)
        else:
            h.breaker.record_failure(why)
        if why == 'timeout':
            # reap the abandoned duplicate if it never left the queue
            h.engine.cancel(attempt.pending)
        if why == 'replica_death' and \
                self.policy.on_replica_death == 'fail_fast':
            fr.fail_fast = True
        if _obs.enabled():
            _obs.counter('serving.router.failures',
                         labels={'replica': h.name}).inc()
            _obs.event('serving.router.failover', fleet=fr.id,
                       replica=h.name, why=why,
                       error=None if err is None else repr(err))
            _obs.async_instant(f'failover:{why}', fr.id,
                               cat='serving.fleet', replica=h.name)
        _obs.flight.record('router.failover', fleet=fr.id, replica=h.name,
                           why=why)

    def _settle(self, fr, winner, resp):
        """First response wins: cancel/abandon the losers, credit the
        winner, close the fleet trace lane, and shape the answer exactly
        as ``PendingRequest.result`` would."""
        h = winner.handle
        for loser in list(fr.attempts):
            if loser is winner:
                continue
            fr.attempts.remove(loser)
            cancelled = loser.handle.engine.cancel(loser.pending)
            if _obs.enabled():
                _obs.counter('serving.router.hedge_cancelled' if cancelled
                             else 'serving.router.hedge_wasted').inc()
        fr.attempts.clear()
        h.bump('completed')
        h.breaker.record_success()
        if winner.kind == 'hedge':
            h.bump('hedge_wins')
            if _obs.enabled():
                _obs.counter('serving.router.hedge_wins',
                             labels={'replica': h.name}).inc()
        if _obs.enabled():
            _obs.event('serving.router.request', fleet=fr.id,
                       model=fr.model, replica=h.name, status=resp.status,
                       attempt=winner.kind, retries=fr.retries_used,
                       hedged=fr.hedged,
                       latency_ms=round(fr.sw.elapsed_ms(), 3))
            _obs.async_end('fleet', fr.id, cat='serving.fleet',
                           status=resp.status, replica=h.name)
        self.emit_stats()
        if resp.status == STATUS_ERROR and resp.error is not None:
            fr.settled = ('raise', resp.error)
            raise resp.error
        fr.settled = ('response', resp)
        return resp

    def _fail(self, fr, why):
        last = fr.tried[-1] if fr.tried else None
        if _obs.enabled():
            _obs.counter('serving.router.failed').inc()
            _obs.event('serving.router.request', fleet=fr.id,
                       model=fr.model, replica=last, status='failed',
                       why=why, retries=fr.retries_used, hedged=fr.hedged,
                       latency_ms=round(fr.sw.elapsed_ms(), 3))
            _obs.async_end('fleet', fr.id, cat='serving.fleet',
                           status='failed', why=why)
        self.emit_stats()
        exc = ReplicaError(
            f"router: fleet request {fr.id} for {fr.model!r} failed "
            f"({why}) after {len(fr.tried)} attempt(s) on "
            f"{fr.tried}; last replica: {last}",
            replica=last, replicas=fr.tried, request=fr.id)
        fr.settled = ('raise', exc)
        raise exc

    def _deadline_response(self, fr):
        resp = Response(STATUS_DEADLINE, None, fr.model, fr.id,
                        fr.sw.elapsed_ms(), 0.0)
        if _obs.enabled():
            _obs.event('serving.router.request', fleet=fr.id,
                       model=fr.model, replica=None, status='deadline',
                       retries=fr.retries_used, hedged=fr.hedged,
                       latency_ms=round(fr.sw.elapsed_ms(), 3))
            _obs.async_end('fleet', fr.id, cat='serving.fleet',
                           status='deadline')
        fr.settled = ('response', resp)
        return resp

    def _await(self, fr, timeout=None):
        """Drive ``fr`` to an answer on the calling thread: poll live
        attempts, detect replica death/hangs, fail over within budget,
        fire the hedge, and settle on the first response."""
        p = self.policy
        with fr.lock:                  # one caller drives a request
            if fr.settled is not None:   # replay a settled outcome
                kind, val = fr.settled
                if kind == 'raise':
                    raise val
                return val
            if not fr.attempts and not fr.tried:
                raise ReplicaError("router: request was never dispatched",
                                   request=fr.id)
            sw = Stopwatch()
            while True:
                # 1) settled attempt? (first response wins)
                for a in list(fr.attempts):
                    if not a.pending.done():
                        continue
                    resp = a.pending._req.response
                    if resp.status == STATUS_CANCELLED:
                        fr.attempts.remove(a)
                    elif resp.status == STATUS_ERROR and \
                            self._replica_fault(resp.error) and \
                            not (fr.generative and resp.outputs):
                        # a replica fault with NO partial output: eligible
                        # for failover. Partial generative output pins the
                        # answer — replaying would double-generate.
                        self._attempt_failed(fr, a, 'error', resp.error)
                    else:
                        return self._settle(fr, a, resp)
                # 2) stranded on a dead replica?
                for a in list(fr.attempts):
                    if not a.handle.engine.dispatchable():
                        self._attempt_failed(fr, a, 'replica_death')
                # 3) hang detector
                if p.attempt_timeout_ms is not None:
                    for a in list(fr.attempts):
                        if a.sw.elapsed_ms() > p.attempt_timeout_ms:
                            self._attempt_failed(fr, a, 'timeout')
                # 4) out of budget?
                rem = fr.remaining_ms()
                if rem is not None and rem <= 0:
                    for a in list(fr.attempts):
                        fr.attempts.remove(a)
                        a.handle.engine.cancel(a.pending)
                    return self._deadline_response(fr)
                # 5) nothing in flight: fail over or give up
                if not fr.attempts:
                    if not self._retryable(fr):
                        why = ('replica_death' if fr.fail_fast else
                               'non_idempotent' if fr.idempotent is False
                               else 'attempts_exhausted')
                        self._fail(fr, why)
                    try:
                        self._dispatch(fr, kind='retry')
                    except NoHealthyReplicaError:
                        self._fail(fr, 'no_healthy_replica')
                # 6) tail hedge
                if (p.hedge_after_ms is not None and not fr.hedged and
                        len(fr.attempts) == 1 and fr.idempotent is not False
                        and sw.elapsed_ms() >= p.hedge_after_ms):
                    if self._dispatch(fr, kind='hedge',
                                      required=False) is not None:
                        fr.hedged = True
                    else:
                        fr.hedged = True   # no spare replica: don't re-try
                # 7) bounded wait
                if timeout is not None and sw.elapsed() >= timeout:
                    raise WatchdogTimeout(
                        f"router: no response for fleet request {fr.id} "
                        f"within {timeout:.1f}s (attempts on {fr.tried})",
                        what='fleet response', waited=sw.elapsed())
                time.sleep(_POLL_TICK)

    # -- drain / rejoin -------------------------------------------------
    def drain(self, name, timeout=30.0):
        """Gracefully take ``name`` out of rotation: stop new admits, let
        its queued + resident requests finish under a watchdog deadline,
        then hand the (still-running) engine back for stop/upgrade. A
        manual-drive engine is pumped here; a started one drains on its
        own worker. Raises ``WatchdogTimeout`` when residents outlive
        ``timeout`` and ``ReplicaError`` if the replica dies mid-drain —
        in both cases it stays out of rotation. Zero resident requests
        are aborted on the happy path: that is the whole point."""
        h = self.replica(name)
        h.draining = True
        pending = h.engine.queued_count() + h.engine.resident_count()
        if _obs.enabled():
            _obs.event('serving.router.drain', replica=name,
                       state='draining', pending=pending)
        _obs.flight.record('router.drain', replica=name, state='draining',
                           pending=pending)
        sw = Stopwatch()
        while h.engine.queued_count() or h.engine.resident_count():
            if not h.engine.dispatchable():
                if _obs.enabled():
                    _obs.event('serving.router.drain', replica=name,
                               state='died', pending=pending)
                raise ReplicaError(
                    f"router: replica {name!r} died mid-drain",
                    replica=name)
            if sw.elapsed() >= timeout:
                raise WatchdogTimeout(
                    f"router: drain of replica {name!r} still has "
                    f"{h.engine.queued_count()} queued + "
                    f"{h.engine.resident_count()} resident after "
                    f"{timeout:.1f}s", what='replica drain',
                    waited=sw.elapsed())
            if not h.engine.alive():
                h.engine.pump()        # manual-drive replica: drive it
            else:
                time.sleep(_POLL_TICK)
        h.drained = True
        h.bump('drained_requests', pending)
        if _obs.enabled():
            _obs.counter('serving.router.drained',
                         labels={'replica': name}).inc()
            _obs.event('serving.router.drain', replica=name,
                       state='drained', drained=pending, aborted=0,
                       ms=round(sw.elapsed_ms(), 3))
        _obs.flight.record('router.drain', replica=name, state='drained',
                           drained=pending)
        self.emit_stats()
        return h.engine

    def readmit(self, name, engine=None, warm=False):
        """Return a drained/relaunched replica to rotation. ``engine=``
        swaps in a fresh engine (supervisor relaunch); unless ``warm``,
        it re-enters through the half-open probe gate so a cold replica
        meets bounded traffic."""
        h = self.replica(name)
        if engine is not None:
            h.engine = engine
            h.bump('restarts')
        h.draining = False
        h.drained = False
        if warm:
            h.breaker = CircuitBreaker(
                name, trip_after=self.policy.trip_after,
                cooldown_s=self.policy.circuit_cooldown_s,
                factor=self.policy.circuit_cooldown_factor,
                max_cooldown_s=self.policy.circuit_max_cooldown_s,
                jitter=self.policy.circuit_jitter,
                half_open_probes=self.policy.half_open_probes)
        else:
            h.breaker.force_half_open(reason='rejoin')
        if _obs.enabled():
            _obs.event('serving.router.rejoin', replica=name,
                       warm=bool(warm), relaunched=engine is not None)
        _obs.flight.record('router.rejoin', replica=name, warm=bool(warm))
        self.emit_stats()
        return h

    # -- introspection --------------------------------------------------
    def stats(self):
        with self._lock:
            handles = list(self._handles.values())
        return {'replicas': {h.name: h.stats_row() for h in handles},
                'shed_level': self.shed_level()}

    def health(self):
        """The fleet slice of ``/healthz``: per-replica gate inputs and
        verdicts."""
        with self._lock:
            handles = list(self._handles.values())
        out = {}
        for h in handles:
            out[h.name] = {
                'dispatchable': h.engine.dispatchable(),
                'draining': h.draining,
                'circuit': h.breaker.state,
                'queued': h.engine.queued_count(),
                'resident': h.engine.resident_count(),
            }
        return {'fleet': {'replicas': out, 'shed_level': self.shed_level()}}

    def emit_stats(self):
        """Cumulative ``serving.router_stats`` event (last one wins) —
        the feed for ``tools/telemetry_dump.py --serving``'s per-replica
        table."""
        if not _obs.enabled():
            return
        with self._lock:
            handles = list(self._handles.values())
        _obs.event('serving.router_stats',
                   replicas={h.name: h.stats_row() for h in handles},
                   shed_level=self.shed_level())
