"""Tenancy for the serving tier: policies, quotas, weighted-fair pops.
The port's own copy of ``paddle_tpu/serving/admission.py``.

One serving tier, many tenants (docs/SERVING.md, "Tenancy +
autoscaling"). Without this layer any single tenant can flood the shared
``AdmissionQueue`` and starve every neighbor behind the same engine or
router. Three pieces close that hole:

- **``TenantPolicy``** — the per-tenant contract: a scheduling ``weight``
  (its share of pop bandwidth), an optional token-bucket ``rate``/``burst``
  quota (requests/s it may *submit*; beyond it submits shed immediately),
  a ``priority_floor`` the router's shed ladder enforces at level 1, and
  optional cost budgets (``cost_budget_flops`` / ``hbm_budget_bytes``)
  spent through ``TenantArbiter.charge``.
- **``TenantArbiter``** — the policy registry + quota gate in front of
  admission. ``check(tenant, model)`` either charges one token or raises
  ``QuotaExceededError`` (a shaped ``QueueFullError`` with reason
  ``'quota'`` — the third shed reason beside ``queue_full`` /
  ``page_exhaustion``), so a storming tenant is shed at the front door
  while nothing of its flood ever reaches the queue.
- **``WeightedFairQueue``** — a drop-in ``AdmissionQueue`` holding one
  FIFO per tenant and popping in **deficit-round-robin** order: each
  visit grants a tenant ``quantum * weight`` deficit, each popped request
  costs 1, an emptied tenant forfeits its residue. A tenant with weight 2
  drains twice as fast as a tenant with weight 1, deterministically, and
  a storming tenant consumes only its share of batch slots. Strict FIFO
  *within* a tenant, and an ``admit``-declined head (the paged runner's
  KV-page gate) stops the whole pop — no head-of-line jumping.

Per-tenant accounting is module-level and always-on (the ``_Stats``
discipline, like ``observability.slo``): plain dict math, mirrored to
``serving.tenant.*`` labeled counters and a cumulative
``serving.tenant_stats`` event while telemetry is enabled. Burn is
tracked per (tenant, model) against the model's SLO objective, so one
tenant's violations never move a neighbor's error-budget burn.
"""
import collections
import threading

from ..observability import events, registry, state
from ..observability import slo as _slo
from ..observability.timing import Stopwatch
from .scheduler import AdmissionQueue, QueueFullError

__all__ = ['DEFAULT_TENANT', 'QuotaExceededError', 'TenantPolicy',
           'TenantArbiter', 'WeightedFairQueue', 'record_completion',
           'record_shed', 'tenant_stats', 'tenant_burn_rates',
           'reset_tenant_stats']

DEFAULT_TENANT = 'default'

#: deficit granted per DRR visit, scaled by the tenant's weight. Each
#: popped request costs 1.0, so a weight-2 tenant pops two requests per
#: round for a weight-1 tenant's one.
DRR_QUANTUM = 1.0


class QuotaExceededError(QueueFullError):
    """A tenant's token-bucket / cost budget is exhausted: shed at submit.

    A shaped ``QueueFullError`` (so router failover and client backoff
    paths treat it as a shed, not a crash) with ``reason == 'quota'`` —
    but unlike ``queue_full``/``page_exhaustion`` it is **tenant-global**:
    retrying another replica cannot help, the tenant itself is over its
    contract. The router therefore re-raises it to the client instead of
    burning failover attempts.
    """

    def __init__(self, model, tenant, rate=None, burst=None, detail='rate'):
        RuntimeError.__init__(
            self,
            f"serving: tenant {tenant!r} over {detail} quota for model "
            f"{model!r} (rate={rate}, burst={burst}) — request shed "
            "(quota); retry with backoff")
        self.model = model
        self.capacity = burst
        self.reason = 'quota'
        self.tenant = tenant
        self.rate = rate
        self.burst = burst
        self.detail = detail


class TenantPolicy:
    """The per-tenant serving contract.

    ``weight`` — relative share of DRR pop bandwidth (default 1.0).
    ``rate``/``burst`` — token-bucket submit quota in requests/s with a
    ``burst`` bucket cap (default ``max(1, round(rate))``); ``rate=None``
    means unmetered. ``priority_floor`` — at shed-ladder level 1 the
    router rejects this tenant's requests whose priority is *below* the
    floor (a premium tenant sets 0 and nothing of its traffic sheds at
    level 1; a batch tenant sets a high floor and sheds first).
    ``cost_budget_flops``/``hbm_budget_bytes`` — optional cumulative cost
    budgets; ``TenantArbiter.charge`` spends against them (its caller
    supplies the cost: as in the reference, nothing in the runtime feeds
    it from the cost ledger).
    """

    __slots__ = ('name', 'weight', 'rate', 'burst', 'priority_floor',
                 'cost_budget_flops', 'hbm_budget_bytes')

    def __init__(self, name, weight=1.0, rate=None, burst=None,
                 priority_floor=0, cost_budget_flops=None,
                 hbm_budget_bytes=None):
        if not name:
            raise ValueError("tenant policy needs a name")
        weight = float(weight)
        if weight <= 0:
            raise ValueError(
                f"tenant {name!r}: weight must be > 0, got {weight}")
        if rate is not None:
            rate = float(rate)
            if rate <= 0:
                raise ValueError(
                    f"tenant {name!r}: rate must be > 0, got {rate}")
        if burst is None:
            burst = max(1, round(rate)) if rate is not None else None
        elif burst < 1:
            raise ValueError(
                f"tenant {name!r}: burst must be >= 1, got {burst}")
        self.name = str(name)
        self.weight = weight
        self.rate = rate
        self.burst = None if burst is None else int(burst)
        self.priority_floor = int(priority_floor)
        self.cost_budget_flops = cost_budget_flops
        self.hbm_budget_bytes = hbm_budget_bytes

    def __repr__(self):
        return (f"TenantPolicy({self.name!r}, weight={self.weight}, "
                f"rate={self.rate}, burst={self.burst}, "
                f"priority_floor={self.priority_floor})")


class TenantArbiter:
    """Policy registry + quota gate. Shared by an engine (front door) or a
    router (fleet front door) — never both at once, or tokens are charged
    twice per request.

    ``clock`` is a zero-arg seconds callable for token refill (default: a
    fresh ``Stopwatch``'s elapsed, a monotonic clock).
    Tests inject a virtual clock so refill is deterministic.
    """

    def __init__(self, policies=None, clock=None):
        self._policies = {}
        self._buckets = {}     # tenant -> [tokens, last_refill_s]
        self._spend = {}       # tenant -> {'flops': float, 'hbm_bytes': f}
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else Stopwatch().elapsed
        for p in (policies or []):
            self.set_policy(p)

    def set_policy(self, policy):
        if not isinstance(policy, TenantPolicy):
            raise TypeError(f"expected TenantPolicy, got {type(policy)}")
        with self._lock:
            self._policies[policy.name] = policy
            # a fresh bucket starts full: burst is the contract's headroom
            if policy.rate is not None:
                self._buckets[policy.name] = [float(policy.burst),
                                              float(self._clock())]
            else:
                self._buckets.pop(policy.name, None)
        return policy

    def policy(self, tenant):
        """The tenant's policy; unknown tenants get the default contract
        (weight 1, unmetered, floor 0) without registering it."""
        with self._lock:
            pol = self._policies.get(tenant)
        return pol or TenantPolicy(tenant or DEFAULT_TENANT)

    def policies(self):
        with self._lock:
            return dict(self._policies)

    def weight(self, tenant):
        return self.policy(tenant).weight

    def priority_floor(self, tenant):
        return self.policy(tenant).priority_floor

    def check(self, tenant, model):
        """Charge one token (and the cost budgets) or shed.

        Raises ``QuotaExceededError`` when the tenant's token bucket is
        empty or a cost budget is spent. On success the token is consumed
        — call exactly once per submit, at the front door.
        """
        tenant = tenant or DEFAULT_TENANT
        pol = self.policy(tenant)
        with self._lock:
            spend = self._spend.get(tenant, {})
            if pol.cost_budget_flops is not None and \
                    spend.get('flops', 0.0) >= pol.cost_budget_flops:
                raise QuotaExceededError(model, tenant, rate=pol.rate,
                                         burst=pol.burst, detail='flops')
            if pol.hbm_budget_bytes is not None and \
                    spend.get('hbm_bytes', 0.0) >= pol.hbm_budget_bytes:
                raise QuotaExceededError(model, tenant, rate=pol.rate,
                                         burst=pol.burst, detail='hbm')
            if pol.rate is not None:
                bucket = self._buckets.setdefault(
                    tenant, [float(pol.burst), float(self._clock())])
                now = float(self._clock())
                tokens = min(float(pol.burst),
                             bucket[0] + (now - bucket[1]) * pol.rate)
                bucket[1] = now
                if tokens < 1.0:
                    bucket[0] = tokens
                    raise QuotaExceededError(model, tenant, rate=pol.rate,
                                             burst=pol.burst)
                bucket[0] = tokens - 1.0
        if state.enabled():
            registry.counter('serving.tenant.submitted',
                             labels={'tenant': tenant}).inc()

    def charge(self, tenant, flops=0.0, hbm_bytes=0.0):
        """Spend against the tenant's cost budgets."""
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            spend = self._spend.setdefault(
                tenant, {'flops': 0.0, 'hbm_bytes': 0.0})
            spend['flops'] += float(flops)
            spend['hbm_bytes'] += float(hbm_bytes)
            return dict(spend)

    def spend(self, tenant):
        with self._lock:
            return dict(self._spend.get(tenant,
                                        {'flops': 0.0, 'hbm_bytes': 0.0}))

    def tokens(self, tenant):
        """Current token balance (after refill), or None when unmetered."""
        pol = self.policy(tenant)
        if pol.rate is None:
            return None
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                return float(pol.burst)
            return min(float(pol.burst),
                       bucket[0] + (float(self._clock()) - bucket[1])
                       * pol.rate)

    def stats(self):
        out = {}
        for name, pol in self.policies().items():
            out[name] = {'weight': pol.weight, 'rate': pol.rate,
                         'burst': pol.burst,
                         'priority_floor': pol.priority_floor,
                         'tokens': self.tokens(name)}
        return out


class WeightedFairQueue(AdmissionQueue):
    """``AdmissionQueue`` with one FIFO per tenant and DRR pop order.

    Same interface and capacity semantics (capacity bounds the *total*
    across tenants), so runners need no changes — ``pop_ready`` /
    ``pop_ready_while`` simply interleave tenants by weight instead of
    global arrival order. The DRR cursor persists across pops, so
    fairness holds across ``pump()`` steps, not just within one.
    """

    def __init__(self, model, capacity=256, arbiter=None):
        super().__init__(model, capacity)
        self._arbiter = arbiter
        self._qs = {}                  # tenant -> deque
        self._deficit = {}
        self._ring = []                # visit order: first-push order
        self._cursor = 0
        self._n = 0

    def _weight(self, tenant):
        return self._arbiter.weight(tenant) if self._arbiter else 1.0

    def _tenant_of(self, req):
        return getattr(req, 'tenant', None) or DEFAULT_TENANT

    def _q_for(self, tenant):
        dq = self._qs.get(tenant)
        if dq is None:
            dq = self._qs[tenant] = collections.deque()
            self._deficit[tenant] = 0.0
            self._ring.append(tenant)
        return dq

    def __len__(self):
        return self._n

    def tenants_queued(self):
        """{tenant: queued count} for every tenant with a backlog."""
        with self._lock:
            return {t: len(dq) for t, dq in self._qs.items() if dq}

    def push(self, req):
        with self._lock:
            if self._n >= self.capacity:
                raise QueueFullError(self.model, self.capacity)
            self._q_for(self._tenant_of(req)).append(req)
            self._n += 1

    def push_front(self, req):
        """Re-admit ``req`` at the head of ITS tenant's FIFO, past the
        capacity check (it was admitted once). A runner putting back
        several popped requests pushes them in reverse pop order, so each
        tenant's FIFO order holds."""
        with self._lock:
            self._q_for(self._tenant_of(req)).appendleft(req)
            self._n += 1

    def pop_ready_while(self, admit, max_n):
        ready, expired = [], []
        with self._lock:
            idle_visits = 0
            while self._n and len(ready) < max_n:
                if not self._ring:
                    break
                self._cursor %= len(self._ring)
                tenant = self._ring[self._cursor]
                dq = self._qs.get(tenant)
                if not dq:
                    # an emptied tenant forfeits its residue (classic DRR)
                    self._deficit[tenant] = 0.0
                    self._cursor += 1
                    idle_visits += 1
                    if idle_visits >= len(self._ring):
                        break
                    continue
                idle_visits = 0
                self._deficit[tenant] += DRR_QUANTUM * self._weight(tenant)
                blocked = False
                while dq and self._deficit[tenant] >= 1.0 \
                        and len(ready) < max_n:
                    req = dq[0]
                    if req.expired():
                        expired.append(dq.popleft())
                        self._n -= 1
                        continue
                    if admit is not None and not admit(req):
                        blocked = True
                        break
                    ready.append(dq.popleft())
                    self._n -= 1
                    self._deficit[tenant] -= 1.0
                if not dq:
                    self._deficit[tenant] = 0.0
                self._cursor += 1
                if blocked:
                    # an admit-declined head (KV pages) stalls the WHOLE
                    # pop — skipping to another tenant would hand the
                    # blocked tenant's batch slots to its neighbors and
                    # starve it exactly when it is resource-pressured
                    break
        for r in ready + expired:
            r.queue_ms = r.sw.elapsed_ms()
        return ready, expired

    def remove(self, req):
        with self._lock:
            tenant = self._tenant_of(req)
            order = [self._qs[tenant]] if tenant in self._qs else []
            order += [dq for t, dq in self._qs.items() if t != tenant]
            for dq in order:
                try:
                    dq.remove(req)
                except ValueError:
                    continue
                self._n -= 1
                return True
        return False

    def reap_expired(self):
        expired = []
        with self._lock:
            for dq in self._qs.values():
                live = [r for r in dq if not r.expired()]
                if len(live) != len(dq):
                    expired.extend(r for r in dq if r.expired())
                    dq.clear()
                    dq.extend(live)
            self._n -= len(expired)
        for r in expired:
            r.queue_ms = r.sw.elapsed_ms()
        return expired

    def drain(self):
        with self._lock:
            out = []
            for tenant in self._ring:
                out.extend(self._qs[tenant])
                self._qs[tenant].clear()
            self._n = 0
        return out


# -- per-tenant accounting (always-on tallies, slo.py discipline) -----------

_acct_lock = threading.Lock()
_tallies = {}       # tenant -> {'requests', 'violations'}
_burn_keys = {}     # (tenant, model) -> {'requests', 'violations'}
_sheds = {}         # tenant -> {reason: count}


def record_completion(req, status, latency_ms):
    """Attribute one completed request to its tenant.

    Called from ``runners.finish_request`` for every request carrying a
    tenant. Judges the request against the *model's* SLO objective but
    tallies per (tenant, model), so ``tenant_burn_rates`` isolates each
    tenant's burn — one tenant's violations never move a neighbor's.
    """
    tenant = getattr(req, 'tenant', None)
    if not tenant:
        return None
    obj = _slo.objective(req.model)
    violated = status != 'ok' or (
        obj is not None and float(latency_ms) > obj['target_ms'])
    with _acct_lock:
        t = _tallies.setdefault(tenant, {'requests': 0, 'violations': 0})
        t['requests'] += 1
        b = _burn_keys.setdefault((tenant, req.model),
                                  {'requests': 0, 'violations': 0})
        b['requests'] += 1
        if violated:
            t['violations'] += 1
            b['violations'] += 1
        b_requests, b_violations = b['requests'], b['violations']
    burn = None
    if obj is not None:
        budget = max(1.0 - obj['objective'], 1e-9)
        burn = (b_violations / b_requests) / budget
    if state.enabled():
        lbl = {'tenant': str(tenant)}
        registry.counter('serving.tenant.requests', labels=lbl).inc()
        registry.histogram('serving.tenant.latency_ms', labels=lbl) \
            .observe(float(latency_ms))
        if violated:
            registry.counter('serving.tenant.violations', labels=lbl).inc()
        if burn is not None:
            registry.gauge('serving.tenant.burn_rate',
                           labels=lbl).set(round(burn, 4))
        # the cumulative ledger event (last-wins for consumers): only
        # once traffic is actually multi-tenant / shedding — single-
        # tenant default traffic keeps its event stream lean
        if tenant != DEFAULT_TENANT or len(_tallies) > 1 or _sheds:
            events.emit('serving.tenant_stats', tenants=tenant_stats())
    return burn


def record_shed(tenant, reason):
    """Attribute one shed to its tenant (reason: ``queue_full`` /
    ``page_exhaustion`` / ``quota``). Called by the engine/router shed
    paths beside their unlabeled ``serving.shed.*`` counters."""
    tenant = tenant or DEFAULT_TENANT
    with _acct_lock:
        _sheds.setdefault(tenant, {})[reason] = \
            _sheds.get(tenant, {}).get(reason, 0) + 1
    if state.enabled():
        registry.counter('serving.tenant.shed',
                         labels={'tenant': str(tenant)}).inc()
        events.emit('serving.tenant_stats', tenants=tenant_stats())


def tenant_burn_rates():
    """{tenant: worst per-model burn} over this tenant's own traffic."""
    with _acct_lock:
        items = [(k, dict(v)) for k, v in _burn_keys.items()]
    out = {}
    for (tenant, model), t in items:
        obj = _slo.objective(model)
        if obj is None or not t['requests']:
            continue
        budget = max(1.0 - obj['objective'], 1e-9)
        burn = round((t['violations'] / t['requests']) / budget, 4)
        out[tenant] = max(out.get(tenant, 0.0), burn)
    return out


def tenant_stats():
    """{tenant: {requests, violations, burn, shed: {reason: n}}} — the
    cumulative per-tenant ledger (also the ``serving.tenant_stats``
    event payload)."""
    burns = tenant_burn_rates()
    with _acct_lock:
        tenants = set(_tallies) | set(_sheds)
        out = {}
        for t in sorted(tenants):
            tal = _tallies.get(t, {'requests': 0, 'violations': 0})
            out[t] = {'requests': tal['requests'],
                      'violations': tal['violations'],
                      'burn': burns.get(t, 0.0),
                      'shed': dict(_sheds.get(t, {}))}
    return out


def reset_tenant_stats():
    with _acct_lock:
        _tallies.clear()
        _burn_keys.clear()
        _sheds.clear()
