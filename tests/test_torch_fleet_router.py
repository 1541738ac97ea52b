"""The port's fleet layer (``serving.router``, ``serving.fleet_supervisor``)
against the JAX package's, on the CPU.

The reference's 24 scenarios (``tests/test_fleet_router.py``) run on both
packages over the same engines: the reference's 8-wide ``feeds['x'] @ 2I``
``predict_fn`` in buckets (1, 2, 4), manual-pump where the reference's are
and started where its chaos and hedging need a live worker. Where a run is
deterministic the two sides must give the same ``router.stats()`` rows
(dispatched, completed, retried, hedged, deaths, circuit), the same
breaker transitions, the same placements (64 rendezvous keys included),
the same shed levels and ``FleetOverloadError`` fields, the same degrade
cap and supervisor budget, and the same ``serving.router.*`` counters and
router events (timing histograms by count only). Where worker threads
decide the interleaving (the chaos fleet, hedging), each side must pass
the reference's own gates. Then the slice as a whole: a 2-layer BERT on
shared weights behind a router over two started engines on each side, one
replica killed mid-stream: every request answered, the outputs within
``MODEL_TOL`` of each other.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.observability import doctor as r_doc
from paddle_tpu.observability import slo as r_slo
from paddle_tpu.resilience import faultinject as r_fi
from paddle_tpu.resilience import watchdog as r_wd
from paddle_tpu.serving import router as r_router
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertModel as JaxBertModel

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.observability import doctor as t_doc
from paddle_tpu_torch.observability import slo as t_slo
from paddle_tpu_torch.resilience import faultinject as t_fi
from paddle_tpu_torch.resilience import watchdog as t_wd
from paddle_tpu_torch.serving import router as t_router
from paddle_tpu_torch.text.bert import BertConfig, BertModel

from _torch_spines import clean_spines  # noqa: F401  (autouse)

MODEL_TOL = 1e-4

REF = SimpleNamespace(name='ref', serving=rserving, router=r_router,
                      obs=r_obs, doc=r_doc, slo=r_slo, fi=r_fi, wd=r_wd,
                      kw={})
PORT = SimpleNamespace(name='port', serving=tserving, router=t_router,
                       obs=t_obs, doc=t_doc, slo=t_slo, fi=t_fi, wd=t_wd,
                       kw={'device': 'cpu'})
SIDES = (REF, PORT)


def both(scenario, *args):
    """``scenario(side, *args)`` on the reference and on the port ->
    (reference's result, port's result)."""
    return tuple(scenario(side, *args) for side in SIDES)


def _mlp_fn(side):
    w = np.eye(8, dtype=np.float32) * 2.0
    if side is REF:
        return lambda feeds: feeds['x'] @ w
    tw = torch.from_numpy(w)
    return lambda feeds: feeds['x'] @ tw


def _example():
    return {'x': np.zeros((8,), np.float32)}


def _x(i):
    return {'x': np.full((8,), i, np.float32)}


def _engine(side, capacity=64):
    eng = side.serving.ServingEngine(queue_capacity=capacity, **side.kw)
    eng.register('m', predict_fn=_mlp_fn(side), example=_example(),
                 bucket_spec=side.serving.BucketSpec((1, 2, 4)),
                 jit_compile=False)
    return eng


def _fleet(side, n=3, policy=None):
    router = side.serving.FleetRouter(policy=policy)
    engines = []
    for i in range(n):
        eng = _engine(side)
        router.add_replica(f'r{i}', eng)
        engines.append(eng)
    return router, engines


def _p99(lat):
    return sorted(lat)[int(0.99 * (len(lat) - 1))]


def _rows(router, keys=('dispatched', 'completed', 'failed', 'retried',
                        'hedged', 'hedge_wins', 'drained', 'queue_full',
                        'deaths', 'restarts', 'circuit', 'trips',
                        'draining')):
    return {name: {k: row[k] for k in keys}
            for name, row in router.stats()['replicas'].items()}


def _router_tallies(side):
    """The ``serving.router.*`` and ``fleet.*`` counters, and each such
    histogram's count."""
    snap = side.obs.snapshot()
    pick = ('serving.router', 'fleet.')
    return ({k: v for k, v in snap['counters'].items() if k.startswith(pick)},
            {k: v['count'] for k, v in snap['histograms'].items()
             if k.startswith(pick)})


_VOLATILE = ('ts', 'fleet', 'latency_ms', 'ms', 'error', 'recovery_ms')


def _router_events(side):
    """The router's and the supervisor's events in order, without the
    fields that carry a process-wide id, a time or a repr."""
    return [{k: v for k, v in e.items() if k not in _VOLATILE}
            for e in side.obs.event_log()
            if e['ev'].startswith(('serving.router', 'fleet.'))]


def _telemetry_record(side, router):
    return {'rows': _rows(router), 'tallies': _router_tallies(side),
            'events': _router_events(side)}


class _FakeEngine:
    """Duck-typed replica for placement and shed scenarios: records
    submit-time knobs, never pumped (the reference test's own)."""

    def __init__(self, kind='generative'):
        self.kind = kind
        self.max_new_tokens_seen = []

    def dispatchable(self):
        return True

    def has_model(self, model):
        return True

    def model_kind(self, model):
        return self.kind

    def page_starved(self, model):
        return False

    def queued_count(self, model=None):
        return 0

    def resident_count(self, model=None):
        return 0

    def alive(self):
        return False

    def submit(self, model, inputs, deadline_ms=None, max_new_tokens=None,
               tenant=None):
        self.max_new_tokens_seen.append(max_new_tokens)

        class _P:
            request_id = 0

            def done(self):
                return False
        return _P()

    def cancel(self, pending):
        return True


# ---------------------------------------------------------------------------
# routing basics
# ---------------------------------------------------------------------------

def _round_trip(side):
    side.obs.enable()
    router, engines = _fleet(side, 3)
    pendings = [router.submit('m', _x(i)) for i in range(6)]
    placed = [p.replicas_tried for p in pendings]
    for eng in engines:
        eng.run_until_idle()
    for i, p in enumerate(pendings):
        r = p.result(timeout=10)
        assert r.ok and np.allclose(r.outputs, 2.0 * i)
    rows = router.stats()['replicas']
    assert sum(row['dispatched'] for row in rows.values()) == 6
    assert sum(row['completed'] for row in rows.values()) == 6
    assert sum(1 for row in rows.values() if row['dispatched']) >= 2
    return placed, _telemetry_record(side, router)


def test_round_trip_and_spread():
    ref, port = both(_round_trip)
    assert port == ref


def _unknown_and_duplicate(side):
    router, _ = _fleet(side, 2)
    out = []
    for call, exc in ((lambda: router.submit('nope', _example()), KeyError),
                      (lambda: router.add_replica('r0', _engine(side)),
                       ValueError),
                      (lambda: router.replica('ghost'), KeyError)):
        with pytest.raises(exc) as ei:
            call()
        out.append(str(ei.value))
    return out


def test_unknown_model_and_duplicate_replica():
    ref, port = both(_unknown_and_duplicate)
    assert port == ref
    assert 'no replica serves' in port[0] and 'already in' in port[1]


def _affinity(side):
    router = side.serving.FleetRouter()
    for i in range(3):
        router.add_replica(f'r{i}', _FakeEngine(kind='generative'))
    toks = list(range(20))
    tried = [router.submit('lm', {'tokens': toks}).replicas_tried[0]
             for _ in range(4)]
    assert len(set(tried)) == 1
    other = router.submit('lm', {'tokens': [7] * 20}).replicas_tried[0]
    # 64 prompts, short and long, each placed by its rendezvous key
    rs = np.random.RandomState(5)
    keys = []
    for n in rs.randint(1, 80, size=64):
        prompt = [int(t) for t in rs.randint(0, 50, size=n)]
        keys.append(router.submit('lm', {'tokens': prompt})
                    .replicas_tried[0])
    return tried, other, keys


def test_prefix_affinity_and_rendezvous_placement():
    ref, port = both(_affinity)
    assert port == ref
    assert set(port[2]) == {'r0', 'r1', 'r2'}


def _deadline(side):
    router, _ = _fleet(side, 1)
    p = router.submit('m', _example(), deadline_ms=30)
    r = p.result(timeout=5)
    again = p.result(timeout=1)
    assert again is r
    return r.status, r.outputs


def test_deadline_answered_without_service():
    ref, port = both(_deadline)
    assert port == ref == (rserving.STATUS_DEADLINE, None)


# ---------------------------------------------------------------------------
# the chaos fleet: zero lost requests through a replica kill
# ---------------------------------------------------------------------------

def _chaos(side):
    side.obs.enable()
    policy = side.serving.RouterPolicy(max_retries=2,
                                       attempt_timeout_ms=5000, trip_after=3,
                                       circuit_cooldown_s=60.0)
    router = side.serving.FleetRouter(policy=policy)
    engines = []
    for i in range(3):
        eng = _engine(side)
        eng.warmup()
        eng.start()
        router.add_replica(f'r{i}', eng)
        engines.append(eng)
    side.fi.kill_replica_at_request(engines[1], at_request=5)
    side.fi.slow_replica(engines[2], delay_s=0.01)
    out = {}
    try:
        ok = 0
        for i in range(40):
            p = router.submit('m', _x(i), deadline_ms=15000)
            r = p.result(timeout=20)
            assert r.ok and np.allclose(r.outputs, 2.0 * i)
            ok += 1
        rows = router.stats()['replicas']
        out['ok'] = ok
        out['r1'] = (rows['r1']['deaths'], rows['r1']['circuit'])
        out['retried'] = sum(row['retried'] for row in rows.values()) >= 1
        out['completed'] = sum(row['completed'] for row in rows.values())

        def factory(name):
            eng = _engine(side)
            eng.start()
            return eng

        sup = side.serving.FleetSupervisor(router, factory, max_restarts=3,
                                           warmup=True)
        out['relaunched'] = sup.check_once()
        h = router.replica('r1')
        out['rejoin'] = (h.restarts, h.breaker.state,
                         h.engine.dispatchable())
        engines[1] = h.engine
        out['after'] = [router.predict('m', _x(i), timeout=20).ok
                        for i in range(6)]
        out['counters'] = sorted(_router_tallies(side)[0])
        out['recovery_ms'] = _router_tallies(side)[1].get(
            'fleet.recovery_ms')
    finally:
        for eng in engines:
            eng.kill()
        for eng in engines:
            eng.stop()
    return out


def test_kill_and_slow_replica_zero_lost():
    ref, port = both(_chaos)
    assert port == ref
    assert port['ok'] == 40 and port['completed'] == 40
    assert port['r1'] == (1, 'open') and port['retried']
    assert port['relaunched'] == ['r1']
    assert port['rejoin'] == (1, 'half_open', True)
    assert all(port['after']) and port['recovery_ms'] == 1


def _fail_fast(side):
    side.obs.enable()
    router, engines = _fleet(side, 2, policy=side.serving.RouterPolicy(
        on_replica_death='fail_fast'))
    p = router.submit('m', _example())
    victim = p.replicas_tried[0]
    router.replica(victim).engine.kill()
    with pytest.raises(side.serving.ReplicaError,
                       match='replica_death') as ei:
        p.result(timeout=5)
    assert ei.value.replica == victim
    return (victim, p.replicas_tried, ei.value.replicas,
            _telemetry_record(side, router))


def test_fail_fast_death_policy():
    ref, port = both(_fail_fast)
    assert port == ref
    assert port[1] == (port[0],)


def _non_idempotent(side):
    side.obs.enable()
    router, engines = _fleet(side, 2)
    p = router.submit('m', _example(), idempotent=False)
    victim = p.replicas_tried[0]
    router.replica(victim).engine.kill()
    with pytest.raises(side.serving.ReplicaError,
                       match='non_idempotent') as ei:
        p.result(timeout=5)
    assert ei.value.replica == victim
    return victim, p.replicas_tried, _telemetry_record(side, router)


def test_non_idempotent_never_replayed():
    ref, port = both(_non_idempotent)
    assert port == ref
    rows = port[2]['rows']
    assert sum(row['dispatched'] for row in rows.values()) == 1


# ---------------------------------------------------------------------------
# tail-latency hedging
# ---------------------------------------------------------------------------

def _hedging(side):
    policy = side.serving.RouterPolicy(hedge_after_ms=None,
                                       trip_after=10 ** 6)
    router = side.serving.FleetRouter(policy=policy)
    engines = [_engine(side), _engine(side)]
    router.add_replica('fast', engines[0])
    router.add_replica('slow', engines[1])
    for eng in engines:
        eng.start()
    side.fi.slow_replica(engines[1], delay_s=0.12)
    try:
        def run(n=25):
            lat = []
            for i in range(n):
                sw = time.monotonic()
                r = router.predict('m', _x(i), timeout=20)
                assert r.ok and np.allclose(r.outputs, 2.0 * i)
                lat.append((time.monotonic() - sw) * 1000.0)
            return lat

        lat_off = run()
        policy.hedge_after_ms = 20.0
        lat_on = run()
    finally:
        for eng in engines:
            eng.kill()
        for eng in engines:
            eng.stop()
    p99_off, p99_on = _p99(lat_off), _p99(lat_on)
    assert p99_on <= 0.6 * p99_off, (p99_on, p99_off)
    rows = router.stats()['replicas']
    return (sum(row['hedge_wins'] for row in rows.values()) > 0,
            sum(row['deaths'] for row in rows.values()))


def test_hedged_p99_beats_unhedged_on_slow_tail():
    ref, port = both(_hedging)
    assert port == ref == (True, 0)


# ---------------------------------------------------------------------------
# graceful drain / rejoin
# ---------------------------------------------------------------------------

def _drain(side):
    side.obs.enable()
    router, (eng,) = _fleet(side, 1)
    pendings = [router.submit('m', _x(i)) for i in range(3)]
    assert router.drain('r0', timeout=10) is eng
    for i, p in enumerate(pendings):
        r = p.result(timeout=5)
        assert r.ok and np.allclose(r.outputs, 2.0 * i)
    h = router.replica('r0')
    assert h.drained and h.drained_requests == 3
    with pytest.raises(side.serving.NoHealthyReplicaError):
        router.submit('m', _example())
    router.readmit('r0')
    state = h.breaker.state
    p = router.submit('m', _example())
    eng.run_until_idle()
    assert p.result(timeout=5).ok
    return state, _telemetry_record(side, router)


def test_drain_finishes_residents_and_blocks_admits():
    ref, port = both(_drain)
    assert port == ref
    assert port[0] == 'half_open'


def _drain_hung(side):
    router, (eng,) = _fleet(side, 1)
    p = router.submit('m', _example())
    hang = side.fi.hang_replica(eng)
    with pytest.raises(side.wd.WatchdogTimeout, match='drain'):
        router.drain('r0', timeout=0.3)
    out = [router.replica('r0').draining]
    hang.release()
    router.drain('r0', timeout=10)
    out += [p.result(timeout=5).ok, router.replica('r0').drained_requests]
    return out


def test_drain_timeout_on_hung_replica():
    ref, port = both(_drain_hung)
    assert port == ref == [True, True, 1]


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------

def _breaker_trip(side):
    side.obs.enable()
    cb = side.serving.CircuitBreaker('x', trip_after=2, cooldown_s=0.05,
                                     factor=1.0, jitter=0.0,
                                     half_open_probes=2)
    log = [(cb.allow(), cb.state)]
    cb.record_failure('e')
    log.append(cb.state)
    cb.record_failure('e')
    log += [(cb.state, cb.trips), cb.allow()]
    time.sleep(0.08)
    log += [cb.allow(), cb.state]
    cb.on_dispatch()
    cb.record_success()
    log += [cb.state, cb.allow()]
    cb.on_dispatch()
    cb.record_success()
    log += [(cb.state, cb.closes)]
    return log, _router_events(side), _router_tallies(side)


def _breaker_halfopen(side):
    side.obs.enable()
    cb = side.serving.CircuitBreaker('x', trip_after=1, cooldown_s=0.02,
                                     factor=1.0, jitter=0.0,
                                     half_open_probes=1)
    cb.record_failure('e')
    time.sleep(0.04)
    log = [cb.allow(), cb.state]
    cb.on_dispatch()
    log.append(cb.allow())
    cb.record_failure('probe bad')
    log += [cb.state, cb.trips]
    return log, _router_events(side), _router_tallies(side)


def _breaker_forced(side):
    side.obs.enable()
    cb = side.serving.CircuitBreaker('x', trip_after=5)
    cb.trip('replica_death')
    cb.trip('replica_death')
    log = [cb.state, cb.trips]
    cb.force_half_open()
    log += [cb.state, cb.allow(), round(cb.cooldown(), 6)]
    return log, _router_events(side), _router_tallies(side)


@pytest.mark.parametrize("scenario, want, states", [
    (_breaker_trip, [(True, 'closed'), 'closed', ('open', 1), False, True,
                     'half_open', 'half_open', True, ('closed', 1)],
     ['open', 'half_open', 'closed']),
    (_breaker_halfopen, [True, 'half_open', False, 'open', 2],
     ['open', 'half_open', 'open']),
    (_breaker_forced, ['open', 1, 'half_open', True, 0.25],
     ['open', 'half_open']),
], ids=['trip_cooldown_halfopen_recovery', 'halfopen_failure_reopens',
        'instant_trip_and_forced_rejoin'])
def test_circuit_breaker_transitions(scenario, want, states):
    ref, port = both(scenario)
    assert port == ref
    assert port[0] == want
    assert [e['state'] for e in port[1]] == states
    assert port[2][0]['serving.router.circuit_transitions'] == len(states)


# ---------------------------------------------------------------------------
# supervisor relaunch
# ---------------------------------------------------------------------------

def _supervised(side, max_restarts):
    router, engines = _fleet(side, 2)
    sup = side.serving.FleetSupervisor(router, lambda name: _engine(side),
                                       max_restarts=max_restarts,
                                       warmup=False)
    return router, engines, sup


def _relaunch(side):
    side.obs.enable()
    router, engines, sup = _supervised(side, 3)
    out = [sup.check_once()]
    engines[0].kill()
    out.append(sup.check_once())
    h = router.replica('r0')
    out += [h.restarts, sup.restarts(), h.breaker.state,
            h.engine is not engines[0], h.engine.dispatchable()]
    p = router.submit('m', _example())
    for rep in router.replicas():
        rep.engine.run_until_idle()
    out.append(p.result(timeout=5).ok)
    return out, _telemetry_record(side, router)


def test_supervisor_relaunch_rejoins_half_open():
    ref, port = both(_relaunch)
    assert port == ref
    assert port[0] == [[], ['r0'], 1, {'r0': 1}, 'half_open', True, True,
                       True]


def _budget(side):
    side.obs.enable()
    router, engines, sup = _supervised(side, 1)
    engines[0].kill()
    out = [sup.check_once()]
    router.replica('r0').engine.kill()
    out += [sup.check_once(), sup.restarts()]
    p = router.submit('m', _example())
    router.replica('r1').engine.run_until_idle()
    out.append(p.result(timeout=5).ok)
    return out, _telemetry_record(side, router)


def test_supervisor_restart_budget_exhausts():
    ref, port = both(_budget)
    assert port == ref
    assert port[0] == [['r0'], [], {'r0': 1}, True]
    assert port[1]['tallies'][0]['fleet.restarts_exhausted'] == 1


# ---------------------------------------------------------------------------
# the shed ladder
# ---------------------------------------------------------------------------

def _burn(side, monkeypatch, value):
    monkeypatch.setattr(side.slo, 'burn_rates',
                        lambda: {'m': value} if value else {})


def _ladder(side, monkeypatch):
    router, _ = _fleet(side, 1)
    levels = []
    for burn in (0.0, 0.99, 1.0, 1.2, 2.0, 2.5, 3.99, 4.0, 5.0):
        _burn(side, monkeypatch, burn)
        levels.append(router.shed_level())
    return levels


def test_ladder_levels_from_burn(monkeypatch):
    ref = _ladder(REF, monkeypatch)
    port = _ladder(PORT, monkeypatch)
    assert port == ref == [0, 0, 1, 1, 2, 2, 2, 3, 3]
    assert (t_router.SHED_NONE, t_router.SHED_PRIORITY,
            t_router.SHED_DEGRADE, t_router.SHED_REJECT) == (0, 1, 2, 3)


def _reject(side, monkeypatch):
    side.obs.enable()
    router, (eng,) = _fleet(side, 1)
    out = []
    for burn, prio in ((5.0, 10), (1.2, 0), (2.5, 0), (5.0, 1)):
        _burn(side, monkeypatch, burn)
        with pytest.raises(side.serving.FleetOverloadError) as ei:
            router.submit('m', _example(), priority=prio)
        out.append((ei.value.level, ei.value.reason, str(ei.value)))
    _burn(side, monkeypatch, 1.2)
    p = router.submit('m', _example(), priority=1)
    eng.run_until_idle()
    out.append(p.result(timeout=5).ok)
    return out, _telemetry_record(side, router)


def test_reject_all_and_priority_floor(monkeypatch):
    ref = _reject(REF, monkeypatch)
    port = _reject(PORT, monkeypatch)
    assert port == ref
    assert [o[0] for o in port[0][:4]] == [3, 1, 2, 3] and port[0][4]


def _tenant_floor(side, monkeypatch):
    adm = side.serving
    arb = adm.TenantArbiter([adm.TenantPolicy('gold', priority_floor=0),
                             adm.TenantPolicy('batch', priority_floor=5)])
    router = side.serving.FleetRouter(tenants=arb)
    router.add_replica('r0', _engine(side))
    _burn(side, monkeypatch, 1.2)
    out = []
    for tenant in ('gold', 'batch'):
        try:
            router.submit('m', _example(), priority=1, tenant=tenant)
            out.append('admitted')
        except side.serving.FleetOverloadError as e:
            out.append((e.level, e.reason, str(e)))
    return out


def test_shed_ladder_is_tenant_aware(monkeypatch):
    ref = _tenant_floor(REF, monkeypatch)
    port = _tenant_floor(PORT, monkeypatch)
    assert port == ref
    assert port[0] == 'admitted' and port[1][0] == 1


def _degrade(side, monkeypatch):
    side.obs.enable()
    router = side.serving.FleetRouter()
    fake = _FakeEngine(kind='generative')
    router.add_replica('r0', fake)
    _burn(side, monkeypatch, 2.5)
    router.submit('lm', {'tokens': [1, 2, 3]}, max_new_tokens=64)
    router.submit('lm', {'tokens': [1, 2, 3]})
    router.submit('lm', {'tokens': [1, 2, 3]}, max_new_tokens=4)
    _burn(side, monkeypatch, 0.0)
    router.submit('lm', {'tokens': [1, 2, 3]}, max_new_tokens=64)
    return (fake.max_new_tokens_seen, router.policy.shed_max_new_tokens,
            _router_events(side))


def test_degrade_caps_generative_budget(monkeypatch):
    ref = _degrade(REF, monkeypatch)
    port = _degrade(PORT, monkeypatch)
    assert port == ref
    assert port[0] == [8, 8, 4, 64]


# ---------------------------------------------------------------------------
# telemetry and the doctor
# ---------------------------------------------------------------------------

def _fleet_table(side):
    side.obs.enable()
    router, engines = _fleet(side, 2)
    pendings = [router.submit('m', _example()) for _ in range(3)]
    for eng in engines:
        eng.run_until_idle()
    for p in pendings:
        assert p.result(timeout=5).ok
    last = [e for e in side.obs.event_log()
            if e['ev'] == 'serving.router_stats'][-1]
    return ({k: v for k, v in last.items() if k != 'ts'},
            _telemetry_record(side, router))


def test_router_stats_events_feed_the_fleet_table():
    ref, port = both(_fleet_table)
    assert port == ref
    assert set(port[0]['replicas']) == {'r0', 'r1'}


def test_doctor_replica_flapping_matches_the_reference():
    evs = []
    for i in range(4):
        evs.append({'ev': 'serving.router.circuit', 'replica': 'r2',
                    'state': 'open', 'reason': 'error'})
        evs.append({'ev': 'serving.router.circuit', 'replica': 'r2',
                    'state': 'closed'})
    got = [(list(doc.detect_replica_flapping(events=evs)),
            list(doc.detect_replica_flapping(events=evs[:5])))
           for doc in (r_doc, t_doc)]
    assert got[1] == got[0]
    hits, quiet = got[1]
    assert len(hits) == 1 and hits[0]['cause'] == 'replica_flapping'
    assert hits[0]['evidence']['replica'] == 'r2'
    assert hits[0]['evidence']['opens'] == 4 and not quiet


def test_doctor_retry_storm_matches_the_reference():
    snap = {'counters': {
        'serving.router.dispatched{replica=r0}': 30,
        'serving.router.dispatched{replica=r1}': 10,
        'serving.router.retries{replica=r1}': 12,
        'serving.router.hedges{replica=r0}': 0,
    }}
    calm = {'counters': dict(snap['counters'])}
    calm['counters']['serving.router.retries{replica=r1}'] = 1
    got = [(list(doc.detect_retry_storm(snapshot=snap)),
            list(doc.detect_retry_storm(snapshot=calm)))
           for doc in (r_doc, t_doc)]
    assert got[1] == got[0]
    hits, quiet = got[1]
    assert len(hits) == 1 and hits[0]['cause'] == 'retry_storm'
    assert hits[0]['evidence']['offered'] == 28
    assert hits[0]['evidence']['retries'] == 12 and not quiet


def test_detectors_reachable_from_the_cli_gate():
    for doc in (r_doc, t_doc):
        assert doc.DETECTORS['replica_flapping'] is \
            doc.detect_replica_flapping
        assert doc.DETECTORS['retry_storm'] is doc.detect_retry_storm


# ---------------------------------------------------------------------------
# forced interleavings
# ---------------------------------------------------------------------------

def _budget_race(side):
    router, engines = _fleet(side, 1)
    engines[0].kill()
    release = threading.Event()
    calls = []

    def parked_factory(name):
        calls.append(name)
        release.wait(5)
        return _engine(side)

    sup = side.serving.FleetSupervisor(router, parked_factory,
                                       max_restarts=1,
                                       relaunch_backoff_s=0.0)
    racer = side.fi.RacingCall(sup.check_once)
    out = [racer.blocked(), sup.check_once(), list(calls)]
    release.set()
    out += [racer.join(), list(calls), sup.restarts(),
            router.replica('r0').engine.dispatchable()]
    router.replica('r0').engine.kill()
    return out


def test_supervisor_claims_restart_budget_exactly_once():
    ref, port = both(_budget_race)
    assert port == ref == [True, [], ['r0'], ['r0'], ['r0'], {'r0': 1},
                           True]


def _ledger_race(side):
    router, engines = _fleet(side, 1)
    h = router.replica('r0')
    with side.fi.hold_lock(h._ledger):
        racer = side.fi.RacingCall(h.bump, 'dispatched')
        out = [racer.blocked(), h.dispatched]
    racer.join()
    out += [h.dispatched, h.stats_row()['dispatched']]
    engines[0].kill()
    return out


def test_replica_ledger_bump_serialized():
    ref, port = both(_ledger_race)
    assert port == ref == [True, 0, 1, 1]


# ---------------------------------------------------------------------------
# the slice as a whole: BERT behind the router, one replica killed
# ---------------------------------------------------------------------------

SEQ = 16


def _bert_pair():
    small = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64)
    paddle.seed(13)
    ref = JaxBertModel(JaxBertConfig(**small))
    port = BertModel(BertConfig(**small), device='cpu')
    load_paddle_tpu_state(port, {k: np.asarray(v._value)
                                 for k, v in ref.state_dict().items()})

    class Serve(paddle.nn.Layer):
        """Names the reference engine's feeds as forward's parameters (it
        binds feeds positionally; tests/test_torch_serving.py)."""

        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, input_ids, attention_mask):
            return self.bert(input_ids, attention_mask=attention_mask)
    return {REF.name: Serve(ref), PORT.name: port}


def _bert_requests(n=12):
    rs = np.random.RandomState(17)
    out = []
    for _ in range(n):
        length = rs.randint(1, SEQ + 1)
        ids = np.zeros(SEQ, np.int32)
        ids[:length] = rs.randint(1, 100, size=length)
        out.append({'input_ids': ids,
                    'attention_mask': (ids > 0).astype(np.int32)})
    return out


def _bert_fleet(side, layer, reqs):
    side.obs.enable()
    router = side.serving.FleetRouter(policy=side.serving.RouterPolicy(
        max_retries=2, circuit_cooldown_s=60.0))
    engines = []
    example = {k: np.zeros(SEQ, np.int32)
               for k in ('input_ids', 'attention_mask')}
    for i in range(2):
        eng = side.serving.ServingEngine(queue_capacity=64, **side.kw)
        eng.register('bert', layer=layer, example=example,
                     bucket_spec=side.serving.BucketSpec((1, 2, 4)))
        eng.warmup()
        eng.start()
        router.add_replica(f'r{i}', eng)
        engines.append(eng)
    # r1 dies right after admitting its third request, which it strands;
    # the stream goes on one request at a time, as the chaos fleet's does
    side.fi.kill_replica_at_request(engines[1], at_request=3)
    try:
        resps = [router.submit('bert', r, deadline_ms=60_000)
                 .result(timeout=60) for r in reqs]
    finally:
        for eng in engines:
            eng.kill()
        for eng in engines:
            eng.stop()
    rows = router.stats()['replicas']
    assert all(r.ok for r in resps)
    summary = {'deaths': {n: row['deaths'] for n, row in rows.items()},
               'circuit': rows['r1']['circuit'],
               'completed': sum(row['completed'] for row in rows.values()),
               'retried': sum(row['retried'] for row in rows.values()) >= 1}
    return [r.outputs for r in resps], summary


def test_bert_behind_the_router_survives_a_kill():
    layers = _bert_pair()
    reqs = _bert_requests()
    got = {side.name: _bert_fleet(side, layers[side.name], reqs)
           for side in SIDES}
    assert got['port'][1] == got['ref'][1] == {
        'deaths': {'r0': 0, 'r1': 1}, 'circuit': 'open',
        'completed': len(reqs), 'retried': True}
    for a, b in zip(got['port'][0], got['ref'][0]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=MODEL_TOL)


def test_launch_counter_is_exact_under_concurrent_workers(monkeypatch):
    """A fleet's engines launch from several worker threads at once, and
    ``chip_smoke.py`` gates on exact launch counts: every count update
    holds ``_build.launches_lock``. A stand-in entry point (the CPU has no
    kernel library) takes ``_build.call``'s counting path; with the lock
    held by the test, the call parks before its count lands (the
    schedule pinned by ``hold_lock``/``RacingCall``, not by sleeps), and
    eight threads' calls all land once it is released."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setitem(_build._fns, 'ptt_stand_in', lambda *a: 0)
    kernels.reset_launch_counts()
    with t_fi.hold_lock(_build.launches_lock):
        racer = t_fi.RacingCall(_build.call, 'flash_attention_fwd',
                                'ptt_stand_in', ())
        assert racer.blocked(), "the count landed outside the lock"
        assert _build.launches['flash_attention_fwd'] == 0
    racer.join()

    def worker():
        for _ in range(2000):
            _build.call('flash_attention_fwd', 'ptt_stand_in', ())
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts == {**dict.fromkeys(counts, 0),
                      'flash_attention_fwd': 1 + 8 * 2000}
