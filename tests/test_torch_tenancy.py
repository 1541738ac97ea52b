"""The port's tenancy (``serving.admission``) and its multi-tenant engine
against the JAX package's, on the CPU.

With an injected clock, the same policies and the same calls: the quota
decisions, the deficit-round-robin pop orders (weights 1, 2 and 3, with an
admit gate that declines a head, expired requests, ``push_front`` and
``remove``), ``tenant_stats()`` and ``tenant_burn_rates()``. Then both
engines with ``tenants=`` on two models, the reference's own tenancy
fixture (``tests/test_tenancy.py``: an 8-wide identity ``predict_fn``,
``jit_compile=False``) and a 2-layer BERT at hidden 64 on shared weights:
the same statuses, sheds, cancels and pop order, outputs within
``MODEL_TOL``, the same counters (timing histograms by count only). Then
the port's lifecycle (``cancel``, ``kill``, ``EngineDeadError``, ``stop``
leaving no thread; the flight recorder's SIGTERM hook beside a
``PreemptionGuard`` installed before or after ``start()``), and the paged
runner's put-back of a stalled admission pass under tenancy.
"""
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.observability.timing import Stopwatch as RStopwatch
from paddle_tpu.serving import admission as r_adm
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertModel as JaxBertModel

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.interop import load_paddle_tpu_state
from paddle_tpu_torch.observability.timing import Stopwatch as TStopwatch
from paddle_tpu_torch.resilience import PreemptionGuard
from paddle_tpu_torch.serving import admission as t_adm
from paddle_tpu_torch.text.bert import BertConfig, BertModel

MODEL_TOL = 1e-4
ADM = {rserving: r_adm, tserving: t_adm}
OBS = {rserving: r_obs, tserving: t_obs}


def _reset_spines():
    for obs in (r_obs, t_obs):
        obs.disable()
        obs.endpoint.stop_active_server()
        obs.timeseries.clear()
        obs.flight.uninstall_crash_hooks()
        obs.reset()
    r_adm.reset_tenant_stats()
    t_adm.reset_tenant_stats()


@pytest.fixture(autouse=True)
def _clean_spines():
    """Both packages' telemetry, SLO objectives, tenant ledgers and crash
    hooks reset before and after each test; no thread left behind."""
    _reset_spines()
    before = set(threading.enumerate())
    yield
    _reset_spines()
    leaked = [t for t in threading.enumerate() if t not in before]
    for t in leaked:
        t.join(2.0)
    assert not [t.name for t in leaked if t.is_alive()]


def _snap(obs):
    """``obs.snapshot()`` without the reference's ``jax.*`` counters and
    with each histogram reduced to its count (timings are never
    compared)."""
    s = obs.snapshot()
    return {'counters': {k: v for k, v in s['counters'].items()
                         if not k.startswith('jax.')},
            'gauges': s['gauges'],
            'histograms': {k: v['count'] for k, v in s['histograms'].items()
                           if not k.startswith('jax.')}}


def _policies(adm):
    return [adm.TenantPolicy('gold', weight=3),
            adm.TenantPolicy('silver', weight=1),
            adm.TenantPolicy('storm', weight=1, rate=4, burst=8),
            adm.TenantPolicy('budget', cost_budget_flops=10.0,
                             hbm_budget_bytes=100.0)]


# ---------------------------------------------------------------------------
# admission: quotas, DRR, the ledger
# ---------------------------------------------------------------------------

def test_quota_decisions_match_the_reference():
    now = [0.0]
    arbs = [adm.TenantArbiter(_policies(adm), clock=lambda: now[0])
            for adm in (r_adm, t_adm)]
    rs = np.random.RandomState(2)
    steps = rs.uniform(0.0, 0.1, size=80)
    decisions = [[], []]
    for dt, tenant in zip(steps, rs.choice(['storm', 'gold', 'budget', None],
                                           size=80, p=[0.7, 0.1, 0.1, 0.1])):
        now[0] += float(dt)
        for i, arb in enumerate(arbs):
            try:
                arb.check(tenant, 'm')
                decisions[i].append('ok')
            except Exception as e:
                decisions[i].append((type(e).__name__, e.reason, e.tenant,
                                     e.detail, e.rate, e.burst, str(e)))
            decisions[i].append(arb.tokens('storm'))
    assert decisions[0] == decisions[1]
    assert 'QuotaExceededError' in str(decisions[1])
    for arb in arbs:
        arb.charge('budget', flops=6.0)
        arb.charge('budget', flops=6.0, hbm_bytes=1.0)
    got = []
    for arb in arbs:
        with pytest.raises(Exception) as ei:
            arb.check('budget', 'm')
        got.append((ei.value.detail, arb.spend('budget'), arb.stats(),
                    arb.priority_floor('gold'), arb.weight('nobody')))
    assert got[0] == got[1] and got[1][0] == 'flops'
    for adm in (r_adm, t_adm):
        assert issubclass(adm.QuotaExceededError,
                          {r_adm: rserving, t_adm: tserving}[adm]
                          .QueueFullError)
    for kw in (dict(weight=0), dict(rate=-1), dict(rate=2, burst=0)):
        msgs = []
        for adm in (r_adm, t_adm):
            with pytest.raises(ValueError) as ei:
                adm.TenantPolicy('x', **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


class _Req:
    """A bare queue citizen: tenant, id, liveness."""

    def __init__(self, tenant, rid, sw, dead=False):
        self.tenant, self.id, self.sw, self.dead = tenant, rid, sw, dead
        self.queue_ms = 0.0

    def expired(self):
        return self.dead


@pytest.mark.parametrize("weight", [1, 2, 3])
def test_drr_pop_order_matches_the_reference(weight):
    orders = []
    for adm, sw in ((r_adm, RStopwatch), (t_adm, TStopwatch)):
        arb = adm.TenantArbiter([adm.TenantPolicy('A', weight=weight),
                                 adm.TenantPolicy('B', weight=1),
                                 adm.TenantPolicy('C', weight=2)])
        q = adm.WeightedFairQueue('m', capacity=64, arbiter=arb)
        reqs = []
        rs = np.random.RandomState(weight)
        for i, t in enumerate(rs.choice(['A', 'B', 'C', 'D'], size=36)):
            reqs.append(_Req(str(t), i, sw(), dead=(i % 11 == 5)))
            q.push(reqs[-1])
        asked = {}

        def admit(r):
            # declines request 9 the first two times it heads a pop
            asked[r.id] = asked.get(r.id, 0) + 1
            return not (r.id == 9 and asked[r.id] <= 2)
        log = []
        for n in (3, 5, 4, 4, 7, 2, 8, 8):
            ready, expired = q.pop_ready_while(admit, n)
            log.append(([r.id for r in ready], [r.id for r in expired],
                        q.tenants_queued(), len(q)))
            if len(log) == 2:
                for r in reversed(ready[1:]):      # a stalled pass
                    q.push_front(r)
                log.append(('removed', q.remove(reqs[30]), q.remove(reqs[0])))
        log.append(('drain', [r.id for r in q.drain()]))
        orders.append(log)
    assert orders[0] == orders[1]
    with pytest.raises(tserving.QueueFullError):
        q = t_adm.WeightedFairQueue('m', capacity=1)
        q.push(_Req('A', 0, TStopwatch()))
        q.push(_Req('B', 1, TStopwatch()))


def test_tenant_ledger_matches_the_reference():
    class Done:
        def __init__(self, tenant, model):
            self.tenant, self.model = tenant, model

    rs = np.random.RandomState(4)
    for obs in (r_obs, t_obs):
        obs.enable()
        obs.slo.set_objective('bert', 50.0, 0.99)
    out = []
    for adm, obs in ((r_adm, r_obs), (t_adm, t_obs)):
        rs = np.random.RandomState(4)
        burns = []
        for _ in range(40):
            tenant = str(rs.choice(['gold', 'silver', 'storm', '']))
            model = str(rs.choice(['bert', 'other']))
            if rs.rand() < 0.2:
                adm.record_shed(tenant or None,
                                str(rs.choice(['quota', 'queue_full'])))
                continue
            burns.append(adm.record_completion(
                Done(tenant, model), str(rs.choice(['ok', 'ok', 'error'])),
                float(rs.uniform(1, 90))))
        out.append((burns, adm.tenant_stats(), adm.tenant_burn_rates(),
                    _snap(obs),
                    [{k: v for k, v in e.items() if k != 'ts'}
                     for e in obs.event_log()]))
    assert out[0] == out[1]
    assert set(out[1][1]) == {'gold', 'silver', 'storm', 'default'}


# ---------------------------------------------------------------------------
# the engine with tenants
# ---------------------------------------------------------------------------

def _identity(side, batches):
    """The reference fixture's model (tests/test_tenancy.py: ``feeds['x'] @
    eye(8)``), recording each batch's request numbers (x[:, 0])."""
    w = np.eye(8, dtype=np.float32)
    if side is rserving:
        def predict(feeds):
            batches.append([int(v) for v in np.asarray(feeds['x'])[:, 0]])
            return feeds['x'] @ w
    else:
        tw = torch.from_numpy(w)

        def predict(feeds):
            batches.append([int(v) for v in feeds['x'][:, 0].tolist()])
            return feeds['x'] @ tw
    return predict


def _mix(rs):
    """storm floods first; then gold and silver interleave."""
    order = ['storm'] * 24 + list(rs.permutation(['gold'] * 24 +
                                                 ['silver'] * 8))
    out = []
    for i, tenant in enumerate(order):
        x = rs.standard_normal(8).astype(np.float32)
        x[0] = i + 1                         # the request's number
        out.append((tenant, {'x': x}))
    return out


def _serve_identity(side):
    now = [0.0]
    adm = ADM[side]
    arb = adm.TenantArbiter(_policies(adm), clock=lambda: now[0])
    kw = {'device': 'cpu'} if side is tserving else {}
    eng = side.ServingEngine(queue_capacity=64, tenants=arb, **kw)
    batches = []
    ep = eng.register('m', predict_fn=_identity(side, batches),
                      example={'x': np.zeros((8,), np.float32)},
                      bucket_spec=side.BucketSpec((1, 2, 4)),
                      jit_compile=False, slo_ms=10_000, slo_objective=0.99)
    sheds, futs = [], []
    for tenant, inputs in _mix(np.random.RandomState(0)):
        try:
            futs.append((tenant, inputs, ep.submit(inputs, tenant=tenant)))
        except side.QueueFullError as e:
            sheds.append((tenant, e.reason, type(e).__name__))
    silver = [f for t, _, f in futs if t == 'silver']
    cancelled = [eng.cancel(f) for f in silver[:2]]
    eng.run_until_idle()
    assert not eng.cancel(silver[2])          # already served
    resps = [(t, x, f.result(timeout=10)) for t, x, f in futs]
    return eng, batches, sheds, cancelled, resps


def test_engine_with_tenants_matches_the_reference_identity_model():
    for obs in (r_obs, t_obs):
        obs.enable()
    got = {}
    for side in (rserving, tserving):
        eng, batches, sheds, cancelled, resps = _serve_identity(side)
        st = eng.stats()
        got[side] = dict(
            batches=batches, sheds=sheds, cancelled=cancelled,
            statuses=[(t, r.status) for t, _, r in resps],
            stats={k: st[k] for k in ('submitted', 'shed', 'shed_quota',
                                      'shed_queue_full', 'queue_depth',
                                      'slo_burn', 'tenants')},
            models=st['models']['m'], snap=_snap(OBS[side]),
            events=sorted(e['ev'] for e in OBS[side].event_log()))
        for t, x, r in resps:
            if r.status == 'ok':
                np.testing.assert_allclose(r.outputs, x['x'], atol=MODEL_TOL)
    assert got[tserving] == got[rserving]
    g = got[tserving]
    assert len(g['sheds']) == 16 and g['stats']['shed_quota'] == 16
    assert g['cancelled'] == [True, True]
    assert [s for _, s in g['statuses']].count('cancelled') == 2
    assert g['snap']['counters']['serving.cancelled'] == 2
    # a cancelled request never reaches a batch
    ids = {n for b in g['batches'] for n in b}
    assert len(ids - {0}) == 8 + 24 + 8 - 2


def _bert_pair():
    small = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64)
    paddle.seed(11)
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
    return Serve(ref), port


def test_engine_with_tenants_matches_the_reference_on_bert():
    seq = 16
    layers = dict(zip((rserving, tserving), _bert_pair()))
    rs = np.random.RandomState(7)
    reqs = []
    for tenant in ['storm'] * 10 + ['gold', 'silver', 'gold'] * 3:
        n = rs.randint(1, seq + 1)
        ids = np.zeros(seq, np.int32)
        ids[:n] = rs.randint(1, 100, size=n)
        mask = (ids > 0).astype(np.int32)
        reqs.append((tenant, {'input_ids': ids, 'attention_mask': mask}))
    for obs in (r_obs, t_obs):
        obs.enable()
    got = {}
    for side in (rserving, tserving):
        now = [0.0]
        adm = ADM[side]
        arb = adm.TenantArbiter(_policies(adm), clock=lambda: now[0])
        kw = {'device': 'cpu'} if side is tserving else {}
        eng = side.ServingEngine(queue_capacity=64, tenants=arb, **kw)
        ep = eng.register('bert', layer=layers[side],
                          example={k: np.zeros(seq, np.int32)
                                   for k in ('input_ids', 'attention_mask')},
                          bucket_spec=side.BucketSpec((1, 2, 4)),
                          slo_ms=60_000)
        queue = eng._queues['bert']
        pops, pop = [], queue.pop_ready_while

        def spy(admit, n, pop=pop, pops=pops):
            ready, expired = pop(admit, n)
            pops.append([r.tenant for r in ready])
            return ready, expired
        queue.pop_ready_while = spy
        futs, sheds = [], []
        for i, (tenant, inputs) in enumerate(reqs):
            try:
                futs.append((i, ep.submit(inputs, tenant=tenant)))
            except side.QueueFullError as e:
                sheds.append((i, e.reason))
        eng.run_until_idle()
        resps = [(i, f.result(timeout=60)) for i, f in futs]
        got[side] = (pops, sheds, [(i, r.status) for i, r in resps],
                     eng.stats()['tenants'], _snap(OBS[side]),
                     {i: r.outputs for i, r in resps})
    assert got[tserving][:5] == got[rserving][:5]
    assert len(got[tserving][1]) == 2       # storm: burst 8 of 10
    for i, outs in got[tserving][5].items():
        for a, b in zip(outs, got[rserving][5][i]):
            np.testing.assert_allclose(a, np.asarray(b), atol=MODEL_TOL)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def _port_engine(**kw):
    eng = tserving.ServingEngine(device='cpu', **kw)
    ep = eng.register('m', predict_fn=lambda f: f['x'] * 2,
                      example={'x': np.zeros((4,), np.float32)},
                      bucket_spec=tserving.BucketSpec((1, 2)))
    return eng, ep


def test_cancel_kill_and_engine_dead():
    eng, ep = _port_engine()
    one = {'x': np.ones(4, np.float32)}
    a, b = ep.submit(one), ep.submit(one)
    assert eng.cancel(b) and not eng.cancel(b)
    assert b.result(timeout=5).status == tserving.STATUS_CANCELLED
    assert eng.stats()['queue_depth'] == {'m': 1} and eng.dispatchable()
    eng.run_until_idle()
    assert a.result(timeout=5).ok and not eng.cancel(a)
    eng.start()
    try:
        assert ep.predict(one, timeout=10).ok
        assert eng.alive() and eng.dispatchable()
        eng.kill()
        eng.kill()                                 # idempotent
        assert eng.killed and not eng.alive() and not eng.dispatchable()
        with pytest.raises(tserving.EngineDeadError, match='killed'):
            ep.submit(one)
        assert not eng.pump() and eng.run_until_idle() == 0
        assert t_obs.flight.hooks_installed()
    finally:
        eng.stop()
    assert eng._thread is None and not t_obs.flight.hooks_installed()
    assert eng.stats()['models']['m']['completed'] == 2


@pytest.mark.parametrize("guard_at", ['before_start', 'after_start'])
def test_sigterm_reaches_a_preemption_guard_beside_the_crash_hooks(
        guard_at, tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLIGHT_DIR', str(tmp_path))
    eng, ep = _port_engine()
    guard = PreemptionGuard()
    original = signal.getsignal(signal.SIGTERM)
    try:
        if guard_at == 'before_start':
            guard.install()
        eng.start()
        if guard_at == 'after_start':
            guard.install()
        signal.raise_signal(signal.SIGTERM)
        assert guard.preempted
        assert ep.predict({'x': np.ones(4, np.float32)}, timeout=10).ok
        dumped = t_obs.flight.load_dump(t_obs.flight.dump_path())
        # the crash hook saw the signal only where it was installed last
        assert (dumped is not None and dumped['reason'] == 'sigterm') == \
            (guard_at == 'before_start')
    finally:
        # last in, first out; stop() takes down the hooks start() put in
        if guard_at == 'before_start':
            eng.stop()
            guard.uninstall()
        else:
            guard.uninstall()
            eng.stop()
    assert not t_obs.flight.hooks_installed()
    assert signal.getsignal(signal.SIGTERM) == original


def test_stalled_admission_under_tenancy_loses_nothing():
    """Four 2-page prompts from two tenants on 4 usable pages and 4 rows:
    one pass pops A0, B0, A1, B1 (DRR), A1 stalls. The port puts A1 and B1
    back, each at its tenant's head, and serves all four, each tenant in
    FIFO order. The reference (ROADMAP.md, Queue 3) puts back only A1 and
    loses B1 under tenancy too."""
    prompts = [np.arange(1 + i, 9 + i, dtype=np.int32) for i in range(4)]
    tenants = ['A', 'B', 'A', 'B']
    done, joins = {}, {}
    for side in (rserving, tserving):
        adm = ADM[side]
        arb = adm.TenantArbiter([adm.TenantPolicy('A'),
                                 adm.TenantPolicy('B')])
        kw = {'device': 'cpu'} if side is tserving else {}
        lm = side.TinyCausalLM.random(seed=0, vocab=32, embed=16,
                                      num_heads=2, max_batch=4, max_seq=32,
                                      prompt_buckets=(4, 8), **kw)
        eng = side.ServingEngine(tenants=arb, **kw)
        ep = eng.register('lm', generative=lm, page_size=4, num_pages=5,
                          max_concurrency=4, prefix_cache=False)
        futs = [ep.submit({'tokens': p}, max_new_tokens=2, tenant=t)
                for p, t in zip(prompts, tenants)]
        eng.run_until_idle(max_steps=500)
        done[side] = [f._req.response for f in futs]
        ids = {f._req.id: n for n, f in enumerate(futs)}
        # first joins (a preempted request joins again later)
        joins[side] = list(dict.fromkeys(
            ids[rid] for ev, rid, _ in eng._models['lm'].journal
            if ev == 'join'))
    assert [r is not None for r in done[rserving]] == [True] * 3 + [False]
    assert all(r is not None and r.ok for r in done[tserving])
    for tenant in ('A', 'B'):
        mine = [n for n in joins[tserving] if tenants[n] == tenant]
        assert mine == sorted(mine) and len(mine) == 2
    assert [list(r.outputs['tokens']) for r in done[rserving][:3]] == \
        [list(r.outputs['tokens']) for r in done[tserving][:3]]
