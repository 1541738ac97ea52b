"""The serving engine's telemetry in the port against the JAX package's,
on the CPU, and the live endpoint over HTTP.

- The paged runner (``TinyCausalLM``, the reference's numpy draws) with
  the prefix cache, with a draft under page pressure, and under page
  pressure alone: with telemetry on in both packages, the same counters
  and gauges (``serving.kv.*``, ``serving.spec.*``,
  ``serving.preemptions``, ...), the same histogram counts (timings are
  never compared) and the same event kinds.
- Telemetry off registers nothing and records nothing, and the outputs of
  a 2-layer BERT are bit for bit those served with it on.
- A threaded engine with tenants: ``start()``, ``start_endpoint(port=0)``,
  three client threads, then ``/metrics`` parsed against ``stats()``,
  ``/healthz`` with the queue depths, ``/events``, ``/timeseries`` (the
  sampler ``start()`` started), ``/diagnosis`` 501, ``kill()`` and
  ``EngineDeadError``, ``stop()`` leaving no thread and no endpoint; the
  process-wide endpoint from ``PADDLE_TPU_TELEMETRY_HTTP``.
- ``hapi.Model.fit`` / ``evaluate`` and ``engine.fit`` refuse telemetry
  switched on by ``enable()`` (their telemetry is ROADMAP.md Queue 1
  item 4b).
Every HTTP read has a timeout; every engine, server and sampler a test
starts is stopped, and no thread it started outlives it.
"""
import json
import re
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.serving import admission as r_adm

import paddle_tpu_torch as pt
import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import admission as t_adm
from paddle_tpu_torch.text.bert import BertConfig, BertModel

HTTP_TIMEOUT = 5.0
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
    _reset_spines()
    before = set(threading.enumerate())
    yield
    _reset_spines()
    leaked = [t for t in threading.enumerate() if t not in before]
    for t in leaked:
        t.join(2.0)
    assert not [t.name for t in leaked if t.is_alive()]


@pytest.fixture(autouse=True, scope='module')
def _xla_compile_cache(tmp_path_factory):
    """In-module compile dedup for the JAX engines (as
    ``tests/test_paged_serving.py`` does); a fresh tmp directory."""
    d = str(tmp_path_factory.mktemp('xla_cache'))
    jax.config.update('jax_compilation_cache_dir', d)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    yield
    jax.config.update('jax_compilation_cache_dir', None)


def _snap(obs):
    """Counters and gauges, histograms by count; no ``jax.*`` series."""
    s = obs.snapshot()
    return {'counters': {k: v for k, v in s['counters'].items()
                         if not k.startswith('jax.')},
            'gauges': s['gauges'],
            'histograms': {k: v['count'] for k, v in s['histograms'].items()
                           if not k.startswith('jax.')}}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _lm(side, seed=0):
    kw = {'device': 'cpu'} if side is tserving else {}
    return side.TinyCausalLM.random(seed=seed, vocab=32, embed=16,
                                    num_heads=2, max_batch=4, max_seq=32,
                                    prompt_buckets=(4, 8), **kw)


def _traffic(case):
    rs = np.random.RandomState(5)
    if case == 'prefix':
        shared = rs.randint(1, 32, size=8)
        prompts = [np.concatenate([shared, rs.randint(1, 32, size=k)])
                   for k in (1, 3, 5, 2)]
        prompts += [rs.randint(1, 32, size=k) for k in (2, 7, 11)]
        lens = [4, 6, 3, 8, 5, 2, 7]
    else:
        prompts = [np.array([1 + i, 2, 3, 4, 5, 6]) for i in range(4)]
        lens = [10] * 4
    return [p.astype(np.int32) for p in prompts], lens


PAGED_CASES = {
    'prefix': dict(page_size=4),
    'draft_pressure': dict(page_size=4, num_pages=9, max_concurrency=4,
                           prefix_cache=False, draft_k=3),
    'pressure': dict(page_size=4, num_pages=7, max_concurrency=4,
                     prefix_cache=False),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_runner_telemetry_matches_the_reference(case):
    prompts, lens = _traffic(case)
    for obs in (r_obs, t_obs):
        obs.enable()
    got = {}
    for side in (rserving, tserving):
        kw = {'device': 'cpu'} if side is tserving else {}
        eng = side.ServingEngine(queue_capacity=16, **kw)
        reg = dict(PAGED_CASES[case])
        if case == 'draft_pressure':
            reg['draft'] = _lm(side, seed=7)
        ep = eng.register('lm', generative=_lm(side), **reg)
        futs = [ep.submit({'tokens': p}, max_new_tokens=n)
                for p, n in zip(prompts, lens)]
        eng.run_until_idle()
        resps = [f.result(timeout=10) for f in futs]
        obs = OBS[side]
        got[side] = (_snap(obs), sorted(e['ev'] for e in obs.event_log()),
                     [[int(t) for t in r.outputs['tokens']] for r in resps],
                     eng.stats()['models']['lm'])
        if side is tserving:
            assert obs.snapshot()['gauges']['serving.kv.pages_free'] == \
                eng.stats()['kv']['lm']['pages_free']
    assert got[tserving][0] == got[rserving][0]
    assert got[tserving][1] == got[rserving][1]
    assert got[tserving][2] == got[rserving][2]
    snap, st = got[tserving][0]['counters'], got[tserving][3]
    assert snap['serving.completed'] == len(prompts)
    assert snap.get('serving.preemptions', 0) == st['preemptions']
    assert snap.get('serving.spec.proposed', 0) == st['spec_proposed']
    assert snap.get('serving.spec.accepted', 0) == st['spec_accepted']
    assert snap.get('serving.kv.prefix_hit_pages', 0) == \
        st['prefix_hit_pages']
    if case == 'prefix':
        assert st['prefix_hit_pages'] > 0
    else:
        assert st['preemptions'] + st['decode_stalls'] > 0


def _bert_engine(**kw):
    cfg = BertConfig(vocab_size=100, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64)
    torch.manual_seed(3)
    model = BertModel(cfg, device='cpu')
    eng = tserving.ServingEngine(device='cpu', **kw)
    ep = eng.register('bert', layer=model,
                      example={k: np.zeros(16, np.int32)
                               for k in ('input_ids', 'attention_mask')},
                      bucket_spec=tserving.BucketSpec((1, 2, 4)),
                      slo_ms=60_000)
    return eng, ep


def _bert_requests(n):
    rs = np.random.RandomState(9)
    out = []
    for _ in range(n):
        k = rs.randint(1, 17)
        ids = np.zeros(16, np.int32)
        ids[:k] = rs.randint(1, 100, size=k)
        out.append({'input_ids': ids,
                    'attention_mask': (ids > 0).astype(np.int32)})
    return out


def test_telemetry_off_records_nothing_and_changes_no_output():
    reqs = _bert_requests(7)
    outs = {}
    for on in (False, True):
        if on:
            t_obs.enable(sync_every=1)
        eng, ep = _bert_engine()
        futs = [ep.submit(r) for r in reqs]
        eng.run_until_idle()
        outs[on] = [f.result(timeout=10).outputs for f in futs]
        if not on:
            assert t_obs.snapshot() == {'counters': {}, 'gauges': {},
                                        'histograms': {}}
            assert t_obs.event_log() == [] and t_obs.trace_events() == []
    for a, b in zip(outs[False], outs[True]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    snap = t_obs.snapshot()
    assert snap['counters']['serving.batches'] == 2          # 4 + 3
    assert snap['counters']['serving.batch.calls'] == 2
    synced = [e for e in t_obs.trace_events()
              if e['name'] == 'serving.batch' and
              e.get('args', {}).get('synced')]
    assert len(synced) == 2                                  # sync_every 1
    assert 'host_transfer.bytes' not in snap['counters']     # CPU tensors


def _metric(text, name, labels=None):
    """The value of one sample in Prometheus text."""
    lbl = '' if not labels else '{' + ','.join(
        f'{k}="{v}"' for k, v in sorted(labels.items())) + '}'
    pat = '^' + re.escape(f'paddle_tpu_{name}{lbl}') + r' (\S+)$'
    hits = [float(m.group(1)) for m in re.finditer(pat, text, re.M)]
    assert len(hits) == 1, (name, labels, hits)
    return hits[0]


def test_threaded_engine_with_tenants_and_live_endpoint(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_SAMPLE_EVERY', '0.05')
    t_obs.enable()
    now = [0.0]
    arb = t_adm.TenantArbiter(
        [t_adm.TenantPolicy('gold', weight=3),
         t_adm.TenantPolicy('silver'),
         t_adm.TenantPolicy('storm', rate=4, burst=8)],
        clock=lambda: now[0])
    eng, ep = _bert_engine(tenants=arb, queue_capacity=64)
    reqs = _bert_requests(12)
    results = {t: [] for t in ('gold', 'silver', 'storm')}

    def client(tenant, n):
        for i in range(n):
            try:
                results[tenant].append(
                    ep.predict(reqs[i % len(reqs)], tenant=tenant,
                               timeout=30).status)
            except tserving.QuotaExceededError as e:
                results[tenant].append(e.reason)
    eng.start()
    srv = eng.start_endpoint(port=0)
    clients = [threading.Thread(target=client, args=a)
               for a in (('gold', 8), ('silver', 4), ('storm', 12))]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(60)
        assert results['gold'] == ['ok'] * 8
        assert results['silver'] == ['ok'] * 4
        assert results['storm'] == ['ok'] * 8 + ['quota'] * 4
        st = eng.stats()
        code, text = _get(srv.url + '/metrics')
        assert code == 200
        assert _metric(text, 'serving_batches') == \
            st['models']['bert']['batches']
        assert _metric(text, 'serving_completed') == 20
        assert _metric(text, 'serving_shed_quota') == st['shed_quota'] == 4
        assert _metric(text, 'serving_tenant_shed',
                       {'tenant': 'storm'}) == 4
        assert _metric(text, 'serving_tenant_requests',
                       {'tenant': 'gold'}) == 8
        assert _metric(text, 'slo_requests', {'model': 'bert'}) == 20
        assert st['tenants']['ledger']['storm']['shed'] == {'quota': 4}
        assert st['slo_burn'] == {'bert': 0.0}
        code, body = _get(srv.url + '/healthz')
        health = json.loads(body)
        assert code == 200 and health['serving']['worker_alive']
        assert health['serving']['queue_depth'] == {'bert': 0}
        code, body = _get(srv.url + '/events?ev=serving.shed')
        assert [e['tenant'] for e in json.loads(body)] == ['storm'] * 4
        sampler = t_obs.timeseries.active_sampler()
        assert sampler is not None and sampler._thread.is_alive()
        sampler.sample_now()
        code, body = _get(srv.url + '/timeseries?series=serving.completed')
        assert code == 200 and 'counter:serving.completed' in \
            json.loads(body)['series']
        assert _get(srv.url + '/diagnosis')[0] == 501
        eng.kill()
        with pytest.raises(tserving.EngineDeadError):
            ep.submit(reqs[0], tenant='gold')
        assert not eng.alive()
    finally:
        eng.stop()
    assert srv._httpd is None and eng._endpoint is None
    assert not sampler._thread


def test_process_endpoint_from_the_environment(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_HTTP', '0')
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_SAMPLE_EVERY', '0')
    eng, ep = _bert_engine()
    eng.start()          # telemetry off: no endpoint
    eng.stop()
    assert t_obs.endpoint.active_server() is None
    t_obs.enable()
    eng.start()
    try:
        srv = t_obs.endpoint.active_server()
        assert srv is not None and ep.predict(_bert_requests(1)[0],
                                              timeout=10).ok
        code, body = _get(srv.url + '/healthz')
        assert json.loads(body)['serving']['models'] == ['bert']
    finally:
        eng.stop()
    # the stopped engine no longer stands for the process's health
    assert 'serving' not in json.loads(_get(srv.url + '/healthz')[1])


def test_training_refuses_telemetry_switched_on_by_enable():
    t_obs.enable()
    net = torch.nn.Linear(4, 2)
    model = pt.Model(net, device='cpu')
    for call in (lambda: model.fit([(np.zeros(4, np.float32),
                                     np.zeros(2, np.float32))], verbose=0),
                 lambda: model.evaluate([], verbose=0),
                 lambda: tengine.fit(net, lambda *a: None, topt.SGD(), [],
                                     device='cpu')):
        with pytest.raises(NotImplementedError, match='item 4b'):
            call()
