"""The port's telemetry spine against the JAX package's, on the CPU.

The same calls go through ``paddle_tpu.observability`` and
``paddle_tpu_torch.observability``: the registry's snapshots and its
Prometheus text (byte for byte, labels and escaping included), events and
Chrome trace events (apart from ``ts``, ``dur``, ``pid`` and ``tid``),
the sampled-sync rule, the SLO tallies and burn rates, the time-series
export. Then what is the port's own: the sync that raises propagates, the
``torch.profiler`` bridge, the kernel-build counters, the flight
recorder's dumps and hooks, and the endpoint over HTTP on port 0 (every
read with a timeout; every server and sampler stopped; no thread left).
"""
import json
import stat
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.observability as r_obs
from paddle_tpu.observability import registry as r_reg
from paddle_tpu.serving import admission as r_adm

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.observability import registry as t_reg
from paddle_tpu_torch.serving import admission as t_adm

HTTP_TIMEOUT = 5.0
SIDES = (r_obs, t_obs)


def _reset_spines():
    for obs in SIDES:
        obs.disable()
        obs.endpoint.stop_active_server()
        obs.timeseries.clear()
        obs.flight.uninstall_crash_hooks()
        obs.reset()
        obs.state._STATE.sync_every = 16
    r_adm.reset_tenant_stats()
    t_adm.reset_tenant_stats()


@pytest.fixture(autouse=True)
def _clean_spines():
    """Both packages' telemetry off and empty before and after each test
    (the reference's state would leak into the next reference test file on
    this worker); every thread a test started is gone when it ends."""
    _reset_spines()
    before = set(threading.enumerate())
    yield
    _reset_spines()
    leaked = [t for t in threading.enumerate() if t not in before]
    for t in leaked:
        t.join(2.0)
    assert not [t.name for t in leaked if t.is_alive()]


def _both_enabled(sync_every=16):
    for obs in SIDES:
        obs.enable(sync_every=sync_every)


def _strip(ev, keys=('ts', 'dur', 'pid', 'tid')):
    return {k: v for k, v in ev.items() if k not in keys}


def _snap(obs):
    """``obs.snapshot()`` without the reference's ``jax.*`` compile
    counters (its enable() counts every XLA compile in the process)."""
    return {kind: {k: v for k, v in d.items() if not k.startswith('jax.')}
            for kind, d in obs.snapshot().items()}


def _drive_registry(reg):
    """One fixed sequence of instrument calls, labels and escapes
    included, through a registry module or instance."""
    rs = np.random.RandomState(3)
    reg.counter('serving.requests').inc()
    reg.counter('serving.requests').inc(4)
    reg.counter('host_transfer.bytes').inc(1 << 20)
    reg.counter('cost.flops').inc(2.5)
    reg.gauge('serving.queue_depth').set(7)
    reg.gauge('serving.kv.page_utilization').set(0.375)
    reg.gauge('serving.models').inc(3)
    reg.gauge('serving.models').dec()
    for tenant in ('gold', 'a"b', 'back\\slash', 'new\nline', 'comma,x'):
        reg.counter('serving.tenant.shed', labels={'tenant': tenant}).inc(2)
        reg.gauge('serving.tenant.burn_rate',
                  labels={'tenant': tenant}).set(1.25)
    h = reg.histogram('serving.latency_ms')
    for v in rs.gamma(2.0, 10.0, size=1500):      # past the reservoir
        h.observe(float(v))
    for m in ('bert', 'gpt'):
        hm = reg.histogram('slo.latency_ms', labels={'model': m})
        for v in rs.uniform(1, 50, size=40):
            hm.observe(v)
    reg.histogram('serving.empty_ms')


def test_registry_snapshot_and_prometheus_are_the_reference_s():
    r, t = r_reg.MetricsRegistry(), t_reg.MetricsRegistry()
    _drive_registry(r)
    _drive_registry(t)
    assert t.snapshot() == r.snapshot()
    assert t.to_prometheus().encode() == r.to_prometheus().encode()
    assert t.to_prometheus(prefix='x') == r.to_prometheus(prefix='x')
    # the module-level singletons: the same text again
    _drive_registry(r_obs)
    _drive_registry(t_obs)
    assert t_obs.snapshot() == r_obs.snapshot()
    assert t_obs.to_prometheus() == r_obs.to_prometheus()
    assert '\\"' in t_obs.to_prometheus() and '\\n' in t_obs.to_prometheus()
    for v in ('a"b', 'x\\y', 'p\nq', 'plain'):
        assert t_reg.escape_label_value(v) == r_reg.escape_label_value(v)


@pytest.mark.parametrize("case", ['kind', 'labels', 'collision',
                                  'label_name', 'negative'])
def test_registry_refusals_are_the_reference_s(case):
    def drive(mod):
        reg = mod.MetricsRegistry()
        if case == 'kind':
            reg.counter('x')
            reg.gauge('x')
        elif case == 'labels':
            reg.counter('x', labels={'a': 1})
            reg.counter('x', labels={'b': 1})
        elif case == 'collision':
            reg.counter('a.b')
            reg.counter('a_b')
            reg.to_prometheus()
        elif case == 'label_name':
            reg.counter('x', labels={'1bad': 1})
        else:
            reg.counter('x').inc(-1)
    errors = []
    for mod in (r_reg, t_reg):
        with pytest.raises((TypeError, ValueError)) as ei:
            drive(mod)
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]


def test_events_spans_and_timers_match_the_reference(tmp_path):
    arrays = {r_obs: jnp.ones(3), t_obs: torch.ones(3)}
    _both_enabled(sync_every=2)
    out = {}
    for obs, arr in arrays.items():
        obs.event('step', step=np.int64(3), loss=np.float32(0.5),
                  tags=['a', 'b'])
        with obs.span('outer', kind='x'):
            with obs.span('inner'):
                pass
        for i in range(5):                      # synced: 1st, 3rd, 5th
            with obs.span('batch', sync=arr, i=i):
                pass
            with obs.timer('serving.batch', sync=lambda a=arr: a, i=i):
                pass
        with obs.span('deferred', sync=lambda: None):
            pass
        obs.async_begin('request', 7, cat='serving.request', model='m')
        obs.async_instant('batch', 7, cat='serving.request', n=2)
        obs.async_end('request', 7, cat='serving.request', status='ok')
        path = tmp_path / f'{obs.__name__}.jsonl'
        n = obs.dump_jsonl(str(path))
        trace = tmp_path / f'{obs.__name__}.json'
        obs.dump_chrome_trace(str(trace))
        out[obs] = {
            'events': [_strip(e) for e in obs.event_log()],
            'jsonl': [_strip(json.loads(line))
                      for line in path.read_text().splitlines()],
            'n': n,
            'trace': [_strip(e) for e in obs.trace_events()],
            'file': [_strip(e) for e in json.loads(trace.read_text())],
            'counters': _snap(obs)['counters'],
            'hist': {k: v['count'] for k, v in
                     _snap(obs)['histograms'].items()},
        }
    assert out[t_obs] == out[r_obs]
    synced = [e.get('args', {}).get('synced', False)
              for e in out[t_obs]['trace']
              if e['name'] == 'batch' and e['ph'] == 'X']
    assert synced == [True, False, True, False, True]
    assert out[t_obs]['counters'] == {'serving.batch.calls': 5}


def test_a_sync_that_raises_propagates_in_the_port_only(monkeypatch):
    _both_enabled()

    def broken():
        raise RuntimeError('CUDA error: an illegal memory access')
    with r_obs.span('s', sync=broken):   # the reference swallows it
        pass
    with pytest.raises(RuntimeError, match='illegal memory'):
        with t_obs.span('s', sync=broken):
            pass

    def broken_wait(value):
        raise RuntimeError('CUDA error: launch failure')
    monkeypatch.setattr(t_obs.spans, 'wait_device', broken_wait)
    with pytest.raises(RuntimeError, match='launch failure'):
        with t_obs.timer('t', sync=torch.ones(2)):
            pass
    # off: the sync is never evaluated, and nothing is recorded
    t_obs.disable()
    with t_obs.span('s', sync=broken):
        pass
    assert t_obs.trace_events() == []


def test_spans_bridge_into_the_torch_profiler_with_telemetry_on_or_off():
    for on in (False, True):
        if on:
            t_obs.enable()
        with torch.profiler.profile() as prof:
            with t_obs.timer('serving.batch'):
                torch.ones(4).sum()
        names = [e.name for e in prof.events()]
        assert 'serving.batch' in names
    with t_obs.span('outside'):
        pass
    assert [e['name'] for e in t_obs.trace_events()] == ['serving.batch',
                                                         'outside']


def test_slo_tallies_and_burn_rates_match_the_reference(monkeypatch):
    rs = np.random.RandomState(5)
    records = [(m, ['ok', 'ok', 'deadline', 'error'][rs.randint(4)],
                float(rs.uniform(1, 120))) for m in ('bert', 'gpt', 'x')
               for _ in range(30)]
    for phase in ('off', 'on'):
        if phase == 'on':
            _both_enabled()
        burns = []
        for obs in SIDES:
            obs.slo.reset()
            obs.slo.set_objective('bert', 50, 0.99)
            obs.slo.set_objective('gpt', 80.0, 0.9)
            burns.append([obs.slo.record(*r) for r in records])
        assert burns[0] == burns[1]
        assert t_obs.slo.burn_rates() == r_obs.slo.burn_rates()
        assert t_obs.slo.tallies() == r_obs.slo.tallies()
    assert _snap(t_obs) == _snap(r_obs)
    assert [_strip(e) for e in t_obs.event_log()] == \
        [_strip(e) for e in r_obs.event_log()]
    monkeypatch.setenv('PADDLE_TPU_SLO_MS', '25')
    monkeypatch.setenv('PADDLE_TPU_SLO_OBJECTIVE', '0.95')
    assert t_obs.slo.objective('y') == r_obs.slo.objective('y')
    assert t_obs.slo.objectives() == r_obs.slo.objectives()
    for obs in SIDES:
        with pytest.raises(ValueError, match='objective'):
            obs.slo.set_objective('z', 10, 1.0)


def test_host_transfers_and_kernel_builds_are_counted(tmp_path, monkeypatch):
    _both_enabled()
    for obs in SIDES:
        obs.record_host_transfer(4096)
        obs.record_host_transfer(100, kind='engine.loss_fetch')
        obs.record_collective('all_reduce', 64)
    assert _snap(t_obs) == _snap(r_obs)
    # a build that runs the compiler (a stand-in nvcc that writes its -o
    # target) is counted; reusing the library counts nothing
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_nvcc', lambda: str(fake))
    assert t_obs.install_build_hooks() and t_obs.install_build_hooks()
    assert _build.build_listeners.count(t_obs.interpose._on_build) == 1
    lib = _build.build()
    assert lib.exists() and _build.build() == lib
    snap = t_obs.snapshot()
    assert snap['counters']['kernels.builds'] == 1
    assert snap['counters']['kernels.build_ms'] > 0
    assert snap['histograms']['kernels.build_duration_ms']['count'] == 1
    summary = t_obs.counters_summary()
    assert summary['kernel_builds'] == 1
    assert summary['host_transfer_bytes'] == 4196
    assert not [k for k in summary if 'jax' in k]
    assert not [k for k in snap['counters'] if k.startswith('jax')]


def test_time_series_export_matches_the_reference():
    _both_enabled()
    docs = {}
    for obs in SIDES:
        sm = obs.timeseries.TimeSeriesSampler(interval=0, capacity=3)
        for step in range(5):                   # two samples evicted
            obs.counter('serving.batches').inc(step)
            obs.gauge('serving.kv.pages_free').set(100 - step)
            obs.histogram('serving.latency_ms').observe(10.0 + step)
            assert sm.sample_now()
        doc = sm.export()
        series = obs.timeseries.to_series(doc)
        docs[obs] = ({**doc, 'samples': [_strip(s) for s in
                                         doc['samples']]},
                     {k: {r: [v for _, v in pts] for r, pts in by.items()}
                      for k, by in series.items()})
    assert docs[t_obs] == docs[r_obs]
    assert docs[t_obs][1]['counter:serving.batches'][0] == [3, 6, 10]
    # the process-wide sampler thread starts and stops
    sm = t_obs.timeseries.start_sampler(interval=0.05)
    assert sm is t_obs.timeseries.active_sampler() and sm._thread.is_alive()
    t_obs.timeseries.stop_sampler()
    assert not sm._thread
    t_obs.disable()
    assert t_obs.timeseries.start_sampler() is None


def test_flight_recorder_dumps_and_chains_its_hooks(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLIGHT_DIR', str(tmp_path))
    fl = t_obs.flight
    fl.record('serving.killed', models=['m'])
    t_obs.enable()
    t_obs.event('serving.shed', reason='quota')
    assert [r['ev'] for r in fl.records()] == ['serving.killed',
                                               'serving.shed']
    path = fl.dump('test', exc=ValueError('boom'))
    doc = fl.load_dump(path)
    assert doc['reason'] == 'test' and doc['exception']['type'] == \
        'ValueError'
    assert 'kernel_builds' in doc['counters'] and 'metrics' in doc
    assert [r['ev'] for r in doc['records']][:2] == ['serving.killed',
                                                     'serving.shed']
    # the thread hook dumps, then calls the hook it replaced
    seen = []
    monkeypatch.setattr(threading, 'excepthook', seen.append)
    assert fl.install_crash_hooks() and fl.install_crash_hooks()

    class Args:
        exc_value = RuntimeError('worker died')
        thread = threading.current_thread()
    threading.excepthook(Args)
    assert seen == [Args]
    assert fl.load_dump(path)['reason'] == 'worker_exception'
    fl.uninstall_crash_hooks()
    assert threading.excepthook == seen.append
    # a hook installed over the recorder's stays when the recorder goes
    fl.install_crash_hooks()
    later = []
    threading.excepthook = later.append
    fl.uninstall_crash_hooks()
    assert threading.excepthook == later.append and not fl.hooks_installed()


def test_endpoint_serves_the_registry_over_http(monkeypatch):
    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    _both_enabled()
    _drive_registry(r_obs)
    _drive_registry(t_obs)
    t_obs.event('serving.shed', reason='quota')
    t_obs.event('serving.request', status='ok')
    srv = t_obs.MetricsServer(port=0, extra_health=lambda: {'serving': 1})
    try:
        srv.start()
        assert srv.port > 0 and srv.host == '127.0.0.1'
        code, body = get(srv.url + '/metrics')
        assert code == 200 and body == srv.render_metrics()
        assert body == r_obs.MetricsServer(port=0).render_metrics()
        code, body = get(srv.url + '/healthz')
        health = json.loads(body)
        assert code == 200 and health['serving'] == 1
        assert health['status'] == 'ok' and health['telemetry_enabled']
        code, body = get(srv.url + '/events?n=1&ev=serving.shed')
        assert [e['reason'] for e in json.loads(body)] == ['quota']
        code, body = get(srv.url + '/timeseries')
        assert code == 200 and json.loads(body) == {'live': None,
                                                    'series': {}}
        for route in ('/diagnosis', '/costs'):
            code, body = get(srv.url + route)
            assert code == 501 and 'Queue 1 item 4b' in body
        assert get(srv.url + '/nope')[0] == 404
    finally:
        srv.stop()
    for call in (lambda: t_obs.MetricsServer(run_dir='/x'),
                 lambda: t_obs.endpoint.maybe_start_from_env(run_dir='/x'),
                 srv.diagnosis, srv.costs):
        with pytest.raises(NotImplementedError, match='item 4b'):
            call()
    # from the environment: one process-wide server, health detachable
    assert t_obs.endpoint.maybe_start_from_env() is None
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_HTTP', '0')
    src = {'a': 1}.copy
    active = t_obs.endpoint.maybe_start_from_env(extra_health=src)
    try:
        assert active is t_obs.endpoint.maybe_start_from_env()
        assert get(active.url + '/healthz')[0] == 200
        t_obs.endpoint.detach_health(src)
        assert active.extra_health is None
    finally:
        t_obs.endpoint.stop_active_server()
    assert t_obs.endpoint.active_server() is None
