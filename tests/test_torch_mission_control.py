"""Mission control, the port's against the reference's, on the CPU:
``flush`` and ``aggregate``, ``baseline``, every ``doctor`` detector, the
endpoint's ``/diagnosis``, ``/costs`` and run-dir view, and ``hapi``'s
``TelemetryCallback``.

- **flush + aggregate**: the same registry calls in both packages, flushed
  as two ranks by ``RankFlusher`` into a run dir each (the ring sampler
  running), give equal cluster snapshots, merged events, merged traces,
  merged time series and merged files, except what is the process's own
  (host, pid, timestamps, durations, the run dir) and the renamed keys:
  the reference's ``jax_compiles`` / ``jax_traces`` / ``jax_compile_ms``
  are ``kernel_builds`` / ``kernel_build_ms`` (the port counts no trace).
  ``start_rank_flusher`` follows ``PADDLE_TPU_TELEMETRY_RUN_DIR``.
- **baseline**: the same ``runs.jsonl`` gives equal ``detect_regressions``,
  ``compare`` and ``history``.
- **doctor**: for each of the 21 detectors, one synthetic snapshot, event
  stream and cluster view that makes it fire go through both doctors:
  equal causes, severities and evidence (the port's inputs name
  ``kernels.builds`` where the reference's name ``jax.compiles``).
- **endpoint**: ``/diagnosis`` and ``/costs`` over HTTP equal
  ``doctor.diagnose`` and ``costs`` in-process, with the reference's keys;
  ``MetricsServer(run_dir=)`` serves the cluster's series and heartbeats.
- **hapi**: ``Model.fit`` with telemetry on attaches ``TelemetryCallback``
  in both packages: the same ``step`` events (epoch, step, loss within
  1e-5) and event kinds, ``events.jsonl`` and ``trace.json`` written,
  ``diagnosis`` events on both sides (a loader slower than the step:
  ``input_bound`` in the port), and the port's ``evaluate`` emits
  ``eval_result``.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as r_io
from paddle_tpu import nn as r_nn

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as t_io
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.interop import load_paddle_tpu_state

from _torch_spines import SIDES, clean_spines, r_obs, t_obs  # noqa: F401

HTTP_TIMEOUT = 5.0
RENAMED = {'jax_compiles': 'kernel_builds', 'jax_compile_ms':
           'kernel_build_ms', 'jax.compiles': 'kernels.builds',
           'counter:jax.compiles': 'counter:kernels.builds'}
# the reference's keys with no counterpart here (it counts traces too) and
# the port's own (its summary also counts quota sheds)
DROPPED = {'jax_traces', 'serving_shed_quota'}
VOLATILE = {'host', 'pid', 'ts', 'captured_ts', 'run_dir', 'dur', 'tid',
            'path', 'heartbeat_age_s', 'span_s', 'wait_ms', 'duration_ms',
            'uptime_s'}


def _port_name(name):
    return RENAMED.get(name, name)


def _normal(value):
    """``value`` with the renamed keys mapped to the port's names and the
    process's own fields dropped, recursively."""
    if isinstance(value, dict):
        return {_port_name(k) if isinstance(k, str) else k: _normal(v)
                for k, v in value.items()
                if k not in VOLATILE and k not in DROPPED}
    if isinstance(value, list):
        return [_normal(v) for v in value]
    return value


# -- flush + aggregate --------------------------------------------------------

def _drive(obs, rank):
    """Registry calls of one rank: steps, loader waits, a checkpoint, spans,
    events; rank 1 is twice as slow."""
    for i in range(6):
        obs.histogram('hapi.step_ms').observe(10.0 * (rank + 1) + i)
        obs.histogram('dataloader.next_wait_ms').observe(1.0 + i)
        obs.counter('hapi.steps').inc()
        obs.counter('host_transfer.bytes').inc(4)
        obs.event('step', epoch=0, step=i, step_ms=10.0 * (rank + 1) + i)
    obs.gauge('serving.kv.page_utilization').set(0.25 * (rank + 1))
    with obs.span('hapi.epoch', epoch=0):
        pass
    obs.counter('dataloader.quarantined').inc(rank)
    obs.event('checkpoint.save', step=6, bytes=1024, async_=False)


def _flush_two_ranks(obs, run_dir):
    try:
        for rank in (0, 1):
            obs.reset()
            obs.timeseries.clear()
            sampler = obs.timeseries.start_sampler(interval=3600.0)
            sampler.sample_now()
            _drive(obs, rank)
            sampler.sample_now()
            fl = obs.flush.RankFlusher(run_dir, rank=rank)
            assert fl.flush_now() and fl.flushes == 1
    finally:
        obs.timeseries.stop_sampler()
    with open(os.path.join(run_dir, 'hb_0'), 'w'):
        pass
    agg = obs.aggregate
    snap = agg.cluster_snapshot(run_dir)
    merged = agg.merged_timeseries(run_dir)
    for doc in (merged, snap['timeseries']):
        for entry in doc['series'].values():
            for points in entry.values():
                for p in points:
                    p[0] = 0.0        # sample times are the process's own
    written = agg.write_merged(run_dir)
    with open(written['snapshot']) as f:
        on_disk = json.load(f)
    return (_normal(snap), _normal(agg.merged_events(run_dir)),
            _normal(agg.merged_chrome_trace(run_dir)), _normal(merged),
            sorted(os.path.basename(p) for k, p in written.items()
                   if k != 'n_ranks'), written['n_ranks'],
            sorted(on_disk), agg.flight_dumps(run_dir))


def test_flush_and_aggregate_match_reference(tmp_path):
    got = []
    for obs in SIDES:
        obs.enable()
        run_dir = tmp_path / obs.__name__.split('.')[0]
        got.append(_flush_two_ranks(obs, str(run_dir)))
        obs.disable()
    ref, port = got
    assert port == ref
    snap = port[0]
    assert snap['n_ranks'] == 2 and snap['step_ms_skew'] > 1.5
    assert snap['per_rank'][1]['kernel_builds'] == 0
    assert 'kernel_builds' in snap['counters_total']
    assert snap['per_rank'][0]['steps'] == 6
    assert port[4] == ['cluster_snapshot.json', 'merged_events.jsonl',
                       'merged_trace.json']
    head = json.loads((tmp_path / 'paddle_tpu_torch' /
                       'telemetry_rank1.json').read_text())
    assert set(head) == {'rank', 'pid', 'host', 'ts', 'metrics', 'counters',
                         'costs'}


def test_rank_flusher_from_the_environment(tmp_path, monkeypatch):
    """``PADDLE_TPU_TELEMETRY_RUN_DIR`` starts the process-wide flusher and
    its sampler; stopping it makes the last flush."""
    assert t_obs.start_rank_flusher() is None          # telemetry off
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_RUN_DIR', str(tmp_path))
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_FLUSH_EVERY', '3600')
    t_obs.enable()
    fl = t_obs.start_rank_flusher()
    assert fl is t_obs.flush.active_flusher() is t_obs.start_rank_flusher()
    assert fl.run_dir == str(tmp_path) and fl.flushes == 1
    assert t_obs.timeseries.active_sampler() is not None
    t_obs.counter('x').inc(3)
    t_obs.stop_rank_flusher()
    assert t_obs.flush.active_flusher() is None
    head = json.loads((tmp_path / 'telemetry_rank0.json').read_text())
    assert head['metrics']['counters']['x'] == 3
    assert (tmp_path / 'timeseries_rank0.json').exists()


# -- baseline -----------------------------------------------------------------

def test_baseline_regressions_match_reference(tmp_path):
    runs = []
    rs = np.random.RandomState(0)
    for i in range(8):
        last = i == 7
        runs.append({'ts': 1000.0 + i, 'run': f'r{i}', 'fingerprint': 'f',
                     'metrics': {'train.qps': 50.0 if last else
                                 100.0 + rs.rand(),
                                 'serving.latency_ms.p99': 30.0 if last
                                 else 10.0 + rs.rand(),
                                 'mystery': 5.0 if last else 1.0,
                                 'stall_ms': 1.0}})
    got = []
    for obs in SIDES:
        path = str(tmp_path / f'{obs.__name__}.jsonl')
        for rec in runs:
            obs.baseline.record_run(dict(rec), path=path)
        loaded = obs.baseline.load_runs(path)
        got.append((loaded, obs.baseline.detect_regressions(loaded),
                    obs.baseline.compare(loaded),
                    obs.baseline.history(loaded, 'train.qps'),
                    [obs.baseline.bad_direction(m) for m in
                     ('train.qps', 'x_ms', 'mystery')]))
    assert got[1] == got[0]
    regressions = got[1][1]
    assert {r['metric'] for r in regressions} == {
        'train.qps', 'serving.latency_ms.p99'}


# -- doctor -------------------------------------------------------------------

def _timeline(values):
    return {0: [[float(i), float(v)] for i, v in enumerate(values)]}


def _case(name, port, tmp_path):
    """-> (events, snapshot, cluster, cfg) that make detector ``name``
    fire; ``port`` names the inputs as the port counts them."""
    builds = 'kernels.builds' if port else 'jax.compiles'
    row_builds = 'kernel_builds' if port else 'jax_compiles'
    ev, snap, cluster, cfg = [], None, None, {}
    if name == 'straggler':
        cluster = {'per_rank': {r: {'step_ms': {'count': 10, 'mean': m}}
                                for r, m in ((0, 10.0), (1, 10.5),
                                             (2, 31.0))}}
    elif name == 'retrace_storm':
        cluster = {'per_rank': {0: {'steps': 20, row_builds: 18},
                                1: {'steps': 20, row_builds: 1}}}
    elif name == 'input_bound':
        snap = {'histograms': {'dataloader.next_wait_ms': {'sum': 900.0},
                               'hapi.step_ms': {'sum': 1000.0}}}
        ev = [{'ev': 'input_stall', 'wait_ms': 1500.0}]
    elif name == 'serving_overload':
        snap = {'counters': {'serving.requests': 100, 'serving.shed': 24,
                             'serving.shed.page_exhaustion': 4,
                             'serving.deadline_expired': 6}}
    elif name == 'kv_page_exhaustion':
        snap = {'counters': {'serving.shed.page_exhaustion': 3,
                             'serving.kv.decode_stalls': 2,
                             'serving.preemptions': 1},
                'gauges': {'serving.kv.page_utilization': 0.97}}
    elif name == 'rank_flatline':
        cluster = {'heartbeat_age_s': {0: 1.0, 1: 30.0, 2: None}}
    elif name == 'memory_pressure':
        snap = {'gauges': {'cost.peak_bytes{program=engine.train_step0}':
                           9e9}}
        ev = [{'ev': 'cost.program', 'program': 'serve.b16',
               'peak_bytes': 2e9}]
        cfg = {'hbm_budget': int(10e9)}
    elif name == 'slo_burn':
        snap = {'gauges': {'slo.burn_rate{model=bert}': 6.0},
                'counters': {'slo.violations{model=bert}': 12}}
        ev = [{'ev': 'slo.violation', 'model': 'gpt', 'burn_rate': 1.5}]
    elif name == 'checkpoint_stall':
        snap = {'histograms': {
            'checkpoint.save_stall_ms': {'mean': 500.0, 'count': 2},
            'engine.step_ms': {'mean': 200.0, 'count': 20}}}
    elif name == 'elastic_downsize':
        ev = [{'ev': 'elastic.downsize', 'old_world': 4, 'new_world': 3,
               'dead_rank': 2, 'signal': 'SIGKILL'}]
    elif name == 'replica_flapping':
        for _ in range(5):
            ev += [{'ev': 'serving.router.circuit', 'replica': 'r1',
                    'state': 'open', 'reason': 'errors'},
                   {'ev': 'serving.router.circuit', 'replica': 'r1',
                    'state': 'closed'}]
    elif name == 'retry_storm':
        snap = {'counters': {'serving.router.dispatched{replica=a}': 100,
                             'serving.router.retries{replica=a}': 30,
                             'serving.router.hedges{replica=a}': 2}}
    elif name == 'noisy_neighbor':
        snap = {'counters': {'serving.tenant.shed{tenant=storm}': 16,
                             'serving.tenant.shed{tenant=gold}': 1,
                             'serving.tenant.requests{tenant=gold}': 20,
                             'serving.tenant.requests{tenant=storm}': 24}}
        ev = [{'ev': 'serving.request', 'tenant': 'gold', 'status': 'ok',
               'latency_ms': 10.0 + i} for i in range(5)]
    elif name == 'autoscale_flap':
        ev = [{'ev': 'fleet.autoscale', 'action': a, 'tick': 2 * i,
               'cooldown_ticks': 1}
              for i, a in enumerate(('grow', 'shrink') * 3)]
    elif name == 'cold_compile_storm':
        snap = {'counters': {'compilecache.hits': 1,
                             'compilecache.misses': 9, builds: 10},
                'gauges': {'compilecache.entries': 20}}
    elif name == 'lint_debt':
        root = tmp_path / 'tree'
        for pkg in ('paddle_tpu', 'paddle_tpu_torch'):
            (root / pkg).mkdir(parents=True, exist_ok=True)
            (root / pkg / 'm.py').write_text(
                "x = 1  # graftlint: disable=GL001 -- a reason\n")
        (root / 'graftlint.toml').write_text(
            "[graftlint]\nlint_debt_threshold = 1\n\n"
            "[[graftlint.waiver]]\nrule = 'GL008'\n")
        cfg = {'repo_root': str(root)}
    elif name in ('page_leak', 'latency_creep', 'qps_collapse',
                  'compile_creep'):
        series = {
            'page_leak': {'gauge:serving.kv.page_utilization': _timeline(
                [0.2, 0.3, 0.5, 0.7, 0.95]),
                'gauge:serving.active_slots': _timeline([4] * 5)},
            'latency_creep': {'hist:serving.latency_ms:p99': _timeline(
                [10, 11, 12, 20, 25, 30])},
            'qps_collapse': {'counter:serving.requests': _timeline(
                [0, 10, 20, 30, 40, 50, 51, 51, 51])},
            'compile_creep': {f'counter:{builds}': _timeline(
                [5, 5, 5, 5, 5, 9, 12])},
        }[name]
        cluster = {'timeseries': {'series': series}}
    elif name == 'perf_regression':
        path = tmp_path / ('runs_port.jsonl' if port else 'runs_ref.jsonl')
        path.write_text(''.join(
            json.dumps({'ts': float(i), 'metrics': {
                'train.qps': 50.0 if i == 7 else 100.0 + 0.1 * i}}) + '\n'
            for i in range(8)))
        cfg = {'runs_path': str(path)}
    return ev, snap, cluster, cfg


@pytest.mark.parametrize('detector', list(r_obs.doctor.DETECTORS))
def test_doctor_detector_matches_reference(detector, tmp_path):
    assert list(t_obs.doctor.DETECTORS) == list(r_obs.doctor.DETECTORS)
    got = []
    for obs, port in ((r_obs, False), (t_obs, True)):
        ev, snap, cluster, cfg = _case(detector, port, tmp_path)
        out = list(obs.doctor.DETECTORS[detector](
            events=ev, snapshot=snap, cluster=cluster, **cfg))
        got.append([(d['cause'], d['severity'], _normal(d['evidence']))
                    for d in out])
    ref, port = got
    assert port == ref
    assert port and all(cause == detector for cause, _, _ in port)


def test_diagnose_ranks_and_emits_as_the_reference():
    ev = [{'ev': 'elastic.downsize', 'old_world': 2, 'new_world': 1}]
    snap = {'counters': {'serving.requests': 10, 'serving.shed': 5},
            'histograms': {'checkpoint.save_stall_ms': {'mean': 90.0,
                                                        'count': 1},
                           'hapi.step_ms': {'mean': 100.0, 'count': 5}}}
    got = []
    for obs in SIDES:
        obs.enable()
        out = obs.run_doctor(events=ev, snapshot=snap, emit=True)
        got.append(([(d['cause'], d['severity']) for d in out],
                    [(e['cause'], e['severity']) for e in obs.event_log()
                     if e['ev'] == 'diagnosis']))
        assert obs.doctor.render_report([]) == \
            'doctor: no anomalies detected'
    assert got[1] == got[0]
    assert got[1][0] == [('serving_overload', 'critical'),
                         ('checkpoint_stall', 'warning'),
                         ('elastic_downsize', 'info')]
    assert got[1][1] == got[1][0]


# -- endpoint -----------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _costs_and_doctor_inputs(obs):
    obs.costs.record_costs('engine.train_step0', 1e12, 1e10,
                           {'argument_bytes': 9_000_000_000},
                           kind='train_step')
    obs.histogram('checkpoint.save_stall_ms').observe(5000.0)
    for _ in range(3):
        obs.histogram('engine.step_ms').observe(100.0)
    obs.slo.set_objective('bert', 250.0, 0.99)
    obs.slo.record('bert', 'ok', 400.0)


def test_endpoint_diagnosis_costs_and_run_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_HBM_BUDGET', '10e9')
    inproc = []
    for obs in SIDES:
        obs.enable()
        _costs_and_doctor_inputs(obs)
        srv = obs.MetricsServer(port=0)
        inproc.append((srv.diagnosis(), srv.costs()))
        obs.disable()
        obs.reset()
    (r_diag, r_costs), (t_diag, t_costs) = inproc
    assert [(d['cause'], d['severity'], d['evidence']) for d in t_diag] == \
        [(d['cause'], d['severity'], d['evidence']) for d in r_diag]
    assert {d['cause'] for d in t_diag} == {'checkpoint_stall',
                                            'memory_pressure', 'slo_burn'}
    assert sorted(t_costs) == sorted(r_costs) == ['programs', 'slo_burn',
                                                  'summary']
    assert _normal(t_costs) == _normal(r_costs)
    # the port over HTTP, with a run dir
    t_obs.enable()
    _costs_and_doctor_inputs(t_obs)
    run_dir = tmp_path / 'run'
    run_dir.mkdir()
    t_obs.flush.RankFlusher(str(run_dir), rank=3).flush_now()
    (run_dir / 'hb_3').write_text('')
    srv = t_obs.MetricsServer(port=0, run_dir=str(run_dir)).start()
    try:
        code, body = _get(srv.url + '/diagnosis')
        assert code == 200
        assert json.loads(body) == json.loads(json.dumps(
            t_obs.doctor.diagnose(events=t_obs.event_log(),
                                  snapshot=t_obs.snapshot(),
                                  cluster=srv._cluster()),
            sort_keys=True, default=repr))
        code, body = _get(srv.url + '/costs')
        want = {'summary': t_obs.costs.summary(),
                'programs': t_obs.costs.ledger(),
                'slo_burn': t_obs.slo.burn_rates()}
        assert code == 200 and json.loads(body) == json.loads(
            json.dumps(want, sort_keys=True, default=repr))
        code, body = _get(srv.url + '/metrics')
        assert 'paddle_tpu_cluster_kernel_builds{rank="3"' in body
        code, body = _get(srv.url + '/healthz')
        health = json.loads(body)
        assert code == 200 and health['n_ranks'] == 1
        assert health['heartbeat_age_s']['3'] < 60
        code, body = _get(srv.url + '/timeseries')
        assert code == 200 and 'live' in json.loads(body)
    finally:
        srv.stop()
    stale = t_obs.MetricsServer(port=0, run_dir=str(run_dir),
                                stale_after_s=0.0)
    code, payload = stale.health()
    assert code == 503 and payload['stale_ranks'] == [3]
    # from the environment: the run dir rides along
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_HTTP', '0')
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_RUN_DIR', str(run_dir))
    active = t_obs.endpoint.maybe_start_from_env()
    try:
        assert active.run_dir == str(run_dir)
    finally:
        t_obs.endpoint.stop_active_server()


# -- hapi ---------------------------------------------------------------------

N_TRAIN, BATCH, LOADER_SLEEP_S = 32, 4, 0.03


def _samples():
    rs = np.random.RandomState(0)
    x = rs.rand(N_TRAIN, 4).astype(np.float32)
    return list(zip(x, (x.sum(1, keepdims=True) * 0.5).astype(np.float32)))


def _slow(base):
    class Slow(base):
        """Each sample costs ``LOADER_SLEEP_S`` of host time: the loader
        waits longer than the step computes (``input_bound``)."""

        def __init__(self):
            self.samples = _samples()

        def __len__(self):
            return len(self.samples)

        def __getitem__(self, i):
            time.sleep(LOADER_SLEEP_S)
            return self.samples[i]
    return Slow()


def _hapi_fit(obs, log_dir):
    obs.enable(log_dir=str(log_dir))
    if obs is r_obs:
        paddle.seed(7)
        net = r_nn.Sequential(r_nn.Linear(4, 8), r_nn.ReLU(),
                              r_nn.Linear(8, 1))
        init = {k: np.asarray(v) for k, v in net.state_dict().items()}
        model = paddle.Model(net)
        model.prepare(optimizer=paddle.optimizer.Adam(
            learning_rate=0.01, parameters=net.parameters()),
            loss=r_nn.MSELoss(), jit=True)
        data = _slow(r_io.Dataset)
    else:
        net = torch.nn.Sequential(pt.nn.Linear(4, 8, device='cpu'),
                                  torch.nn.ReLU(),
                                  pt.nn.Linear(8, 1, device='cpu'))
        load_paddle_tpu_state(net, _hapi_fit.init)
        init = None
        model = pt.Model(net, device='cpu')
        model.prepare(optimizer=t_opt.Adam(learning_rate=0.01,
                                           parameters=net.parameters()),
                      loss=torch.nn.functional.mse_loss, jit=True)
        data = _slow(t_io.Dataset)
    model.fit(data, batch_size=BATCH, epochs=2, shuffle=False, verbose=0,
              log_freq=1)
    return model, init, data


@pytest.fixture
def warm_capture():
    """The first cost capture in a process imports ``torch._dynamo`` (~1.5
    s on a CPU), which would make the port's first step outweigh the
    loader's sleeps; a capture of a small product first."""
    t_obs.enable()
    t_obs.costs.capture('warm', torch.mm, torch.ones(2, 2), torch.ones(2, 2))
    t_obs.disable()
    t_obs.reset()


def test_hapi_fit_attaches_the_callback_as_the_reference(tmp_path,
                                                         warm_capture):
    """Both sides end with ``diagnosis`` events. The port's is
    ``input_bound`` (the loader's 30 ms a sample against steps of a few
    ms). The reference's are ``input_bound`` unless its first step's
    compiles outlast the loader's 1.9 s, and ``retrace_storm`` when the
    process had not compiled its feeds' ops before (its own XLA compiles
    count): which of the two depends on the process, so the test holds
    them to that catalog only."""
    got = []
    for obs in SIDES:
        d = tmp_path / obs.__name__.split('.')[0]
        model, init, data = _hapi_fit(obs, d)
        if init is not None:
            _hapi_fit.init = init
        steps = [e for e in obs.event_log() if e['ev'] == 'step']
        kinds = [e['ev'] for e in obs.event_log()]
        files = sorted(os.listdir(d))
        diag = [e['cause'] for e in obs.event_log()
                if e['ev'] == 'diagnosis']
        snap = obs.snapshot()
        got.append((steps, kinds, files, diag,
                    snap['counters'].get('hapi.steps'),
                    snap['histograms']['hapi.step_ms']['count']))
        if obs is t_obs:
            logs = model.evaluate(data, batch_size=BATCH, verbose=0)
            (ev,) = [e for e in obs.event_log() if e['ev'] == 'eval_result']
            assert ev['loss'] == logs['loss']
        obs.disable()
    ref, port = got
    assert len(port[0]) == len(ref[0]) == 2 * N_TRAIN // BATCH
    for a, b in zip(port[0], ref[0]):
        assert (a['epoch'], a['step']) == (b['epoch'], b['step'])
        np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-5)
    assert port[1] == [k for k in ref[1] if k != 'diagnosis'] + \
        ['diagnosis'] * len(port[3])
    assert port[1][0] == 'train_begin' and 'train_end' in port[1]
    assert {'events.jsonl', 'trace.json'} <= set(port[2])
    assert port[3] == ['input_bound']
    assert ref[3] and set(ref[3]) <= {'input_bound', 'retrace_storm'}
    assert port[4:] == ref[4:] == (16, 16)
    written = [json.loads(line) for line in
               (tmp_path / 'paddle_tpu_torch' / 'events.jsonl')
               .read_text().splitlines()]
    assert [e['ev'] for e in written] == port[1]
