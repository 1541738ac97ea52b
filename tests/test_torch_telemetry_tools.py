"""The port's operator tools (``paddle_tpu_torch/tools/``) against the
reference's (``tools/``), on the CPU.

Each port tool runs by path in a subprocess that never imports torch (the
subprocess reports ``sys.modules``), over the port's own telemetry; the
reference tool runs over the reference's telemetry of the same scenario,
and the two outputs must agree: ``telemetry_dump.py --serving``'s fleet
table (``r0`` and ``r1``), the event table and the Chrome trace,
``doctor.py --fail-on replica_flapping,retry_storm`` (and
``autoscale_flap``), ``postmortem.py`` over a flight dump, and
``perfwatch.py``'s ``compare`` and ``history`` over the same registry.
The doctor's ``replica_flapping``, ``retry_storm`` and ``autoscale_flap``
fire on a real port fleet: a replica killed and relaunched four times,
and an autoscaler driven by a whipsawing signal.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.observability import baseline as r_base
from paddle_tpu.resilience import faultinject as r_fi

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import baseline as t_base
from paddle_tpu_torch.resilience import faultinject as t_fi

from _torch_spines import clean_spines  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
REF = SimpleNamespace(name='ref', serving=rserving, obs=r_obs, fi=r_fi,
                      base=r_base, tools=REPO / 'tools', kw={})
PORT = SimpleNamespace(name='port', serving=tserving, obs=t_obs, fi=t_fi,
                       base=t_base, tools=REPO / 'paddle_tpu_torch' / 'tools',
                       kw={'device': 'cpu'})
SIDES = (REF, PORT)

# runs a tool file as __main__ and reports whether torch got imported
_RUNNER = (
    "import runpy, sys\n"
    "tool = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "code = 0\n"
    "try:\n"
    "    runpy.run_path(tool, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    code = e.code or 0\n"
    "sys.stderr.write('\\nTORCH_IMPORTED %s\\n' % any(\n"
    "    m in ('torch', 'paddle_tpu', 'paddle_tpu_torch') or m.startswith(\n"
    "        ('torch.', 'paddle_tpu.', 'paddle_tpu_torch.'))\n"
    "    for m in sys.modules))\n"
    "sys.exit(code)\n")


def run_tool(side, name, *args, cwd):
    """Run ``side``'s tool ``name`` by path -> (exit code, stdout). The
    port's must not import torch or any package of the repo. A device
    budget in the environment keeps the doctor's ``memory_pressure`` from
    asking a framework for the card's memory (the reference's imports
    jax for it: seconds a run)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'PADDLE_TPU_TELEMETRY')}
    env['PADDLE_TPU_HBM_BUDGET'] = str(80 * 2 ** 30)
    out = subprocess.run(
        [sys.executable, '-c', _RUNNER, str(side.tools / f'{name}.py'),
         *map(str, args)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120)
    assert 'TORCH_IMPORTED' in out.stderr, out.stderr
    if side is PORT:
        assert 'TORCH_IMPORTED False' in out.stderr, out.stderr
    return out.returncode, out.stdout


def _engine(side):
    w = np.eye(8, dtype=np.float32) * 2.0
    fn = (lambda f: f['x'] @ w) if side is REF else \
        (lambda f, tw=torch.from_numpy(w): f['x'] @ tw)
    eng = side.serving.ServingEngine(queue_capacity=64, **side.kw)
    eng.register('m', predict_fn=fn, example={'x': np.zeros(8, np.float32)},
                 bucket_spec=side.serving.BucketSpec((1, 2, 4)),
                 jit_compile=False)
    return eng


def _x(i):
    return {'x': np.full((8,), i, np.float32)}


def _pump_until(racer, engines):
    """Pump the live manual engines until the racing call settles."""
    t0 = time.monotonic()
    while not racer.done.is_set():
        for eng in engines():
            if eng.dispatchable():
                eng.pump()
        assert time.monotonic() - t0 < 20, 'fleet request never settled'
        time.sleep(0.002)
    return racer.join()


def flapping_fleet(side, cycles=4):
    """A real fleet whose replica r0 dies and is relaunched ``cycles``
    times: each cycle parks one request on r1 (so least-queued placement
    picks r0), routes a request onto r0, kills r0, lets the stranded
    request fail over to r1, relaunches r0 through the supervisor and
    closes its circuit with a half-open probe and two more requests.
    Manual-pump engines throughout: the same placements on both sides."""
    pol = side.serving.RouterPolicy(max_retries=2, half_open_probes=1,
                                    circuit_cooldown_s=60.0)
    router = side.serving.FleetRouter(policy=pol)
    for name in ('r0', 'r1'):
        router.add_replica(name, _engine(side))
    sup = side.serving.FleetSupervisor(router, lambda n: _engine(side),
                                       max_restarts=cycles, warmup=True)

    def engines():
        return [h.engine for h in router.replicas()]

    parked = []
    for c in range(cycles):
        parked.append(router.replica('r1').engine.submit('m', _x(-1)))
        p = router.submit('m', _x(c))
        assert p.replicas_tried == ('r0',)
        router.replica('r0').engine.kill()
        racer = side.fi.RacingCall(p.result, timeout=20)
        assert _pump_until(racer, engines).ok
        assert p.replicas_tried == ('r0', 'r1')
        assert sup.check_once() == ['r0']
        for k in range(3):
            parked.append(router.replica('r1').engine.submit('m', _x(-1)))
            q = router.submit('m', _x(10 * c + k))
            racer = side.fi.RacingCall(q.result, timeout=20)
            assert _pump_until(racer, engines).ok
        assert router.replica('r0').breaker.state == 'closed'
    for eng in engines():
        eng.run_until_idle()
    assert all(p.result(timeout=5).ok for p in parked)
    return router


def flapping_autoscaler(side):
    """A real autoscaler whose signal whipsaws slower than its sustain
    window, with no cooldown: grow, shrink, grow, shrink."""
    router = side.serving.FleetRouter()
    router.add_replica('r0', _engine(side))
    sig = iter([5.0, 0.0, 5.0, 0.0])
    auto = side.serving.FleetAutoscaler(
        router, replica_factory=lambda n: _engine(side), min_replicas=1,
        max_replicas=2, sustain_ticks=1, cooldown_ticks=0, warmup=False,
        signal=lambda: next(sig))
    actions = [auto.tick() for _ in range(4)]
    for h in router.replicas():
        h.engine.stop()
    return actions


@pytest.fixture(scope='module')
def telemetry(tmp_path_factory):
    """Each side's events, snapshot and flight dump of one scenario: the
    flapping fleet, then the flapping autoscaler, telemetry on."""
    from _torch_spines import reset_spines
    out = {}
    for side in SIDES:
        reset_spines()
        d = tmp_path_factory.mktemp(side.name)
        side.obs.enable()
        flapping_fleet(side)
        fleet_events = d / 'fleet.jsonl'
        side.obs.dump_jsonl(str(fleet_events))
        fleet_snap = side.obs.snapshot()
        actions = flapping_autoscaler(side)
        events = d / 'events.jsonl'
        side.obs.dump_jsonl(str(events))
        dump = side.obs.flight.dump('fleet_chaos', run_dir=str(d))
        out[side.name] = SimpleNamespace(
            dir=d, fleet_events=fleet_events, fleet_snap=fleet_snap,
            events=events, log=side.obs.event_log(), flight=dump,
            actions=actions)
    reset_spines()
    return out


def test_tools_import_as_package_modules_and_do_nothing():
    import importlib
    for name in ('doctor', 'telemetry_dump', 'postmortem', 'perfwatch'):
        mod = importlib.import_module(f'paddle_tpu_torch.tools.{name}')
        assert callable(mod.main)
    from paddle_tpu_torch.tools import doctor, postmortem, perfwatch
    assert doctor.load_obs_module('doctor').DETECTORS['replica_flapping']
    assert postmortem.load_obs_module('doctor').SEVERITY_ORDER
    assert perfwatch.load_baseline().compare


def test_the_real_fleet_feeds_the_fleet_detectors(telemetry):
    for side in SIDES:
        t = telemetry[side.name]
        diag = {d['cause']: d for d in side.obs.doctor.diagnose(
            events=t.log, snapshot=t.fleet_snap)}
        assert diag['replica_flapping']['evidence']['replica'] == 'r0'
        assert diag['replica_flapping']['evidence']['opens'] == 4
        assert diag['replica_flapping']['evidence']['closes'] == 4
        assert diag['retry_storm']['evidence']['retries'] == 4
        assert diag['retry_storm']['evidence']['offered'] == 16
        assert diag['autoscale_flap']['evidence']['reversals'] == 3
        assert t.actions == ['grow', 'shrink', 'grow', 'shrink']


def _fleet_table(stdout):
    lines = stdout.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith('  fleet:'))
    table = []
    for ln in lines[at:]:
        if ln.startswith('  ') and not ln.startswith('  tenants'):
            table.append(ln)
        else:
            break
    return table


def test_telemetry_dump_serving_renders_the_fleet_table(telemetry, tmp_path):
    got = {}
    for side in SIDES:
        code, out = run_tool(side, 'telemetry_dump',
                             telemetry[side.name].fleet_events, '--serving',
                             cwd=tmp_path)
        assert code == 0
        got[side.name] = out
    table = _fleet_table(got['port'])
    assert table == _fleet_table(got['ref'])
    assert table[0].startswith('  fleet: 16 routed request(s)')
    rows = {ln.split()[0]: ln.split() for ln in table[2:]}
    assert set(rows) == {'r0', 'r1'}
    # dispatched, retried, hedged, hedge-wins, drained, deaths, circuit
    assert rows['r0'][1:] == ['16', '0', '0', '0', '0', '4', 'closed']
    assert rows['r1'][1:] == ['4', '4', '0', '0', '0', '0', 'closed']
    # the lines without times agree too
    strip = re.compile(r'latency p50/p99.*|queue p50/p99.*')
    assert [strip.sub('', ln) for ln in got['port'].splitlines()] == \
        [strip.sub('', ln) for ln in got['ref'].splitlines()]


def test_telemetry_dump_table_and_chrome_trace(telemetry, tmp_path):
    got = {}
    for side in SIDES:
        t = telemetry[side.name]
        code, table = run_tool(side, 'telemetry_dump', t.fleet_events,
                               '--ev', 'serving.router.circuit',
                               cwd=tmp_path)
        assert code == 0
        chrome = tmp_path / f'{side.name}.json'
        code, _ = run_tool(side, 'telemetry_dump', t.fleet_events,
                           '--chrome', chrome, cwd=tmp_path)
        assert code == 0
        trace = json.loads(chrome.read_text())
        got[side.name] = (
            [re.sub(r'^\s*[\d.]+s', '', ln) for ln in table.splitlines()],
            [(e['name'], e['ph']) for e in trace
             if e['name'].startswith(('serving.router', 'fleet.'))])
    assert got['port'] == got['ref']
    assert got['port'][0][-1].startswith('-- 12 event(s)')


def test_doctor_gates_on_the_fleet_detectors(telemetry, tmp_path):
    got = {}
    for side in SIDES:
        t = telemetry[side.name]
        runs = [run_tool(side, 'doctor', t.events, '--fail-on',
                         'replica_flapping,retry_storm', cwd=tmp_path),
                run_tool(side, 'doctor', t.events, '--fail-on',
                         'autoscale_flap', cwd=tmp_path),
                run_tool(side, 'doctor', t.events, '--json', cwd=tmp_path),
                run_tool(side, 'doctor', t.events, '--fail-on',
                         'no_such_cause', cwd=tmp_path)[0]]
        got[side.name] = [
            (code, out.replace(str(t.events), '<log>'))
            if isinstance(code, int) and isinstance(out, str) else code
            for code, out in runs[:3]] + [runs[3]]
    assert got['port'] == got['ref']
    (code1, text), (code2, _), (code3, js), bad = got['port']
    assert (code1, code2, code3, bad) == (1, 1, 0, 2)
    causes = {d['cause'] for d in json.loads(js)}
    assert {'replica_flapping', 'autoscale_flap'} <= causes
    assert 'replica_flapping' in text


def test_postmortem_over_a_flight_dump(telemetry, tmp_path):
    got = {}
    for side in SIDES:
        t = telemetry[side.name]
        code, js = run_tool(side, 'postmortem', t.flight, '--json',
                            cwd=tmp_path)
        code_txt, text = run_tool(side, 'postmortem', t.dir, '--tail', '5',
                                  cwd=tmp_path)
        doc = json.loads(js)
        kinds = [r.get('ev') for r in doc['dump']['records']]
        got[side.name] = (code, code_txt, doc['diagnoses'],
                          [k for k in kinds if k.startswith(
                              ('router.', 'fleet.', 'serving.'))],
                          text.splitlines()[0].split(' pid=')[0])
    assert got['port'] == got['ref']
    assert got['port'][:2] == (0, 0)
    assert 'router.replica_death' in got['port'][3]
    code, text = run_tool(PORT, 'postmortem', telemetry['port'].flight,
                          '--fail-on', 'warning', cwd=tmp_path)
    assert code == 1 and 'kernel_builds' not in text.split('\n')[0]
    assert 'headline counters:' in text


def test_perfwatch_over_the_same_registry(tmp_path):
    got = {}
    for side in SIDES:
        path = tmp_path / f'{side.name}_runs.jsonl'
        for i, p99 in enumerate((10.0, 10.5, 9.8, 10.1, 10.2, 30.0)):
            side.base.record_run(
                {'run': f'r{i}', 'ts': 100.0 + i,
                 'fingerprint': 'bert_large',
                 'metrics': {'serving': {'latency_ms': {'p99': p99}},
                             'qps': 100.0 - i}}, path=str(path))
        got[side.name] = [
            run_tool(side, 'perfwatch', 'compare', '--runs', path,
                     cwd=tmp_path),
            run_tool(side, 'perfwatch', 'compare', '--runs', path,
                     '--fail-on', 'regression', cwd=tmp_path)[0],
            run_tool(side, 'perfwatch', 'history', '--runs', path,
                     cwd=tmp_path),
            run_tool(side, 'perfwatch', 'history', '--runs', path,
                     '--metric', 'serving.latency_ms.p99', cwd=tmp_path)]
        got[side.name][0] = (got[side.name][0][0], got[side.name][0][1]
                             .replace(str(path), '<runs>'))
    assert got['port'] == got['ref']
    assert got['port'][1] == 1
    assert 'REGRESSION serving.latency_ms.p99' in got['port'][0][1]
