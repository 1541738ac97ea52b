"""The port's ``serving.autoscaler.FleetAutoscaler`` against the JAX
package's, on the CPU.

The five cases of the reference's ``TestAutoscaler``
(``tests/test_tenancy.py``) run on both packages over the same manual-pump
engines (``feeds['x'] @ I``, buckets (1, 2, 4)): the refused
configurations and their messages, the grow/shrink/cooldown sequence, the
oscillating signal that cannot move the fleet (the doctor's
``autoscale_flap`` quiet on both sides), the grow on a real SLO burn that
``faultinject.burn_ramp`` drives, and the shrink through ``drain`` with
zero aborted requests. Each tick's decision, its evidence and the
``fleet.autoscale.*`` telemetry must be the same on both sides (times
aside). The reference's warm scale-up from a compile cache
(``artifact_dir=``) raises in the port, naming ROADMAP.md Queue 1 item 7.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.observability import doctor as r_doc
from paddle_tpu.resilience import faultinject as r_fi

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import doctor as t_doc
from paddle_tpu_torch.resilience import faultinject as t_fi

from _torch_spines import clean_spines  # noqa: F401  (autouse)

REF = SimpleNamespace(name='ref', serving=rserving, obs=r_obs, doc=r_doc,
                      fi=r_fi, kw={})
PORT = SimpleNamespace(name='port', serving=tserving, obs=t_obs, doc=t_doc,
                       fi=t_fi, kw={'device': 'cpu'})
SIDES = (REF, PORT)


def both(scenario):
    return tuple(scenario(side) for side in SIDES)


def _one():
    return {'x': np.ones((8,), np.float32)}


def _engine(side):
    w = np.eye(8, dtype=np.float32)
    fn = (lambda f: f['x'] @ w) if side is REF else \
        (lambda f, tw=torch.from_numpy(w): f['x'] @ tw)
    eng = side.serving.ServingEngine(queue_capacity=64, **side.kw)
    eng.register('m', predict_fn=fn, example={'x': np.zeros((8,),
                                                            np.float32)},
                 bucket_spec=side.serving.BucketSpec((1, 2, 4)),
                 jit_compile=False)
    return eng


def _fleet(side, n=1):
    router = side.serving.FleetRouter()
    for i in range(n):
        router.add_replica(f'r{i}', _engine(side))
    return router


def _decisions(auto):
    """The decision log without its times."""
    return [{k: v for k, v in d.items() if k != 'ms'}
            for d in auto.decisions()]


def _telemetry(side):
    snap = side.obs.snapshot()
    events = [{k: v for k, v in e.items() if k not in ('ts', 'ms')}
              for e in side.obs.event_log() if e['ev'] == 'fleet.autoscale']
    return ({k: v for k, v in snap['counters'].items()
             if k.startswith('fleet.')},
            {k: v['count'] for k, v in snap['histograms'].items()
             if k.startswith('fleet.')},
            {k: v for k, v in snap['gauges'].items()
             if k.startswith('fleet.')}, events)


def _stop_all(router):
    for h in router.replicas():
        h.engine.stop()


def _refusals(side):
    router = _fleet(side)
    out = []
    for kw in (dict(replica_factory=_engine, burn_low=1.0, burn_high=1.0),
               dict(replica_factory=_engine, min_replicas=0),
               dict(replica_factory=_engine, min_replicas=3,
                    max_replicas=2),
               dict()):
        with pytest.raises(ValueError) as ei:
            side.serving.FleetAutoscaler(router, **kw)
        out.append(str(ei.value))
    return out


def test_degenerate_band_and_envelope_are_rejected():
    ref, port = both(_refusals)
    assert port == ref
    assert 'hysteresis band' in port[0]


def _sequence(side):
    side.obs.enable()
    router = _fleet(side, 1)
    sig = {'v': 5.0}
    auto = side.serving.FleetAutoscaler(
        router, replica_factory=lambda name: _engine(side), min_replicas=1,
        max_replicas=3, burn_high=1.0, burn_low=0.25, sustain_ticks=2,
        cooldown_ticks=2, warmup=False, signal=lambda: sig['v'])
    up = [auto.tick() for _ in range(8)]
    n_up = len(router.replicas())
    sig['v'] = 0.0
    down = [auto.tick() for _ in range(8)]
    out = (up, n_up, down, len(router.replicas()),
           sorted(h.name for h in router.replicas()), _decisions(auto),
           _telemetry(side))
    _stop_all(router)
    return out


def test_grow_shrink_cooldown_sequence():
    ref, port = both(_sequence)
    assert port == ref
    up, n_up, down, n_down, names, decisions, _ = port
    assert up == [None, 'grow', 'cooldown', 'cooldown', 'grow', 'cooldown',
                  'cooldown', None]
    assert down == [None, 'shrink', 'cooldown', 'cooldown', 'shrink',
                    'cooldown', 'cooldown', None]
    assert (n_up, n_down) == (3, 1)
    shrinks = [d for d in decisions if d['action'] == 'shrink']
    assert len(shrinks) == 2 and all(d['aborted'] == 0 for d in shrinks)


def _oscillating(side):
    side.obs.enable()
    router = _fleet(side, 2)
    flip = {'n': 0}

    def sig():
        flip['n'] += 1
        return 5.0 if flip['n'] % 2 else 0.0
    auto = side.serving.FleetAutoscaler(
        router, replica_factory=lambda name: _engine(side), min_replicas=1,
        max_replicas=4, burn_high=1.0, burn_low=0.25, sustain_ticks=2,
        cooldown_ticks=1, warmup=False, signal=sig)
    actions = [auto.tick() for _ in range(12)]
    flaps = list(side.doc.detect_autoscale_flap(
        events=side.obs.event_log(), snapshot=side.obs.snapshot()))
    out = (actions, len(router.replicas()), _decisions(auto), flaps,
           _telemetry(side))
    _stop_all(router)
    return out


def test_oscillating_signal_cannot_flap():
    ref, port = both(_oscillating)
    assert port == ref
    actions, n, decisions, flaps, _ = port
    assert actions == [None] * 12 and n == 2 and not flaps
    assert all(d['action'] == 'steady' for d in decisions)


def _slo_burn(side):
    side.obs.enable()
    router = _fleet(side, 1)
    auto = side.serving.FleetAutoscaler(
        router, replica_factory=lambda name: _engine(side), min_replicas=1,
        max_replicas=2, burn_high=1.0, burn_low=0.25, sustain_ticks=2,
        cooldown_ticks=0, warmup=False)
    side.obs.slo.set_objective('m', 50.0, 0.9)
    achieved = side.fi.burn_ramp('m', burn=3.0, requests=20)
    actions = [auto.tick() for _ in range(3)]
    out = (achieved, actions, len(router.replicas()), _decisions(auto),
           _telemetry(side))
    side.obs.slo.clear_objective('m')
    _stop_all(router)
    return out


def test_grows_on_sustained_slo_burn():
    ref, port = both(_slo_burn)
    assert port == ref
    achieved, actions, n, _, _ = port
    assert achieved >= 1.0 and actions[0] is None and 'grow' in actions
    assert n == 2


def _shrink_drain(side):
    side.obs.enable()
    router = _fleet(side, 2)
    pend = [router.submit('m', _one(), deadline_ms=20000) for _ in range(6)]
    auto = side.serving.FleetAutoscaler(
        router, replica_factory=lambda name: _engine(side), min_replicas=1,
        max_replicas=2, burn_high=1.0, burn_low=0.25, sustain_ticks=1,
        cooldown_ticks=0, warmup=False, signal=lambda: 0.0)
    action = auto.tick()
    for h in router.replicas():
        while h.engine.pump():
            pass
    ok = sum(1 for p in pend if p.result(timeout=10).ok)
    out = (action, [h.name for h in router.replicas()], ok,
           _decisions(auto), _telemetry(side))
    _stop_all(router)
    return out


def test_shrink_drains_in_flight_zero_aborted():
    ref, port = both(_shrink_drain)
    assert port == ref
    action, names, ok, decisions, _ = port
    assert action == 'shrink' and len(names) == 1 and ok == 6
    assert [d['aborted'] for d in decisions if d['action'] == 'shrink'] \
        == [0]


def test_artifact_dir_raises_naming_item_7(tmp_path):
    router = _fleet(PORT, 1)
    for make in (lambda: tserving.FleetAutoscaler(
                     router, replica_factory=lambda n: _engine(PORT),
                     artifact_dir=str(tmp_path)),
                 lambda: tserving.FleetSupervisor(
                     router, lambda n: _engine(PORT),
                     artifact_dir=str(tmp_path))):
        with pytest.raises(NotImplementedError,
                           match=r'artifact_dir=.*Queue 1 item 7'):
            make()
    # without a compile cache the factory runs directly, warmed up
    auto = tserving.FleetAutoscaler(
        router, replica_factory=lambda n: _engine(PORT), sustain_ticks=1,
        cooldown_ticks=0, warmup=True, artifact_dir=None,
        signal=lambda: 5.0)
    assert auto.tick() == 'grow'
    assert router.replica('scale1').breaker.state == 'half_open'
    _stop_all(router)
