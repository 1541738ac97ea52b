"""The port's chaos harness (``resilience.faultinject``) and the
supervisor's liveness primitives (``watchdog.Heartbeat``,
``heartbeat_age``) against the JAX package's, on the CPU.

Every ported injector runs beside the reference's on the same inputs: the
write faults on each package's ``atomic_io`` seams (the same exceptions,
the same destinations left intact, the same trigger counts), the same
bytes flipped and truncated, the wrappers' call counts and the indices at
which they poison, hang or leave a worker alive, the signal-driven
preemption models, the replica injectors on each package's engine, the
same ``tenant_storm`` bursts and shed tallies for a seed, the same
``burn_ramp`` burn rates, and ``hold_lock`` with ``RacingCall``. The four
injectors of subsystems the port does not have yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
import os
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.observability as r_obs
from paddle_tpu import serving as rserving
from paddle_tpu.resilience import atomic_io as r_io
from paddle_tpu.resilience import faultinject as r_fi
from paddle_tpu.resilience import watchdog as r_wd

import paddle_tpu_torch.observability as t_obs
from paddle_tpu_torch import resilience as t_res
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.resilience import atomic_io as t_io
from paddle_tpu_torch.resilience import faultinject as t_fi
from paddle_tpu_torch.resilience import watchdog as t_wd

from _torch_spines import clean_spines  # noqa: F401  (autouse)

REF = SimpleNamespace(name='ref', fi=r_fi, io=r_io, wd=r_wd, obs=r_obs,
                      serving=rserving, kw={})
PORT = SimpleNamespace(name='port', fi=t_fi, io=t_io, wd=t_wd, obs=t_obs,
                       serving=tserving, kw={'device': 'cpu'})
SIDES = (REF, PORT)


def both(scenario, *args):
    return tuple(scenario(side, *args) for side in SIDES)


def test_port_module_and_exports():
    assert t_res.faultinject is t_fi
    assert t_res.Heartbeat is t_wd.Heartbeat
    assert t_res.heartbeat_age is t_wd.heartbeat_age
    assert sorted(t_fi.__all__) == sorted(r_fi.__all__)


# ---------------------------------------------------------------------------
# write faults on the atomic_io seams
# ---------------------------------------------------------------------------

def _write_fault(side, root, arm):
    d = root / side.name
    d.mkdir()
    dest = d / 'model.pdparams'
    side.io.atomic_write(str(dest), b'committed')
    fi = side.fi.FaultInjector()
    out = []
    with fi:
        arm(fi)
        for i in range(3):
            try:
                side.io.atomic_write(str(dest), b'x' * 64 * (i + 1))
                out.append('ok')
            except OSError as e:
                out.append((type(e).__name__, getattr(e, 'errno', None),
                            str(e).replace(str(d), '<dir>')))
            out.append(dest.read_bytes())
    out += [fi.triggered, sorted(os.listdir(d))]
    assert side.io._fault_hook is None and side.io._stream_hook is None
    return out


@pytest.mark.parametrize("arm", [
    lambda fi: fi.fail_writes(times=2, match='model'),
    lambda fi: fi.fail_writes(times=1, stage='replace'),
    lambda fi: fi.fail_writes(times=1, match='optimizer'),
    lambda fi: fi.disk_full(after_bytes=100, times=1),
    lambda fi: fi.slow_fs(0.001, match='model'),
], ids=['fail_writes', 'fail_replace', 'no_match', 'disk_full', 'slow_fs'])
def test_write_faults_match_the_reference(arm, tmp_path):
    ref, port = both(_write_fault, tmp_path, arm)
    assert port == ref


def _context_faults(side, root):
    d = root / side.name
    d.mkdir()
    dest = str(d / 'ckpt.bin')
    out = []
    with side.fi.disk_full(after_bytes=0, match='ckpt') as fi:
        with pytest.raises(OSError) as ei:
            side.io.atomic_write(dest, b'abc')
        out += [ei.value.errno, fi.triggered, os.path.exists(dest)]
    t0 = time.monotonic()
    with side.fi.slow_fs(0.02):
        side.io.atomic_write(dest, b'abc')
    out += [time.monotonic() - t0 >= 0.02, open(dest, 'rb').read()]
    return out


def test_disk_full_and_slow_fs_contexts(tmp_path):
    ref, port = both(_context_faults, tmp_path)
    assert port == ref


def _bytes_faults(side, root, op, kw):
    path = root / f'{side.name}.bin'
    path.write_bytes(bytes(range(64)))
    assert getattr(side.fi, op)(str(path), **kw) == str(path)
    return path.read_bytes()


@pytest.mark.parametrize("op, kw", [
    ('corrupt_file', {}), ('corrupt_file', dict(offset=10, nbytes=5)),
    ('corrupt_file', dict(offset=-3, nbytes=8)),
    ('truncate_file', {}), ('truncate_file', dict(keep_bytes=7)),
    ('truncate_file', dict(drop_bytes=5)),
])
def test_corrupt_and_truncate_same_bytes(op, kw, tmp_path):
    ref, port = both(_bytes_faults, tmp_path, op, kw)
    assert port == ref
    assert port != bytes(range(64))


# ---------------------------------------------------------------------------
# callable and dataset wrappers
# ---------------------------------------------------------------------------

def _flaky(side):
    f = side.fi.flaky(lambda x: x + 1, fail_times=2)
    out = []
    for i in range(4):
        try:
            out.append(f(i))
        except ConnectionError as e:
            out.append(str(e))
    g = side.fi.flaky(lambda: 'ok', fail_times=1,
                      exc_factory=lambda n: KeyError(f'call {n}'))
    with pytest.raises(KeyError):
        g()
    return out, dict(f.state), g(), dict(g.state)


def test_flaky():
    ref, port = both(_flaky)
    assert port == ref


def test_poison_loss_matches_the_reference():
    import jax.numpy as jnp
    got = []
    for fi, make in ((r_fi, jnp.asarray), (t_fi, torch.tensor)):
        loss = fi.poison_loss(lambda v: make(v) * 2.0, at_steps=[1, 3])
        vals = [loss(float(i)) for i in range(5)]
        got.append(([bool(np.isnan(np.asarray(v))) for v in vals],
                    dict(loss.state)))
    assert got[1] == got[0] == ([False, True, False, True, False],
                                {'calls': 5})


class _Data:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return i * 10


def _datasets(side, root):
    ds = _Data()
    out = []
    poisoned = side.fi.poison_sample(ds, [1, 4])
    for i in range(len(poisoned)):
        try:
            out.append(poisoned[i])
        except side.fi.PoisonedSampleError as e:
            out.append(str(e))
    # the process that made the wrapper (a threaded loader) is never shot,
    # marker or not
    killer = side.fi.kill_worker(ds, 2, str(root / f'{side.name}.once'))
    side_thread = []
    t = threading.Thread(target=lambda: side_thread.append(killer[2]))
    t.start()
    t.join(5)
    out += [killer[2], side_thread,
            os.path.exists(root / f'{side.name}.once')]
    hang = side.fi.hang_worker(ds, 3, hang_s=0.05)
    t0 = time.monotonic()
    out += [hang[2], hang[3], time.monotonic() - t0 >= 0.05]
    slow = side.fi.slow_loader(ds, 0.01)
    t0 = time.monotonic()
    out += [[slow[i] for i in range(len(slow))],
            time.monotonic() - t0 >= 0.06]
    return out


def test_dataset_wrappers(tmp_path):
    ref, port = both(_datasets, tmp_path)
    assert port == ref


def _timing_wrappers(side, monkeypatch):
    out = []
    for rank in ('0', '1'):
        monkeypatch.setenv('PADDLE_TRAINER_ID', rank)
        f = side.fi.slow_rank(lambda a, b=1: a + b, rank=1, delay_s=0.05)
        t0 = time.monotonic()
        out += [f(2, b=3), time.monotonic() - t0 >= 0.05]
    sm = side.fi.slow_model(lambda x: x * 3, 0.02)
    t0 = time.monotonic()
    out += [sm(4), time.monotonic() - t0 >= 0.02]
    ramp = side.fi.latency_ramp(lambda: 'v', per_call_ms=10, start_ms=5)
    waits = []
    for _ in range(3):
        t0 = time.monotonic()
        ramp()
        waits.append(time.monotonic() - t0)
    out += [ramp.calls, [w >= (5 + 10 * k) / 1e3 for k, w in
                         enumerate(waits)]]
    return out


def test_slow_rank_model_and_latency_ramp(monkeypatch):
    ref = _timing_wrappers(REF, monkeypatch)
    port = _timing_wrappers(PORT, monkeypatch)
    assert port == ref
    assert port[:4] == [5, False, 5, True]


# ---------------------------------------------------------------------------
# preemption and rank death
# ---------------------------------------------------------------------------

@pytest.fixture
def sigterms():
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    yield got
    signal.signal(signal.SIGTERM, prev)


def _sigterm_iter(side, sigterms):
    del sigterms[:]
    it = side.fi.sigterm_at_step(range(5), at_step=2)
    seen = []
    for item in it:
        seen.append((item, len(sigterms)))
    return seen, dict(it.state)


def test_sigterm_at_step(sigterms):
    ref, port = both(_sigterm_iter, sigterms)
    assert port == ref
    assert port[0] == [(0, 0), (1, 0), (2, 1), (3, 1), (4, 1)]


def _rank_death(side, root, monkeypatch):
    once = root / f'{side.name}.once'
    monkeypatch.setenv('PADDLE_TRAINER_ID', '0')
    # another rank's death, and a step that is not the one armed: nothing
    side.fi.kill_rank_at_step(3, str(once), rank=1)(3)
    die = side.fi.kill_rank_at_step(3, str(once))
    die(2)
    # the marker of an earlier generation: the relaunched rank survives
    once.write_bytes(b'')
    die(3)
    return 'alive'


def test_kill_rank_at_step_spares_other_ranks_and_relaunches(
        tmp_path, monkeypatch):
    assert _rank_death(REF, tmp_path, monkeypatch) == \
        _rank_death(PORT, tmp_path, monkeypatch) == 'alive'


def test_preempt_at_step_is_a_port_callback(sigterms):
    cb = t_fi.PreemptAtStep(2)
    assert isinstance(cb, Callback)
    fired = []
    for step in range(5):
        cb.on_train_batch_end(step)
        fired.append(len(sigterms))
    ref = r_fi.PreemptAtStep(2)
    want = []
    for step in range(5):
        ref.on_train_batch_end(step)
        want.append(len(sigterms) - fired[-1])
    assert fired == want == [0, 0, 1, 1, 1]
    assert cb.fired and cb.seen == 5


# ---------------------------------------------------------------------------
# the replica injectors
# ---------------------------------------------------------------------------

def _engine(side):
    w = np.eye(4, dtype=np.float32)
    fn = (lambda f: f['x'] @ w) if side is REF else \
        (lambda f, tw=torch.from_numpy(w): f['x'] @ tw)
    eng = side.serving.ServingEngine(queue_capacity=8, **side.kw)
    eng.register('m', predict_fn=fn, example={'x': np.zeros(4, np.float32)},
                 bucket_spec=side.serving.BucketSpec((1, 2)),
                 jit_compile=False)
    return eng


def _replicas(side):
    one = {'x': np.ones(4, np.float32)}
    out = []
    with pytest.raises(ValueError, match='1-indexed'):
        side.fi.kill_replica_at_request(_engine(side), 0)
    eng = side.fi.kill_replica_at_request(_engine(side), at_request=2)
    a = eng.submit('m', one)
    out.append(eng.dispatchable())
    b = eng.submit('m', one)
    out += [eng.dispatchable(), eng.killed]
    with pytest.raises(side.serving.EngineDeadError):
        eng.submit('m', one)
    out += [eng.queued_count(), a.done(), b.done()]
    eng.stop()
    for stranded in (a, b):
        with pytest.raises(RuntimeError, match='engine stopped before'):
            stranded.result(timeout=5)
    hung = _engine(side)
    hang = side.fi.hang_replica(hung)
    p = hung.submit('m', one)
    out += [hung.pump(), hung.queued_count(), p.done()]
    hang.release()
    out += [hang.released, hung.pump(), p.result(timeout=5).ok]
    slow = side.fi.slow_replica(_engine(side), delay_s=0.03)
    q = slow.submit('m', one)
    t0 = time.monotonic()
    out += [slow.pump(), time.monotonic() - t0 >= 0.03,
            q.result(timeout=5).ok]
    return out


def test_replica_injectors():
    ref, port = both(_replicas)
    assert port == ref
    assert port[:3] == [True, False, True]


# ---------------------------------------------------------------------------
# tenant storms, burn ramps
# ---------------------------------------------------------------------------

def _storm(side, seed):
    adm = side.serving
    arb = adm.TenantArbiter([adm.TenantPolicy('storm', rate=4, burst=6)],
                            clock=lambda: 0.0)
    eng = side.serving.ServingEngine(queue_capacity=20, tenants=arb,
                                     **side.kw)
    w = np.eye(4, dtype=np.float32)
    eng.register('m', predict_fn=(lambda f: f['x'] @ w) if side is REF
                 else (lambda f, tw=torch.from_numpy(w): f['x'] @ tw),
                 example={'x': np.zeros(4, np.float32)},
                 bucket_spec=side.serving.BucketSpec((1, 2, 4)),
                 jit_compile=False)
    one = {'x': np.ones(4, np.float32)}
    quota = side.fi.tenant_storm(eng, 'm', one, tenant='storm', qps=5.0,
                                 duration_ticks=6, seed=seed)
    eng.run_until_idle()
    ok = sum(p.result(timeout=5).ok for p in quota['pending'])
    # untenanted traffic past the queue's capacity sheds as queue_full
    full = side.fi.tenant_storm(eng, 'm', one, tenant=None, qps=30.0,
                                duration_ticks=1, seed=seed)
    eng.run_until_idle()
    eng.stop()
    return ({k: v for k, v in quota.items() if k != 'pending'}, ok,
            {k: v for k, v in full.items() if k != 'pending'})


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_tenant_storm_same_bursts_and_sheds(seed):
    ref, port = both(_storm, seed)
    assert port == ref
    quota, ok, full = port
    assert quota['shed'] == {'quota': quota['attempts'] - 6} and ok == 6
    assert full['shed'].get('queue_full', 0) > 0


def _burns(side):
    out = []
    for i, (burn, requests, objective) in enumerate(
            ((2.0, 20, 0.9), (3.0, 20, 0.9), (0.5, 40, 0.95),
             (10.0, 10, 0.5), (0.0, 5, 0.9))):
        model = f'm{i}'
        if i == 1:
            side.obs.slo.set_objective(model, 80.0, 0.8)
        out.append(side.fi.burn_ramp(model, burn=burn, requests=requests,
                                     target_ms=50.0, objective=objective))
    return out, side.obs.slo.burn_rates(), side.obs.slo.tallies()


def test_burn_ramp_same_rates():
    ref, port = both(_burns)
    assert port == ref
    assert port[0][0] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# forced interleavings
# ---------------------------------------------------------------------------

def _race(side):
    lock = threading.Lock()
    box = []

    def writer(v):
        with lock:
            box.append(v)
        return v * 2
    with side.fi.hold_lock(lock) as held:
        racer = side.fi.RacingCall(writer, 21)
        out = [held is lock, racer.blocked(0.05), list(box),
               racer.done.is_set()]
    out += [racer.join(), list(box), racer.done.is_set(), lock.locked()]
    bad = side.fi.RacingCall(lambda: {}['missing'])
    with pytest.raises(KeyError):
        bad.join()
    out.append(type(bad.error).__name__)
    return out


def test_hold_lock_and_racing_call():
    ref, port = both(_race)
    assert port == ref == [True, True, [], False, 42, [21], True, False,
                           'KeyError']


# ---------------------------------------------------------------------------
# refusals and liveness
# ---------------------------------------------------------------------------

def _slow_collective(fi, deadline, run):
    """``slow_collective`` against a 0.05 s deadline: an all-reduce
    delayed 0.3 s expires naming its op, one not in ``ops`` does not, and
    the hook goes at the context's end."""
    prev = deadline.set_timeout(0.05)
    out = []
    try:
        with fi.slow_collective(0.3, ops=['all_reduce']):
            try:
                run(deadline, 'all_reduce')
                out.append('completed')
            except deadline.DistributedTimeoutError as e:
                out += [e.op, e.timeout, 'all_reduce' in str(e)]
            t0 = time.monotonic()
            run(deadline, 'all_gather')
            out.append(time.monotonic() - t0 < 0.2)
        out.append(deadline._delay_hook[0] is None)
    finally:
        deadline.set_timeout(prev)
    return out


def _boot_fail(fi):
    key = 'PADDLE_TPU_FI_BOOT_FAIL'
    with fi.boot_fail(1, times=2):
        inside = os.environ.get(key)
    return [inside, os.environ.get(key)]


@pytest.mark.parametrize("call, item", [
    (lambda: t_fi.corrupt_compile_cache('cache'), 'item 7'),
    (lambda: t_fi.retrace_bait(4), 'item 7'),
    (None, 'slow_collective'),
    (None, 'boot_fail'),
], ids=['corrupt_compile_cache', 'retrace_bait', 'slow_collective',
        'boot_fail'])
def test_unported_injectors_raise_naming_their_item(call, item):
    """``compilecache/``'s injectors still wait (item 7).
    ``slow_collective`` and ``boot_fail`` are ported with distributed/:
    each behaves as the reference's (their end-to-end effect on spawned
    ranks: tests/test_torch_spawn.py and test_torch_collectives.py)."""
    if call is not None:
        with pytest.raises(NotImplementedError,
                           match=f'ROADMAP.md, Queue 1 {item}'):
            call()
        return
    from paddle_tpu.distributed import deadline as r_deadline
    from paddle_tpu_torch.distributed import deadline as t_deadline
    if item == 'boot_fail':
        assert _boot_fail(t_fi) == _boot_fail(r_fi) == ['1:2', None]
        return
    ref = _slow_collective(
        r_fi, r_deadline,
        lambda d, op: d.run_with_deadline(op, lambda: None))
    port = _slow_collective(
        t_fi, t_deadline,
        lambda d, op: d.run_with_deadline(op, lambda async_op: None))
    assert port == ref == ['all_reduce', 0.05, True, True, True]


def _heartbeat(side, root):
    path = root / f'hb_{side.name}'
    out = [side.wd.heartbeat_age(str(path))]
    hb = side.wd.Heartbeat(str(path), interval=0.02).start()
    assert hb.start() is hb
    time.sleep(0.06)
    age = side.wd.heartbeat_age(str(path))
    hb.stop()
    out += [0.0 <= age < 1.0, hb._thread, path.exists()]
    return out


def test_heartbeat_and_its_age(tmp_path):
    ref, port = both(_heartbeat, tmp_path)
    assert port == ref == [None, True, None, True]
