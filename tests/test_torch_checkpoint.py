"""``paddle_tpu_torch.resilience`` (``CheckpointManager``, ``atomic_io``,
``async_checkpoint``, ``PreemptionGuard``, ``capture_rng``, ``retry``,
``watchdog``) and ``paddle_tpu_torch.framework.save`` / ``load``, on the
CPU: rotation, the fallback past a truncated or bit-flipped checkpoint, a
crash between a payload and its manifest, async ordering and failures,
per-rank shards behind rank 0's bounded barrier, bf16 bit for bit; and,
across the packages, each one's ``load_sharded`` reading a format-2
directory the other wrote, with identical numpy leaves and meta.

Faults are injected through ``atomic_io``'s two seams (``_fault_hook``
at the commit stages, ``_stream_hook`` before every staged write), each
put back by the ``hooks`` fixture; every wait has a deadline. One test
records a reference fault (ROADMAP.md, Queue 3): its bf16 leaves do not
survive its own round trip."""
import os
import signal
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.resilience import async_checkpoint as ref_ac
from paddle_tpu_torch import framework
from paddle_tpu_torch.kernels.philox import DropoutState
from paddle_tpu_torch.resilience import (AtomicWriteError, CheckpointManager,
                                         PreemptionGuard, RetryError,
                                         WatchdogTimeout, atomic_io,
                                         bounded_get, capture_rng,
                                         join_thread, restore_rng, retry)
from paddle_tpu_torch.resilience import async_checkpoint as ac


@pytest.fixture
def hooks():
    """Set ``atomic_io``'s fault seams; both are None again afterwards."""
    class Hooks:
        def fail_after(self, match, after_bytes=64):
            def hook(path, done, n):
                if match in os.path.basename(path) and done >= after_bytes:
                    raise OSError(28, 'No space left on device (injected)')
            atomic_io._stream_hook = hook

        def slow(self, match, seconds):
            def hook(path, done, n):
                if match in path:
                    time.sleep(seconds)
            atomic_io._stream_hook = hook

        def fail_stage(self, stage, match):
            def hook(st, path):
                if st == stage and match in os.path.basename(path):
                    raise OSError(5, 'I/O error (injected)')
            atomic_io._fault_hook = hook
    try:
        yield Hooks()
    finally:
        atomic_io._stream_hook = None
        atomic_io._fault_hook = None


def _state(seed=0, n=3):
    g = torch.Generator().manual_seed(seed)
    return {'params': {f'w{i}': torch.randn(64, 16, generator=g)
                       for i in range(n)},
            'opt': {'w0': {'moment1': torch.randn(64, 16, generator=g),
                           'beta1_pow': torch.tensor(0.9 ** (seed + 1))}},
            'scaler': {'scale': torch.tensor(1024.0),
                       'good': torch.tensor(seed, dtype=torch.int32)}}


def _save(mgr, state, step, fmt, **kw):
    if fmt == 2:
        kw.setdefault('world', 1)
    return mgr.save(state, step=step, **kw)


def _equal(got, want):
    """Nested equality, bit for bit, of numpy/tensor leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    if want is None or isinstance(want, (bool, int, float, str)):
        assert got == want and type(got) is type(want)
        return
    w = want.detach().cpu() if isinstance(want, torch.Tensor) else want
    g = got.detach().cpu() if isinstance(got, torch.Tensor) else got
    if isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16:
        assert g.dtype == torch.bfloat16 and torch.equal(
            g.view(torch.int16), w.view(torch.int16))
        return
    w, g = np.asarray(w), np.asarray(g)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


def _corrupt_file(mgr, step, fmt):
    return mgr._payload(step) if fmt == 1 else \
        os.path.join(mgr._v2_dir(step), 'shard_rank0.npz')


# -- the manager --------------------------------------------------------------

@pytest.mark.parametrize("fmt", [1, 2])
def test_rotation_keeps_the_last_n(tmp_path, fmt):
    mgr = CheckpointManager(tmp_path, max_keep=2)
    for s in range(5):
        _save(mgr, _state(s), s, fmt, meta={'epoch': s})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    names = sorted(os.listdir(tmp_path))
    assert len(names) == (4 if fmt == 1 else 2), names
    state, meta = mgr.load()
    assert meta == {'epoch': 4}
    _equal(state, _state(4))
    assert mgr.load_manifest(4)['format'] == fmt


@pytest.mark.parametrize("fmt", [1, 2])
def test_truncated_latest_falls_back_with_a_warning(tmp_path, fmt):
    mgr = CheckpointManager(tmp_path, max_keep=5)
    for s in range(3):
        _save(mgr, _state(s), s, fmt)
    path = _corrupt_file(mgr, 2, fmt)
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 11)
    assert not mgr.verify(2) and mgr.verify(1)
    with pytest.warns(UserWarning, match='step 2.*corrupt.*falling back'):
        state, _ = mgr.restore()
    _equal(state, _state(1))


@pytest.mark.parametrize("fmt", [1, 2])
def test_bit_flip_is_caught_by_the_crc(tmp_path, fmt):
    mgr = CheckpointManager(tmp_path)
    _save(mgr, _state(0), 0, fmt)
    _save(mgr, _state(1), 1, fmt)
    path = _corrupt_file(mgr, 1, fmt)
    with open(path, 'r+b') as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x10]))
    assert 'CRC32 mismatch' in mgr._check(1)
    with pytest.warns(UserWarning, match='CRC32'):
        state, _ = mgr.load()
    _equal(state, _state(0))


def test_all_corrupt_returns_none(tmp_path):
    mgr = CheckpointManager(tmp_path)
    _save(mgr, _state(0), 0, 1)
    _save(mgr, _state(1), 1, 2)
    for s, fmt in ((0, 1), (1, 2)):
        with open(_corrupt_file(mgr, s, fmt), 'r+b') as f:
            f.truncate(5)
    with pytest.warns(UserWarning) as rec:
        assert mgr.restore() is None
    assert len(rec) == 2
    assert CheckpointManager(tmp_path / 'empty').restore() is None


@pytest.mark.parametrize("fmt", [1, 2])
def test_crash_between_write_and_commit(tmp_path, fmt, hooks):
    """The payload lands, the manifest's commit fails: the step does not
    exist, the previous one restores, and a later save of the same step
    overwrites the orphans."""
    mgr = CheckpointManager(tmp_path)
    _save(mgr, _state(0), 0, fmt)
    hooks.fail_stage('replace', 'manifest.json')
    with pytest.raises(AtomicWriteError):
        _save(mgr, _state(1), 1, fmt)
    atomic_io._fault_hook = None
    assert mgr.steps() == [0]
    _equal(mgr.load()[0], _state(0))
    _save(mgr, _state(2), 1, fmt)
    assert mgr.steps() == [0, 1]
    _equal(mgr.load()[0], _state(2))


# -- async --------------------------------------------------------------------

def test_async_saves_are_ordered_and_snapshot_at_the_call(tmp_path, hooks):
    """Three async saves commit in order; each holds the values at its
    call, though the tensors change in place right after (the clone is
    made before ``save`` returns)."""
    hooks.slow('ckpt_', 0.002)
    mgr = CheckpointManager(tmp_path, max_keep=10)
    live = _state(0)
    wants = []
    for s in range(3):
        wants.append({k: {n: t.clone() for n, t in v.items()}
                      for k, v in live.items() if k == 'params'})
        mgr.save({'params': live['params']}, step=s, world=1, async_=True)
        for t in live['params'].values():
            t.add_(1.0)                     # the next step, in place
    mgr.fence(timeout=30)
    assert not mgr.in_flight() and mgr.steps() == [0, 1, 2]
    for s in range(3):
        _equal(mgr.load(step=s)[0], wants[s])


def test_default_step_numbers_see_the_inflight_commit(tmp_path, hooks):
    hooks.slow('ckpt_', 0.005)
    mgr = CheckpointManager(tmp_path, max_keep=10)
    for s in range(3):
        assert mgr.save(_state(s), world=1, async_=True) == s
    mgr.fence(timeout=30)
    assert mgr.steps() == [0, 1, 2]


def test_background_failure_surfaces_on_fence(tmp_path, hooks):
    mgr = CheckpointManager(tmp_path)
    hooks.fail_after('shard_rank', 64)
    mgr.save(_state(), step=5, world=1, async_=True)
    with pytest.raises(AtomicWriteError, match='space'):
        mgr.fence(timeout=30)
    assert 5 not in mgr.steps() and not os.path.exists(mgr._v2_dir(5))
    assert mgr.fence(timeout=30) == 0.0          # raised once


def test_fence_abandons_a_slow_save(tmp_path, hooks):
    """``fence(abandon=True)`` stops a save that is still writing and
    removes what it wrote; nothing of the step remains."""
    hooks.slow('ckpt_', 0.05)
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(), step=3, world=1, async_=True)
    mgr.fence(timeout=0.1, abandon=True)
    assert mgr.steps() == [] and not os.path.exists(mgr._v2_dir(3))


# -- sharded ------------------------------------------------------------------

def test_failed_shard_keeps_the_previous_checkpoint(tmp_path, hooks):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(0), step=1, world=1)
    hooks.fail_after('shard_rank', 1000)
    with pytest.raises(AtomicWriteError):
        mgr.save(_state(1), step=2, world=1)
    assert mgr.steps() == [1] and not os.path.exists(mgr._v2_dir(2))
    _equal(mgr.restore()[0], _state(0))


def test_truncated_manifest_stays_invisible(tmp_path, hooks):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(0), step=1, world=1)
    # a manifest whose write fails is never committed
    hooks.fail_after('manifest.json', 0)
    with pytest.raises(AtomicWriteError):
        mgr.save(_state(1), step=2, world=1)
    assert mgr.steps() == [1]
    # one truncated on disk afterwards is skipped with a warning
    atomic_io._stream_hook = None
    mgr.save(_state(2), step=3, world=1)
    man = os.path.join(mgr._v2_dir(3), 'manifest.json')
    with open(man, 'r+b') as f:
        f.truncate(20)
    with pytest.warns(UserWarning, match='unreadable manifest'):
        state, _ = mgr.restore()
    _equal(state, _state(0))


def test_per_rank_writes_behind_a_bounded_barrier(tmp_path):
    """World 2: rank 1 writes its shard and marker, rank 0 waits for it
    (bounded), then commits one manifest; the leaves split along their
    first even dim come back whole. Without rank 1, rank 0's barrier
    times out and the step stays invisible."""
    state = _state(7)
    root = str(tmp_path / 'w2')
    t = threading.Thread(target=lambda: (time.sleep(0.2), ac.save_sharded(
        root, state, 4, world=2, rank=1)))
    t.start()
    man = ac.save_sharded(root, state, 4, world=2, rank=0,
                          barrier_timeout=30)
    assert join_thread(t, timeout=30)
    assert man['world'] == 2 and sorted(man['shards']) == ['0', '1']
    split = [p for p in man['leaves'] if p['dim'] is not None]
    assert split and all(len(p['pieces']) == 2 for p in split)
    mgr = CheckpointManager(root)
    assert mgr.steps() == [4]
    _equal(mgr.restore()[0], state)
    lone = str(tmp_path / 'lone')
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout, match=r'ranks \[1\]'):
        ac.save_sharded(lone, state, 5, world=2, rank=0,
                        barrier_timeout=0.3)
    assert time.monotonic() - t0 < 10
    assert CheckpointManager(lone).steps() == []


def test_sharded_directories_rotate(tmp_path):
    mgr = CheckpointManager(tmp_path, max_keep=2)
    for s in range(4):
        mgr.save(_state(s), step=s, world=2)
    assert mgr.steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ['ckpt_00000002',
                                            'ckpt_00000003']


def test_extra_promotes_to_the_sharded_format(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(), step=0, meta={'epoch': 1}, extra={'rng': [1, 2]})
    assert mgr.load_manifest(0)['format'] == 2
    assert mgr.load_extra() == {'rng': [1, 2]}
    state, meta, extra = mgr.restore(return_extra=True)
    assert meta == {'epoch': 1} and extra == {'rng': [1, 2]}


def test_mesh_sharding_raises_naming_distributed(tmp_path):
    """``sharding=`` is ported (distributed/): a bad value raises as the
    reference's (no sharding config in an object; a resharding restore
    needs an engine-layout state), and without a process group a
    ``ShardingConfig`` save is the one-rank sharded format, its restore
    the saved state bit for bit (the multi-rank matrix:
    tests/test_torch_distributed_fit.py)."""
    from paddle_tpu_torch.distributed import ShardingConfig
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(TypeError, match='cannot resolve a sharding'):
        mgr.save(_state(), sharding=object())
    with pytest.raises(ValueError, match='engine-layout'):
        ac.place_with_config({'w': np.zeros(4)}, ShardingConfig())
    cfg = ShardingConfig()
    mgr.save(_state(), step=0, sharding=cfg)
    man = mgr.load_manifest(0)
    assert man['format'] == 2 and man['world'] == 1
    assert man['mesh'] == {'axes': {'data': 1}, 'fsdp': True,
                           'tensor_parallel_degree': 1}
    with pytest.raises(TypeError, match='cannot resolve a sharding'):
        mgr.restore(sharding=object())
    state, _ = mgr.restore(sharding=cfg)
    want = _state()
    assert np.array_equal(state['params']['w1'], want['params']['w1'])
    assert np.array_equal(state['opt']['w0']['moment1'],
                          want['opt']['w0']['moment1'])


# -- framework.save / load ----------------------------------------------------

def test_framework_save_load_bf16_bit_for_bit(tmp_path, hooks):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(5, 7, generator=g)
    obj = {'w': torch.nn.Parameter(w), 'b': w.to(torch.bfloat16),
           'i': torch.arange(4, dtype=torch.int32), 'n': np.arange(3.0),
           'nested': [w[:2].to(torch.bfloat16), (torch.tensor(2.5), 3)],
           'step': 7}
    path = str(tmp_path / 'm.pdparams')
    framework.save(obj, path)
    got = framework.load(path)
    assert isinstance(got['w'], torch.nn.Parameter)
    _equal(got['w'], obj['w'])
    for key in ('b', 'i', 'n'):
        _equal(got[key], obj[key])
    _equal(got['nested'][0], obj['nested'][0])
    _equal(got['nested'][1][0], obj['nested'][1][0])
    assert got['nested'][1][1] == 3 and got['step'] == 7
    numpy_view = framework.load(path, return_numpy=True)
    assert isinstance(numpy_view['w'], np.ndarray)
    assert numpy_view['b'].dtype == torch.bfloat16     # numpy has none
    # a failed write leaves the previous file; a torn one names itself
    hooks.fail_stage('replace', 'm.pdparams')
    with pytest.raises(AtomicWriteError):
        framework.save({'w': torch.zeros(2)}, path)
    _equal(framework.load(path)['w'], obj['w'])
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(RuntimeError, match='truncated or corrupt'):
        framework.load(path)


# -- across the packages ------------------------------------------------------

def _mixed_state(bf16=True):
    """A fit-shaped state with every kind of leaf: fp32, int32, 0-dim,
    a nested list and tuple, plain values, and (optionally) bf16."""
    rs = np.random.RandomState(4)
    params = {'enc.w': rs.randn(64, 32).astype(np.float32),
              'enc.b': rs.randn(32).astype(np.float32)}
    if bf16:
        params['half'] = rs.randn(8, 16).astype(np.float32)
    return {'params': params,
            'opt': {'enc.w': {'moment1': rs.randn(64, 32).astype(np.float32),
                              'beta1_pow': np.float32(0.81).reshape(())}},
            'guard': {'steps': np.int32(5).reshape(()),
                      'skipped': np.int32(1).reshape(())},
            'rest': [np.arange(6, dtype=np.int32), (1.5, 'x', None)]}


def _port_leaves(state):
    """The numpy state as the port holds it: tensors, ``half`` in bf16."""
    def conv(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if k == 'half' else t
    out = ac._map_leaves(state, lambda v: v)
    out['params'] = {k: conv(k, v) for k, v in state['params'].items()}
    return out


def _ref_leaves(state):
    out = ac._map_leaves(state, lambda v: v)
    if 'half' in state['params']:
        out['params'] = dict(state['params'])
        out['params']['half'] = jnp.asarray(state['params']['half'],
                                            jnp.bfloat16)
    return out


def _bf16_words(x):
    return np.asarray(torch.from_numpy(np.array(x)).to(torch.bfloat16)
                      .view(torch.int16).numpy()).view(np.uint16)


@pytest.mark.parametrize("world", [1, 2])
def test_reference_reads_what_the_port_wrote(tmp_path, world):
    want = _mixed_state()
    meta = {'epoch': 2, 'dispatch_in_epoch': 1, 'dispatches': 9}
    mgr = CheckpointManager(tmp_path)
    mgr.save(_port_leaves(want), step=9, meta=meta, world=world,
             extra={'rng': {'numpy': [1, 2, 3]}})
    state, got_meta, extra = ref_ac.load_sharded(
        ref_ac.step_dir(str(tmp_path), 9), return_extra=True)
    assert got_meta == meta and extra == {'rng': {'numpy': [1, 2, 3]}}
    # the reference reads a bf16 leaf back as its raw 16-bit words (|V2)
    half = state['params'].pop('half')
    assert half.dtype == np.dtype('V2')
    np.testing.assert_array_equal(half.view(np.uint16),
                                  _bf16_words(want['params']['half']))
    want['params'].pop('half')
    _equal(state, want)


@pytest.mark.parametrize("world", [1, 2])
def test_port_reads_what_the_reference_wrote(tmp_path, world):
    want = _mixed_state(bf16=world == 1)      # its split bf16 is a fault
    meta = {'epoch': 1, 'dispatches': 4}
    root = str(tmp_path)
    ref_ac.save_sharded(root, _ref_leaves(want), 4, meta=meta, world=world,
                        extra={'rng': {'numpy': 'state'}})
    got = CheckpointManager(root).restore(return_extra=True)
    state, got_meta, extra = got
    assert got_meta == meta and extra == {'rng': {'numpy': 'state'}}
    if world == 1:
        half = state['params'].pop('half')
        assert half.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            half.view(torch.int16).numpy().view(np.uint16),
            _bf16_words(want['params']['half']))
        want['params'].pop('half')
    _equal(state, want)
    # the port's own manifest for the same state lists the same plans
    port_dir = str(tmp_path / 'port')
    man = ac.save_sharded(port_dir, _port_leaves(
        _mixed_state(bf16=world == 1)), 4, meta=meta, world=world)
    theirs = ref_ac.read_manifest(ref_ac.step_dir(root, 4))
    assert man['leaves'] == theirs['leaves']
    assert man['treedef'] == theirs['treedef']


def test_bf16_members_are_the_references_bytes(tmp_path):
    """The npy member of a bf16 leaf: the reference's descriptor ('<V2')
    and the same bytes, header included."""
    import zipfile
    x = np.random.RandomState(1).randn(300, 7).astype(np.float32)
    ref_ac.save_sharded(str(tmp_path / 'r'), {'a': jnp.asarray(
        x, jnp.bfloat16)}, 0, world=1)
    ac.save_sharded(str(tmp_path / 'p'), {'a': torch.from_numpy(x).to(
        torch.bfloat16)}, 0, world=1)
    members = []
    for side in ('r', 'p'):
        with zipfile.ZipFile(os.path.join(ac.step_dir(
                str(tmp_path / side), 0), 'shard_rank0.npz')) as z:
            members.append(z.read('L00000.p0.npy'))
    assert members[0] == members[1]
    assert b"'descr': '<V2'" in members[1]


def test_reference_fault_bf16_leaves_do_not_survive_its_round_trip(tmp_path):
    """The reference writes a bf16 leaf's dtype as 'bfloat16' and rebuilds
    it with ``np.dtype(plan['dtype'])`` (``async_checkpoint.py:229``,
    ``:574``): a whole leaf comes back as ``|V2`` bytes, and a leaf split
    over two ranks cannot be assembled at all (ROADMAP.md, Queue 3). The
    port reads both back as bf16, bit for bit."""
    x = np.random.RandomState(2).randn(64, 32).astype(np.float32)
    leaf = {'a': jnp.asarray(x, jnp.bfloat16)}
    ref_ac.save_sharded(str(tmp_path / 'one'), leaf, 0, world=1)
    back, _ = ref_ac.load_sharded(ref_ac.step_dir(str(tmp_path / 'one'), 0))
    assert back['a'].dtype == np.dtype('V2')
    ref_ac.save_sharded(str(tmp_path / 'two'), leaf, 0, world=2)
    with pytest.raises(ValueError):
        ref_ac.load_sharded(ref_ac.step_dir(str(tmp_path / 'two'), 0))
    t = torch.from_numpy(x).to(torch.bfloat16)
    for world in (1, 2):
        root = str(tmp_path / f'port{world}')
        ac.save_sharded(root, {'a': t}, 0, world=world)
        got, _ = ac.load_sharded(ac.step_dir(root, 0))
        assert torch.equal(got['a'].view(torch.int16), t.view(torch.int16))


# -- preemption, RNG, retry, watchdog -----------------------------------------

def test_preemption_guard_catches_sigterm_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert g.installed and not g.preempted
        signal.raise_signal(signal.SIGTERM)
        assert g.preempted
    assert signal.getsignal(signal.SIGTERM) is prev
    # off the main thread it stays inert, with a warning
    box = []
    t = threading.Thread(target=lambda: box.append(_install_off_main()))
    t.start()
    assert join_thread(t, timeout=30) and box == [False]


def _install_off_main():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return PreemptionGuard().install().installed


class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        self.dropout_state = DropoutState(seed)
        self.inner = torch.nn.Module()
        self.inner.dropout_state = self.dropout_state     # the same one
        self.other = torch.nn.Module()
        self.other.state = DropoutState(seed + 1)


def test_capture_and_restore_rng_by_module_path():
    from paddle_tpu_torch.optimizer import Dpsgd
    net = _Net(5)
    net.dropout_state.offset = 12
    opt = Dpsgd(seed=3)
    opt_state = opt.init_state_values({'w': torch.zeros(3)})
    np.random.seed(9)
    snap = capture_rng(net, opt_state)
    assert snap['dropout'] == {'dropout_state': {'seed': 5, 'offset': 12},
                               'other.state': {'seed': 6, 'offset': 0}}
    want = (np.random.rand(3), torch.randn(4, generator=opt_state['w']['key']))
    fresh = _Net(50)
    fresh_state = Dpsgd(seed=4).init_state_values({'w': torch.zeros(3)})
    restore_rng(snap, fresh, fresh_state)
    assert fresh.inner.dropout_state.seed == 5
    assert fresh.inner.dropout_state.offset == 12
    got = (np.random.rand(3),
           torch.randn(4, generator=fresh_state['w']['key']))
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    stranger = torch.nn.Module()
    stranger.drop = DropoutState(1)
    with pytest.raises(ValueError, match='dropout states'):
        restore_rng(snap, stranger)


def test_retry_and_bounded_waits():
    import queue
    calls = []

    @retry(max_attempts=3, backoff=0.0, jitter=0.0)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError('transient')
        return 'ok'
    assert flaky() == 'ok' and len(calls) == 3

    @retry(max_attempts=2, backoff=0.0, jitter=0.0)
    def dead():
        raise ConnectionError('down')
    with pytest.raises(RetryError) as ei:
        dead()
    assert ei.value.attempts == 2
    with pytest.raises(WatchdogTimeout):
        bounded_get(queue.Queue(), timeout=0.2, tick=0.05)
    with pytest.raises(WatchdogTimeout, match='died'):
        bounded_get(queue.Queue(), timeout=5, alive=lambda: False, tick=0.05)
