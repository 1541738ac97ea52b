"""``paddle_tpu_torch.io`` against ``paddle_tpu.io``: the samplers and the
DataLoader's batch order under one ``np.random.seed`` (both packages draw
from numpy's global state), ``random_split``, collation, iterable datasets
and ``from_generator``; and the port's loader on its own: threaded workers
in order, a raising sample as ``DataLoaderWorkerError``, the quarantine
budget and its report, a hung worker caught by the watchdog, workers that
stop when the iterator is abandoned, batches on ``device='cpu'``. The
reference's loader runs its threaded path (``use_shared_memory=False``):
its process workers sit on a native ring the port does not have."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu.io import batch as jax_batch

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.batch import batch as torch_batch


class _Toy:
    """16 samples: (a 3-vector of i, the label i % 4)."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), np.int64(i % 4)


class JToy(_Toy, jio.Dataset):
    pass


class TToy(_Toy, tio.Dataset):
    pass


def _host(batch):
    """A batch of either package as nested lists of numpy arrays."""
    if isinstance(batch, dict):
        return {k: _host(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_host(v) for v in batch]
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch.numpy() if hasattr(batch, 'numpy') else batch)


def _same(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        # the reference's device arrays hold int64 as int32 (JAX without
        # x64), its host arrays as int64
        assert a.dtype == b.dtype or (a.dtype, b.dtype) == (np.int64,
                                                            np.int32)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _draw(make, seed):
    np.random.seed(seed)
    return list(make())


@pytest.mark.parametrize('case', [
    'sequence', 'random', 'random_replacement', 'random_num_samples',
    'weighted', 'batch_shuffle', 'batch_drop_last', 'distributed'])
def test_samplers_match_reference(case):
    ds = list(range(13))
    makers = {
        'sequence': lambda m: m.SequenceSampler(ds),
        'random': lambda m: m.RandomSampler(ds),
        'random_replacement': lambda m: m.RandomSampler(
            ds, replacement=True, num_samples=20),
        'random_num_samples': lambda m: m.RandomSampler(ds, num_samples=5),
        'weighted': lambda m: m.WeightedRandomSampler(
            [0.1, 0.4, 0.2, 0.3], 9, replacement=True),
        'batch_shuffle': lambda m: m.BatchSampler(ds, shuffle=True,
                                                  batch_size=4),
        'batch_drop_last': lambda m: m.BatchSampler(
            ds, shuffle=True, batch_size=4, drop_last=True),
        'distributed': None,
    }
    if case == 'distributed':
        for rank in (0, 1):
            for drop in (False, True):
                got = [tio.DistributedBatchSampler(
                    ds, 3, num_replicas=2, rank=rank, shuffle=True,
                    drop_last=drop) for _ in range(2)]
                want = [jio.DistributedBatchSampler(
                    ds, 3, num_replicas=2, rank=rank, shuffle=True,
                    drop_last=drop) for _ in range(2)]
                got[1].set_epoch(5)
                want[1].set_epoch(5)
                for g, w in zip(got, want):
                    assert list(g) == list(w) and len(g) == len(w)
                    assert list(g) == list(w)   # the next epoch's order
        # no process group: one replica
        assert tio.DistributedBatchSampler(ds, 4).nranks == 1
        return
    for seed in (0, 3):
        got = _draw(lambda: makers[case](tio), seed)
        want = _draw(lambda: makers[case](jio), seed)
        assert got == want
        assert len(makers[case](tio)) == len(makers[case](jio))


@pytest.mark.parametrize('workers', [0, 2])
def test_shuffled_batch_order_matches_reference(workers):
    """One seed, two epochs: the same batches, in the same order."""
    got_loader = tio.DataLoader(TToy(), batch_size=3, shuffle=True,
                                num_workers=workers, device='cpu')
    want_loader = jio.DataLoader(JToy(), batch_size=3, shuffle=True,
                                 num_workers=workers,
                                 use_shared_memory=False)
    np.random.seed(7)
    got = [b for _ in range(2) for b in got_loader]
    np.random.seed(7)
    want = [b for _ in range(2) for b in want_loader]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
                   for t in g)
        _same(g, w)


def test_random_split_matches_reference():
    for seed in (0, 5):
        np.random.seed(seed)
        got = tio.random_split(TToy(10), [3, 7])
        np.random.seed(seed)
        want = jio.random_split(JToy(10), [3, 7])
        assert [s.indices for s in got] == [s.indices for s in want]
        _same(got[1][2], want[1][2])
    with pytest.raises(ValueError):
        tio.random_split(TToy(10), [3, 3])


def test_collation_matches_reference():
    rs = np.random.RandomState(0)
    samples = [{'x': rs.randn(2, 3).astype(np.float32),
                'pair': (np.int64(i), float(i) / 2),
                'name': f's{i}'} for i in range(4)]
    _same(tio.default_collate_fn(samples), jio.default_collate_fn(samples))
    got = tio.default_collate_fn(samples)
    assert got['name'] == ['s0', 's1', 's2', 's3']
    assert got['pair'][0].dtype == np.int64
    assert got['pair'][1].dtype == np.float32
    # torch tensors stack as tensors, equal to the reference's numpy stack
    tensors = [torch.from_numpy(s['x']) for s in samples]
    stacked = tio.default_collate_fn(tensors)
    assert isinstance(stacked, torch.Tensor) and stacked.shape == (4, 2, 3)
    np.testing.assert_array_equal(
        stacked.numpy(), jio.default_collate_fn([s['x'] for s in samples]))
    assert tio.default_convert_fn(samples) is samples
    with pytest.raises(TypeError):
        tio.default_collate_fn([object()])


@pytest.mark.parametrize('drop_last', [False, True])
def test_drop_last_and_tensor_dataset(drop_last):
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    y = np.arange(10)
    got = list(tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                              drop_last=drop_last, device='cpu'))
    want = list(jio.DataLoader(jio.TensorDataset([x.numpy(), y]),
                               batch_size=4, drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    assert len(tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                              drop_last=drop_last, device='cpu')) == len(got)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError):
        tio.TensorDataset([x, y[:5]])


def test_dataset_combinators_match_reference():
    a, b = TToy(5), TToy(3)
    ja, jb = JToy(5), JToy(3)
    cat, jcat = tio.ConcatDataset([a, b]), jio.ConcatDataset([ja, jb])
    assert len(cat) == len(jcat) == 8
    for i in (0, 4, 5, 7, -1):
        _same(cat[i], jcat[i])
    comp = tio.ComposeDataset([a, TToy(5)])
    _same(comp[2], jio.ComposeDataset([ja, JToy(5)])[2])
    assert len(comp[2]) == 4
    sub = tio.Subset(a, [4, 0])
    assert len(sub) == 2 and float(sub[0][0][0]) == 4.0


class _Stream:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.array([i, i * i], np.int64)


class JStream(_Stream, jio.IterableDataset):
    pass


class TStream(_Stream, tio.IterableDataset):
    pass


@pytest.mark.parametrize('drop_last', [False, True])
def test_iterable_datasets_match_reference(drop_last):
    for workers in (0, 2):
        got = list(tio.DataLoader(TStream(7), batch_size=3,
                                  drop_last=drop_last, num_workers=workers,
                                  device='cpu'))
        want = list(jio.DataLoader(JStream(7), batch_size=3,
                                   drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            _same(g, w)
    chain = [v for v in tio.ChainDataset([TStream(2), TStream(3)])]
    assert [int(v[0]) for v in chain] == [0, 1, 0, 1, 2]
    with pytest.raises(TypeError):
        len(tio.DataLoader(TStream(3), device='cpu'))
    with pytest.raises(RuntimeError):
        TStream(3)[0]


def test_from_generator_matches_reference():
    def samples():
        for i in range(7):
            yield (np.full((2,), i, np.float32), np.int64(i))

    def sample_lists():
        yield [(np.zeros(2, np.float32), np.int64(1))] * 3

    def batches():
        yield (np.ones((2, 2), np.float32),)

    for set_gen, args in (('set_sample_generator', (samples, 3, True)),
                          ('set_sample_generator', (samples, 3, False)),
                          ('set_sample_list_generator', (sample_lists,)),
                          ('set_batch_generator', (batches,))):
        got = getattr(tio.DataLoader.from_generator(device='cpu'),
                      set_gen)(*args)
        want = getattr(jio.DataLoader.from_generator(), set_gen)(*args)
        got, want = list(got()), list(want())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)


def test_batch_decorator_matches_reference():
    def reader():
        yield from range(7)
    for drop in (False, True):
        assert list(torch_batch(reader, 3, drop)()) == \
            list(jax_batch(reader, 3, drop)())
    assert tio.batch is torch_batch
    with pytest.raises(ValueError):
        torch_batch(reader, 0)


class _Jittery(tio.Dataset):
    """Sample i sleeps a pseudo-random few ms, so that two workers finish
    their batches out of order."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        time.sleep(0.001 * ((i * 7) % 5))
        return np.array([i], np.int64)


def test_threaded_workers_deliver_in_order():
    for prefetch_factor in (1, 3):
        loader = tio.DataLoader(_Jittery(), batch_size=2, num_workers=3,
                                prefetch_factor=prefetch_factor,
                                device='cpu')
        got = [int(v) for b in loader for v in b.reshape(-1)]
        assert got == list(range(24))


class _Poisoned(tio.Dataset):
    def __init__(self, bad, n=16):
        self.bad, self.n = set(bad), n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise ValueError(f"poisoned sample {i}")
        return np.full((3,), i, np.float32)


@pytest.mark.parametrize('workers', [0, 2])
def test_raising_sample_is_a_worker_error(workers):
    loader = tio.DataLoader(_Poisoned([3]), batch_size=2,
                            num_workers=workers, device='cpu')
    start = time.monotonic()
    with pytest.raises(tio.DataLoaderWorkerError) as err:
        list(loader)
    assert time.monotonic() - start < 5.0
    assert 'dataset[3]' in str(err.value)
    assert 'poisoned sample 3' in str(err.value)


@pytest.mark.parametrize('workers', [0, 2])
def test_quarantine_budget_and_report(workers, monkeypatch):
    loader = tio.DataLoader(_Poisoned([3, 7]), batch_size=2,
                            num_workers=workers, skip_bad_samples=2,
                            device='cpu')
    vals = [float(v) for b in loader for v in b[:, 0]]
    assert vals == [float(i) for i in range(16) if i not in (3, 7)]
    report = loader.quarantine_report()
    assert sorted(i for i, _ in report) == [3, 7]
    assert all('poisoned sample' in err for _, err in report)
    # a batch quarantined whole leaves no hole in the order
    whole = tio.DataLoader(_Poisoned([2, 3], n=8), batch_size=2,
                           num_workers=workers, skip_bad_samples=2,
                           device='cpu')
    assert [float(v) for b in whole for v in b[:, 0]] == \
        [0.0, 1.0, 4.0, 5.0, 6.0, 7.0]
    # past the budget: fails, the report holds the budget's worth
    over = tio.DataLoader(_Poisoned([1, 3, 5]), batch_size=2,
                          num_workers=workers, skip_bad_samples=1,
                          device='cpu')
    with pytest.raises(tio.DataLoaderWorkerError, match='exhausted'):
        list(over)
    assert len(over.quarantine_report()) == 1
    monkeypatch.setenv('PADDLE_TPU_DATA_SKIP_BUDGET', '2')
    assert tio.DataLoader(_Poisoned([0]), device='cpu').skip_bad_samples \
        == 2


class _Hangs(tio.Dataset):
    """Sample ``at`` blocks until ``release`` is set (at most 10 s)."""

    def __init__(self, at):
        self.at = at
        self.release = threading.Event()

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == self.at:
            self.release.wait(10.0)
        return np.full((3,), i, np.float32)


def test_hung_worker_trips_the_watchdog():
    ds = _Hangs(2)
    loader = tio.DataLoader(ds, batch_size=2, num_workers=2, timeout=0.5,
                            device='cpu')
    start = time.monotonic()
    try:
        with pytest.raises(tio.DataLoaderWorkerError, match='wedged'):
            list(loader)
        assert time.monotonic() - start < 3.0
    finally:
        ds.release.set()


def test_worker_failures_outside_samples_propagate():
    def bad_collate(samples):
        raise TypeError('collate boom')

    def bad_init(wid):
        raise RuntimeError(f'init boom {wid}')
    for kw, what in ((dict(collate_fn=bad_collate), 'collate'),
                     (dict(worker_init_fn=bad_init), 'init boom')):
        loader = tio.DataLoader(_Toy(8), batch_size=2, num_workers=2,
                                device='cpu', **kw)
        with pytest.raises(tio.DataLoaderWorkerError, match=what):
            list(loader)


def test_abandoned_iterator_stops_its_workers():
    before = {t for t in threading.enumerate()
              if t.name.startswith('paddle-tpu-torch-loader')}
    loader = tio.DataLoader(_Toy(64), batch_size=2, num_workers=3,
                            prefetch_factor=1, device='cpu')
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        alive = {t for t in threading.enumerate()
                 if t.name.startswith('paddle-tpu-torch-loader')} - before
        if not alive:
            break
        time.sleep(0.02)
    assert not alive


def test_timeout_settings(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_DATA_TIMEOUT', '0')
    loader = tio.DataLoader(_Toy(8), batch_size=2, num_workers=2,
                            device='cpu')
    assert loader.timeout == 0.0
    assert sum(b[0].shape[0] for b in loader) == 8
    monkeypatch.delenv('PADDLE_TPU_DATA_TIMEOUT')
    assert tio.DataLoader(_Toy(8), timeout=-1, device='cpu').timeout == 0.0
    assert tio.DataLoader(_Toy(8), device='cpu').timeout == 300.0


def test_device_leaves_and_prefetch_paths():
    want = [b for b in tio.DataLoader(TToy(), batch_size=4, device='cpu',
                                      use_buffer_reader=False)]
    for kw in (dict(), dict(prefetch_to_device=2), dict(places=['cpu']),
               dict(places='cpu')):
        got = list(tio.DataLoader(TToy(), batch_size=4, **kw)
                   if 'places' in kw else
                   tio.DataLoader(TToy(), batch_size=4, device='cpu', **kw))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert all(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
                       for t in g)
            _same(g, w)
    assert tio.DataLoader(TToy(), prefetch_to_device=True,
                          device='cpu').prefetch_to_device == 2
    with pytest.raises(ValueError):
        tio.DataLoader(TToy(), places=['cpu', 'cpu'])
    if not torch.cuda.is_available():
        # the default device is the card; without one, a loud error
        with pytest.raises(RuntimeError, match='CUDA'):
            tio.DataLoader(TToy())
    assert tio.get_worker_info() is None


def test_module_surface():
    for name in ('Dataset', 'IterableDataset', 'TensorDataset',
                 'ComposeDataset', 'ChainDataset', 'ConcatDataset', 'Subset',
                 'random_split', 'Sampler', 'SequenceSampler',
                 'RandomSampler', 'WeightedRandomSampler', 'BatchSampler',
                 'DistributedBatchSampler', 'DataLoader',
                 'DataLoaderWorkerError', 'DevicePrefetcher',
                 'default_collate_fn', 'default_convert_fn', 'batch', 'save',
                 'load', 'get_worker_info'):
        assert hasattr(tio, name), name
        assert name in tio.__all__
