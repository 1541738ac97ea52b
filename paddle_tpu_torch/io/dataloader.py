"""DataLoader. Counterpart of ``paddle_tpu/io/dataloader.py``
(``DataLoader`` with ``from_generator`` / ``from_dataset``,
``DataLoaderWorkerError``, ``default_collate_fn``, ``default_convert_fn``).

Batches are built on the host — sample fetch and collation, in worker
threads when ``num_workers > 0`` — and moved to ``device`` (the CUDA
device unless the caller passes ``device='cpu'``; ``places=`` is the
reference's name for it) by the consumer: each numpy or host-tensor leaf is
copied from pinned memory with ``non_blocking=True`` in the current
stream's order, batch N+1's copies issued before batch N is handed out
(``use_buffer_reader``, the reference's double buffer). With
``prefetch_to_device=N`` (or ``PADDLE_TPU_PREFETCH``) the batches go
through ``io.DevicePrefetcher`` instead, N ahead on a side stream. Torch
tensors collate with ``torch.stack``; numpy arrays with ``np.stack``.

Self-healing, as the reference's threaded path: a worker that raises (in
``dataset[i]``, ``collate_fn``, ``worker_init_fn`` or the sampler) ships
the exception to the consumer, which raises ``DataLoaderWorkerError``; its
done sentinel is posted from a ``finally``; every consumer wait is
``resilience.watchdog.bounded_get``, so a dead worker is found within a
tick and a hung one within ``timeout`` seconds (``PADDLE_TPU_DATA_TIMEOUT``,
300 s by default; 0 or less: no deadline, liveness still probed). Poisoned
samples are skipped up to ``skip_bad_samples`` (``PADDLE_TPU_DATA_SKIP_
BUDGET``) and listed by ``quarantine_report()``. Batches come out in
sampler order whatever worker built them. Abandoning the iterator stops the
workers within a tick (their hand-off is bounded too), where the
reference's workers stay blocked on a full queue.

``num_workers > 0`` always runs threads: the reference's fork()ed workers
on its native shared-memory ring (``paddle_tpu/_native/process_pool.py``,
``csrc/prefetch.cpp``) are not ported, so ``use_shared_memory`` and
``worker_max_restarts`` are accepted and change nothing, as on the
reference's own threaded path. The reference's telemetry (queue depth,
batch wait, stall events) waits for an ``observability`` package.
"""
import itertools
import os
import queue
import threading
import traceback

import numpy as np
import torch

from ..device import resolve_device
from ..resilience import watchdog as _watchdog
from .dataset import IterableDataset
from .prefetch import DevicePrefetcher, to_device
from .sampler import BatchSampler

__all__ = ['DataLoader', 'default_collate_fn', 'default_convert_fn',
           'DataLoaderWorkerError']

# consumer-side stall budget when DataLoader(timeout=0): generous enough
# for any real batch assembly, small enough that a wedged pipeline fails
# the job the same hour it wedges
_DEFAULT_WATCHDOG_S = 300.0


class DataLoaderWorkerError(RuntimeError):
    """A DataLoader worker failed (raised, or hung past the watchdog
    budget) and the loader could not self-heal within its budgets.
    ``quarantined`` carries the (index, error) pairs skipped so far."""

    def __init__(self, message, quarantined=()):
        self.quarantined = list(quarantined)
        if self.quarantined:
            message += (f"; {len(self.quarantined)} sample(s) were "
                        f"quarantined first: {self.quarantined}")
        super().__init__(message)


class _WorkerFailure:
    """A worker-side exception in transit to the consumer thread (made
    inside the ``except`` that caught it)."""

    def __init__(self, exc, where):
        self.where = where
        self.exc = exc
        self.tb = traceback.format_exc()


_SKIPPED_BATCH = object()   # every sample of the batch was quarantined


def default_collate_fn(batch):
    """Stack samples into batch arrays, field by field, as the reference's
    ``default_collate_fn``; torch tensors by ``torch.stack``."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch, dim=0)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    raise TypeError(f"cannot collate {type(sample)}")


def default_convert_fn(batch):
    return batch


def _env_prefetch_depth():
    """PADDLE_TPU_PREFETCH: '' / '0' off, '1' -> depth 2, N -> depth N."""
    raw = os.environ.get('PADDLE_TPU_PREFETCH', '')
    try:
        n = int(raw or 0)
    except ValueError:
        return 0
    return 2 if n == 1 else max(n, 0)


def _device(device, places):
    """``device``, else the reference's ``places`` (a device, or a list of
    one), resolved: None is the CUDA device."""
    if device is None and isinstance(places, (list, tuple)):
        if len(places) != 1:
            raise ValueError(f"DataLoader: places= names {len(places)} "
                             f"devices; the port's loader feeds one")
        places = places[0]
    return resolve_device(device if device is not None else places)


class DataLoader:
    """Iterate ``dataset`` in batches on ``device``. The arguments are the
    reference's; ``device`` (or ``places``) says where the batches go."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 prefetch_factor=2, persistent_workers=False,
                 skip_bad_samples=None, worker_max_restarts=None,
                 prefetch_to_device=None, device=None):
        self.dataset = dataset
        self.device = _device(device, places)
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(int(num_workers), 0)
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        # timeout=0 means "unspecified" (env, then the 300 s default);
        # PADDLE_TPU_DATA_TIMEOUT=0 or a negative timeout= disables the
        # deadline — consumer waits stay liveness-probed but unbounded
        if timeout:
            self.timeout = max(float(timeout), 0.0)
        else:
            self.timeout = float(
                os.environ.get('PADDLE_TPU_DATA_TIMEOUT', '')
                or _DEFAULT_WATCHDOG_S)
        if skip_bad_samples is None:
            skip_bad_samples = int(
                os.environ.get('PADDLE_TPU_DATA_SKIP_BUDGET', 0) or 0)
        self.skip_bad_samples = max(int(skip_bad_samples), 0)
        # None defers to PADDLE_TPU_PREFETCH; an int is the depth (0: off)
        if prefetch_to_device is None:
            self.prefetch_to_device = _env_prefetch_depth()
        elif prefetch_to_device is True:
            self.prefetch_to_device = 2
        else:
            self.prefetch_to_device = max(int(prefetch_to_device or 0), 0)
        self._quarantined = []       # (index, repr(exc)) of skipped samples
        self._q_lock = threading.Lock()
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # -- poison-sample quarantine ------------------------------------------

    def quarantine_report(self):
        """(index, error) pairs for every sample skipped under the
        ``skip_bad_samples`` budget, in the order they were quarantined."""
        with self._q_lock:
            return list(self._quarantined)

    def _quarantine(self, index, exc):
        """Record one poisoned sample. True when the budget covered it;
        False when the budget is exhausted (caller must fail)."""
        with self._q_lock:
            if len(self._quarantined) >= self.skip_bad_samples:
                return False
            self._quarantined.append((index, repr(exc)))
        return True

    def _fetch_samples(self, indices):
        """dataset[i] for each index, quarantining poisoned samples within
        budget. Returns (samples, None) or (None, _WorkerFailure)."""
        samples = []
        for i in indices:
            try:
                samples.append(self.dataset[i])
            except Exception as e:
                if not self._quarantine(i, e):
                    return None, _WorkerFailure(
                        e, f"dataset[{i}] (skip budget "
                           f"{self.skip_bad_samples} exhausted)")
        return samples, None

    def _index_batches(self):
        return self.batch_sampler if self.batch_sampler is not None \
            else ([i] for i in range(len(self.dataset)))

    def _raw_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self._index_batches():
                samples, failure = self._fetch_samples(indices)
                if failure is not None:
                    raise DataLoaderWorkerError(
                        f"DataLoader failed in {failure.where}: "
                        f"{failure.exc!r}", self.quarantine_report()) \
                        from failure.exc
                if samples:     # skip a batch that was quarantined whole
                    yield self.collate_fn(samples)

    def _threaded_batches(self):
        """num_workers > 0: worker threads build batches (fetch, collate),
        the consumer hands them out in sampler order. A worker that raises
        ships the exception and ALWAYS posts its done sentinel from a
        ``finally``; the consumer's wait is bounded (watchdog); leaving the
        generator sets ``stop``, which every worker sees within a tick."""
        if self._iterable_mode:
            yield from self._raw_batches()
            return
        indices_iter = iter(self._index_batches())
        out_q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        lock = threading.Lock()
        seq = [0]
        done = object()
        stop = threading.Event()

        def post(item):
            """Hand ``item`` over unless the consumer has gone -> posted."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=_watchdog.DEFAULT_TICK)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid):
            try:
                if self.worker_init_fn:
                    self.worker_init_fn(wid)
                while not stop.is_set():
                    with lock:
                        try:
                            my_seq = seq[0]
                            indices = next(indices_iter)
                            seq[0] += 1
                        except StopIteration:
                            return
                    samples, failure = self._fetch_samples(indices)
                    if failure is not None:
                        post((my_seq, failure))
                        return
                    if not samples:     # whole batch quarantined
                        post((my_seq, _SKIPPED_BATCH))
                        continue
                    try:
                        batch = self.collate_fn(samples)
                    except Exception as e:
                        post((my_seq, _WorkerFailure(e, 'collate_fn')))
                        return
                    if not post((my_seq, batch)):
                        return
            except BaseException as e:   # worker_init_fn, sampler, ...
                # shipped to the consumer, which raises it: a worker must
                # never end its part of the epoch silently
                post((None, _WorkerFailure(e, 'worker')))
            finally:
                # unconditional: the consumer must never wait on a thread
                # that already died
                post((None, done))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f'paddle-tpu-torch-loader-{w}')
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        def workers_alive():
            return any(t.is_alive() for t in threads)

        finished, next_seq, pending = 0, 0, {}
        try:
            while finished < self.num_workers:
                try:
                    s, batch = _watchdog.bounded_get(
                        out_q, timeout=self.timeout, alive=workers_alive,
                        what='DataLoader batch')
                except _watchdog.WatchdogTimeout as e:
                    raise DataLoaderWorkerError(
                        f"DataLoader wedged: {e}",
                        self.quarantine_report()) from e
                if batch is done:
                    finished += 1
                    continue
                if isinstance(batch, _WorkerFailure):
                    raise DataLoaderWorkerError(
                        f"DataLoader worker failed in {batch.where}: "
                        f"{batch.exc!r}\n{batch.tb}",
                        self.quarantine_report())
                pending[s] = batch
                while next_seq in pending:
                    b = pending.pop(next_seq)
                    next_seq += 1
                    if b is not _SKIPPED_BATCH:
                        yield b
        finally:
            stop.set()
            # workers blocked on the hand-off leave within a tick; one
            # wedged inside dataset[i] is left to finish on its own
            for t in threads:
                _watchdog.join_thread(t, timeout=2 * _watchdog.DEFAULT_TICK)

    def __iter__(self):
        source = self._threaded_batches() if self.num_workers > 0 else \
            self._raw_batches()
        if self.prefetch_to_device:
            yield from DevicePrefetcher(source, self.device,
                                        depth=self.prefetch_to_device)
            return
        if not self.use_buffer_reader:
            for b in source:
                yield to_device(b, self.device)
            return
        # double buffer: batch N+1's copies are issued before N is handed
        # out (non-blocking from pinned memory, in stream order)
        it = iter(source)
        try:
            nxt = to_device(next(it), self.device)
        except StopIteration:
            return
        for b in it:
            cur, nxt = nxt, to_device(b, self.device)
            yield cur
        yield nxt

    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True,
                       iterable=True, return_list=True,
                       use_multiprocess=False, drop_last=True, device=None):
        """The fluid-era generator loader: ``set_sample_generator``,
        ``set_sample_list_generator`` or ``set_batch_generator`` gives it
        its reader; batches come out on ``device``."""
        return _GeneratorLoader(capacity, resolve_device(device))

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True, device=None):
        return DataLoader(dataset, drop_last=drop_last, places=places,
                          device=device)


class _GeneratorLoader:
    def __init__(self, capacity, device):
        self._gen = None
        self.capacity = capacity
        self.device = device

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        from ..batch import batch as batch_reader
        self._gen = lambda: (default_collate_fn(b)
                             for b in batch_reader(reader, batch_size,
                                                   drop_last)())
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._gen = lambda: (default_collate_fn(b) for b in reader())
        return self

    def set_batch_generator(self, reader, places=None):
        self._gen = lambda: iter(reader())
        return self

    def __iter__(self):
        for b in self._gen():
            yield to_device(b, self.device)

    def __call__(self):
        return iter(self)
