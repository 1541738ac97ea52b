"""Samplers. The port's own copy of ``paddle_tpu/io/sampler.py``
(``Sampler``, ``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``BatchSampler``, ``DistributedBatchSampler``).

The random draws come from numpy's global state (``np.random.
permutation``, ``randint``, ``choice``), as the reference's do: one
``np.random.seed`` gives the same batch order in both packages, and the
port's ``resilience.capture_rng`` (which holds numpy's state) replays an
epoch's shuffle on resume. ``DistributedBatchSampler`` without
``num_replicas``/``rank`` reads them from ``torch.distributed`` when a
process group is up (else one replica, rank 0), where the reference asks
its mesh.
"""
import math

import numpy as np

__all__ = ['Sampler', 'SequenceSampler', 'RandomSampler',
           'WeightedRandomSampler', 'BatchSampler',
           'DistributedBatchSampler']


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, size=self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__()
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of the ``torch.distributed`` group, or (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards batches across data-parallel ranks: the indices (shuffled
    with ``RandomState(epoch)`` when ``shuffle``) padded to a multiple of
    the replicas, every ``num_replicas``-th one this rank's."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            world, own = _world()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else own
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        # pad to be divisible
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]]).astype(int)
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
