"""Datasets. The port's own copy of ``paddle_tpu/io/dataset.py``
(``Dataset``, ``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset``, ``random_split``), which
is pure Python and numpy.

``TensorDataset`` takes torch tensors or numpy arrays (anything that
indexes along its first axis). ``random_split`` draws its permutation from
numpy's global state, as the reference does, so one ``np.random.seed``
splits alike in both packages.
"""
import bisect

import numpy as np

__all__ = ['Dataset', 'IterableDataset', 'TensorDataset', 'ComposeDataset',
           'ChainDataset', 'ConcatDataset', 'Subset', 'random_split']


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement __getitem__".format(type(self).__name__))

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement __len__".format(type(self).__name__))


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement __iter__".format(type(self).__name__))

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Samples ``tuple(t[i] for t in tensors)``: torch tensors or numpy
    arrays that share their first dimension."""

    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError(f"TensorDataset: tensors must share dim 0, got "
                             f"lengths {sorted(lens)}")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        lens = {len(d) for d in self.datasets}
        if len(lens) != 1:
            raise ValueError(f"ComposeDataset: datasets must share their "
                             f"length, got {sorted(lens)}")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - start]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split ``dataset`` into ``Subset``s of ``lengths`` along one
    ``np.random.permutation`` (numpy's global state; ``generator`` is
    accepted for the reference's signature and not used, as there)."""
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out
