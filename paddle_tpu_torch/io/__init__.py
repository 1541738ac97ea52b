"""Input feeding of the port. Counterpart of ``paddle_tpu/io``: datasets,
samplers, the ``DataLoader`` (batches on the CUDA device unless
``device='cpu'``), the device prefetcher ``engine.fit`` feeds its steps
with, and the reference's top-level re-exports ``batch``, ``save`` and
``load``.

Not here yet: the reader decorators (``map_readers``, ``shuffle``, ...)
with ``reader/``, and ``save_inference_model`` / ``load_inference_model`` /
``load_program_state`` / ``set_program_state`` with ``static/`` (ROADMAP.md,
Queue 1).
"""
import os

from ..batch import batch
from ..framework import load, save
from .dataloader import (DataLoader, DataLoaderWorkerError,
                         default_collate_fn, default_convert_fn)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .prefetch import DevicePrefetcher
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ['Dataset', 'IterableDataset', 'TensorDataset', 'ComposeDataset',
           'ChainDataset', 'ConcatDataset', 'Subset', 'random_split',
           'Sampler', 'SequenceSampler', 'RandomSampler',
           'WeightedRandomSampler', 'BatchSampler', 'DistributedBatchSampler',
           'DataLoader', 'DataLoaderWorkerError', 'DevicePrefetcher',
           'default_collate_fn', 'default_convert_fn', 'batch', 'save',
           'load', 'get_worker_info']


class _WorkerInfo:
    def __init__(self, wid, num):
        self.id = wid
        self.num_workers = num


def get_worker_info():
    """DataLoader worker context, as the reference's: None outside a
    worker process (the port's workers are threads, so always None unless
    ``PADDLE_DATALOADER_WORKER_ID`` is set, as a process pool sets it)."""
    wid = os.environ.get('PADDLE_DATALOADER_WORKER_ID')
    if wid is None:
        return None
    return _WorkerInfo(int(wid),
                       int(os.environ.get('PADDLE_DATALOADER_NUM_WORKERS',
                                          '1')))
