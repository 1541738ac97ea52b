"""Device prefetch of training batches. Counterpart of
``paddle_tpu/io/dataloader.py`` ``DevicePrefetcher`` (the feed
``engine.fit(prefetch=)`` uses).

The reference uploads batches from a background thread (``device_put``
is asynchronous). Here the copies themselves are asynchronous, so no
thread is needed: each host leaf (a numpy array or a CPU tensor) is copied
into pinned host memory and from there to the device with
``non_blocking=True`` on a side CUDA stream, ``depth`` batches ahead of
the one being used. Before a batch is handed out, the consumer's current
stream waits for the side stream (``wait_stream``: the step's kernels
read the batch only after its copies land), and every tensor handed out
is marked as used by the current stream (``record_stream``), so the
caching allocator does not give its memory to another tensor while the
step still reads it. Leaves already on the device pass through. On the
CPU (``device='cpu'``) the leaves just become tensors.
"""
import collections

import numpy as np
import torch

__all__ = ['DevicePrefetcher', 'to_device']


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def upload(leaf, device):
    """One leaf on ``device``: a numpy array becomes a tensor; a host
    tensor bound for CUDA is copied from pinned memory with
    ``non_blocking=True`` (in the current stream's order); a leaf already
    there, or not an array, passes through."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    if not isinstance(leaf, torch.Tensor) or leaf.device == device:
        return leaf
    if device.type != 'cuda':
        return leaf.to(device)
    if not leaf.is_pinned():
        leaf = leaf.pin_memory()
    return leaf.to(device, non_blocking=True)


def to_device(batch, device):
    """``batch`` (nested tuples, lists and dicts) with every leaf
    ``upload``ed to ``device``."""
    return _map(lambda leaf: upload(leaf, device), batch)


def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _leaves(v)
    elif isinstance(batch, torch.Tensor):
        yield batch


class DevicePrefetcher:
    """Iterate ``source``'s batches (nested tuples, lists and dicts of
    numpy arrays or tensors) as tensors on ``device``, with up to
    ``depth`` batches in flight."""

    def __init__(self, source, device, depth=2):
        self.source = source
        self.device = torch.device(device)
        self.depth = max(int(depth), 1)

    def __iter__(self):
        it = iter(self.source)
        if self.device.type != 'cuda':
            for batch in it:
                yield to_device(batch, self.device)
            return
        side = torch.cuda.Stream(device=self.device)
        ahead = collections.deque()

        def fill():
            while len(ahead) < self.depth:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                with torch.cuda.stream(side):
                    ahead.append(to_device(batch, self.device))
        fill()
        while ahead:
            batch = ahead.popleft()
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(side)
            for t in _leaves(batch):
                if t.device == self.device:
                    t.record_stream(current)
            fill()
            yield batch
