"""One-shot model runner: how one scheduler step turns queued requests into
a batch. Counterpart of ``paddle_tpu/serving/runners.py`` (``BatchRunner``).

Each engine step re-packs the queue into the smallest bucket that fits
(dynamic batching), moves the numpy feeds to the engine's device, runs the
batch callable eagerly (the reference wraps it in ``CachedJit``; PyTorch
has no counterpart the port needs) and hands each request its slice of
the numpy outputs. The generative runners come with a later slice.
"""
import time

import numpy as np
import torch

from .bucketing import BucketSpec, stack_examples
from .scheduler import STATUS_DEADLINE, STATUS_ERROR, STATUS_OK

__all__ = ['BatchRunner']


def _to_numpy(outs):
    """Device outputs -> numpy through dict/tuple/list structure."""
    if isinstance(outs, dict):
        return {k: _to_numpy(v) for k, v in outs.items()}
    if isinstance(outs, (list, tuple)):
        return type(outs)(_to_numpy(v) for v in outs)
    if isinstance(outs, torch.Tensor):
        return outs.detach().cpu().numpy()
    return np.asarray(outs)


def _slice_outputs(outs, i):
    """Per-request view of batched outputs: slice leading axis ``i``
    through dict/tuple/list structure."""
    if isinstance(outs, dict):
        return {k: _slice_outputs(v, i) for k, v in outs.items()}
    if isinstance(outs, (list, tuple)):
        return type(outs)(_slice_outputs(v, i) for v in outs)
    return np.asarray(outs)[i]


class _Stats:
    """Plain always-on tallies."""

    def __init__(self):
        self.completed = 0
        self.expired = 0
        self.errors = 0
        self.batches = 0
        self._occ_sum = 0.0

    def occupancy(self, frac):
        self._occ_sum += frac

    def as_dict(self):
        return {
            'completed': self.completed, 'expired': self.expired,
            'errors': self.errors, 'batches': self.batches,
            'mean_batch_occupancy': (
                round(self._occ_sum / self.batches, 4)
                if self.batches else 0.0),
        }


class BatchRunner:
    """Dynamic batching over a one-shot batched callable.

    ``batch_fn(feeds)`` takes ``{name: tensor [B, ...]}`` on ``device`` and
    returns a tensor / tuple / dict with a leading batch axis. ``example``
    (one request's inputs, no batch axis) pins the shape/dtype spec:
    submits that disagree are rejected at admission and warmup knows what
    zeros to feed.
    """

    def __init__(self, name, queue, batch_fn, example, device,
                 bucket_spec=None):
        self.name = name
        self.queue = queue
        self.spec = bucket_spec or BucketSpec()
        self.example = {k: np.asarray(v) for k, v in example.items()}
        self.device = device
        self._fn = batch_fn
        self.stats = _Stats()

    def validate(self, req):
        missing = sorted(set(self.example) - set(req.inputs))
        if missing:
            raise ValueError(
                f"serving[{self.name}]: request missing inputs {missing}")
        for k, ex in self.example.items():
            a = np.asarray(req.inputs[k])
            if a.shape != ex.shape or a.dtype != ex.dtype:
                raise ValueError(
                    f"serving[{self.name}]: input {k!r} has shape/dtype "
                    f"{a.shape}/{a.dtype}, registered example is "
                    f"{ex.shape}/{ex.dtype} — serving shapes are a closed "
                    "set (see serving.bucketing); pad client-side or "
                    "register a matching model")

    def has_work(self):
        return len(self.queue) > 0

    def _run(self, batch):
        feeds = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}
        return _to_numpy(self._fn(feeds))

    def warmup(self):
        """Run every bucket once with zero feeds (first-call set-up, such as
        the kernel build, happens here and not under traffic) -> the number
        of buckets run."""
        for b in self.spec.batch_buckets:
            self._run({k: np.zeros((b,) + ex.shape, ex.dtype)
                       for k, ex in self.example.items()})
        return len(self.spec.batch_buckets)

    def step(self):
        ready, expired = self.queue.pop_ready(self.spec.max_batch)
        for r in expired:
            self.stats.expired += 1
            r.complete(STATUS_DEADLINE)
        if not ready:
            return bool(expired)
        bucket = self.spec.batch_bucket(len(ready))
        batch = {k: stack_examples([r.inputs[k] for r in ready], bucket)
                 for k in self.example}
        self.stats.batches += 1
        self.stats.occupancy(len(ready) / bucket)
        try:
            t0 = time.perf_counter()
            outs = self._run(batch)
            ms = 1000.0 * (time.perf_counter() - t0)
            for r in ready:
                r.add_phase_ms('run', ms)
            # slice before completing anything: a malformed output (e.g. no
            # leading batch axis) must fail the whole batch, not the engine
            per_req = [_slice_outputs(outs, i) for i in range(len(ready))]
        except Exception as e:                       # model bug: fail the
            for r in ready:                          # batch, not the engine
                self.stats.errors += 1
                r.complete(STATUS_ERROR, error=e)
            return True
        for r, out in zip(ready, per_req):
            self.stats.completed += 1
            status = STATUS_DEADLINE if r.expired() else STATUS_OK
            if status == STATUS_DEADLINE:
                self.stats.expired += 1
            r.complete(status, out)
        return True
