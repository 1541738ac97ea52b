"""Fixed bucket shapes for one-shot serving. A copy of the pure-numpy
``paddle_tpu/serving/bucketing.py`` (the port imports nothing of the
reference, so it keeps its own).

In the reference the closed shape set is the retrace firewall of ``jit``.
The port runs eagerly, but the same closed set still bounds the batch
shapes the kernels and matrix products see: every batch is padded up to
the nearest of a small, fixed list of bucket sizes, and ``warmup()`` runs
each bucket once before traffic arrives.

Helpers here are pure shape math + numpy padding; they run on the host
before anything reaches the device.
"""
import numpy as np

__all__ = ['DEFAULT_BATCH_BUCKETS', 'BucketSpec', 'select_bucket',
           'pad_to_bucket', 'stack_examples']

# Powers of two up to 16: small enough that warmup is cheap, dense enough
# that padding waste is bounded by 2x at every load level.
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)


def select_bucket(n, buckets):
    """Smallest bucket >= ``n``. Raises ValueError when ``n`` exceeds the
    largest bucket (callers split such batches, they never grow a bucket —
    a grown bucket is a fresh compile in the hot path)."""
    if n <= 0:
        raise ValueError(f"select_bucket: need a positive size, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"select_bucket: size {n} exceeds the largest bucket "
        f"{max(buckets)} — split the batch or configure larger buckets")


def pad_to_bucket(arr, bucket, axis=0, fill=0):
    """Pad ``arr`` with ``fill`` along ``axis`` up to length ``bucket``.

    The inverse is a plain slice (``out[:n]``); callers keep the real
    length themselves. Never truncates — a too-long input is a caller bug.
    """
    arr = np.asarray(arr)
    n = arr.shape[axis]
    if n > bucket:
        raise ValueError(
            f"pad_to_bucket: length {n} exceeds bucket {bucket} on "
            f"axis {axis}")
    if n == bucket:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, bucket - n)
    return np.pad(arr, widths, mode='constant', constant_values=fill)


def stack_examples(examples, bucket, fill=0):
    """Stack per-request example arrays into one ``[bucket, ...]`` batch.

    ``examples`` is a non-empty list of same-shape arrays (one request
    each); rows beyond ``len(examples)`` are ``fill``-padding. Shape
    mismatches raise — the closed shape set is enforced at admission, not
    discovered as a recompile later.
    """
    first = np.asarray(examples[0])
    for i, e in enumerate(examples[1:], 1):
        e = np.asarray(e)
        if e.shape != first.shape or e.dtype != first.dtype:
            raise ValueError(
                f"stack_examples: example {i} has shape/dtype "
                f"{e.shape}/{e.dtype}, expected {first.shape}/{first.dtype}"
                " — serving inputs must match the registered example spec")
    batch = np.stack([np.asarray(e) for e in examples], axis=0)
    return pad_to_bucket(batch, bucket, axis=0, fill=fill)


class BucketSpec:
    """The closed shape set of one served model.

    - ``batch_buckets``: allowed padded batch sizes (sorted ascending).
    - ``length_buckets``: optional allowed padded lengths for the leading
      (sequence) axis of variable-length inputs — e.g. prompt-length
      buckets for the generative prefill path. ``None`` means inputs are
      fixed-shape and only the batch axis is padded.
    """

    def __init__(self, batch_buckets=DEFAULT_BATCH_BUCKETS,
                 length_buckets=None):
        if not batch_buckets:
            raise ValueError("BucketSpec: batch_buckets must be non-empty")
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if any(b <= 0 for b in self.batch_buckets):
            raise ValueError("BucketSpec: batch buckets must be positive")
        self.length_buckets = None
        if length_buckets is not None:
            self.length_buckets = tuple(
                sorted(set(int(b) for b in length_buckets)))
            if any(b <= 0 for b in self.length_buckets):
                raise ValueError("BucketSpec: length buckets must be positive")

    @property
    def max_batch(self):
        return self.batch_buckets[-1]

    def batch_bucket(self, n):
        return select_bucket(n, self.batch_buckets)

    def length_bucket(self, n):
        if self.length_buckets is None:
            raise ValueError("BucketSpec: no length buckets configured")
        return select_bucket(n, self.length_buckets)

    def __repr__(self):
        return (f"BucketSpec(batch={list(self.batch_buckets)}, "
                f"length={list(self.length_buckets) if self.length_buckets else None})")
