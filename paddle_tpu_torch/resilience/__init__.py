"""Resilience of the port's training. Counterpart of
``paddle_tpu/resilience``:

- atomic checkpoint I/O (``atomic_io``, ``CheckpointManager``): temp +
  fsync + os.replace commits, CRC32-stamped manifests, keep-last-N
  rotation, and load-time fallback to the newest non-corrupt checkpoint;
- preemption-safe training (``PreemptionGuard``, ``engine.fit(checkpoint=,
  resume_from=, preempt_save=)``): SIGTERM checkpoints before exit, and a
  resume restores the loop position, the optimizer slots, the dropout
  streams and the loss scale for a bitwise-identical continuation;
- a NaN/Inf step guard (``NanGuard``) that skips poisoned updates and
  reports them to the dynamic ``GradScaler``;
- bounded ``retry`` with exponential backoff + jitter;
- async and per-rank sharded checkpoints (``async_checkpoint``);
- bounded waits and liveness (``watchdog``: ``bounded_get``,
  ``join_thread``, ``join_proc``, ``wait_proc``, the supervisor's
  ``Heartbeat`` and ``heartbeat_age``).

``faultinject`` produces each of the failures above deterministically, so
the whole layer is testable on the CPU. The resharding restore
(``CheckpointManager.restore(sharding=)``,
``async_checkpoint.place_with_config``) places a checkpoint written at any
world size onto this rank's pieces, the tensor-parallel ones included (a
save at (data 2, model 2) restores at (1, 2) and unsharded).
"""
from . import async_checkpoint, atomic_io, faultinject, watchdog
from .atomic_io import (AtomicWriteError, atomic_open, atomic_pickle_dump,
                        atomic_write, crc32_bytes, crc32_file)
from .checkpoint import CheckpointManager, capture_rng, restore_rng
from .nanguard import NanGuard, NanStepError
from .preempt import PreemptionGuard
from .retry import RetryError, retry
from .watchdog import (Heartbeat, WatchdogTimeout, bounded_get,
                       heartbeat_age, join_proc, join_thread, wait_proc)

__all__ = ['atomic_open', 'atomic_write', 'atomic_pickle_dump',
           'crc32_file', 'crc32_bytes',
           'AtomicWriteError', 'retry', 'RetryError', 'PreemptionGuard',
           'NanGuard', 'NanStepError', 'CheckpointManager', 'capture_rng',
           'restore_rng', 'atomic_io', 'async_checkpoint', 'faultinject',
           'watchdog', 'WatchdogTimeout', 'bounded_get', 'join_thread',
           'join_proc', 'wait_proc', 'Heartbeat', 'heartbeat_age']
