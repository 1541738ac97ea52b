"""One-shot serving runtime of the port. Counterpart of
``paddle_tpu/serving`` (engine, runners, scheduler, bucketing)."""
from .bucketing import (DEFAULT_BATCH_BUCKETS, BucketSpec, pad_to_bucket,
                        select_bucket, stack_examples)
from .engine import Endpoint, ServingEngine
from .runners import BatchRunner
from .scheduler import (STATUS_DEADLINE, STATUS_ERROR, STATUS_OK,
                        AdmissionQueue, PendingRequest, QueueFullError,
                        Request, Response, WatchdogTimeout)

__all__ = ['DEFAULT_BATCH_BUCKETS', 'BucketSpec', 'pad_to_bucket',
           'select_bucket', 'stack_examples', 'Endpoint', 'ServingEngine',
           'BatchRunner', 'STATUS_DEADLINE', 'STATUS_ERROR', 'STATUS_OK',
           'AdmissionQueue', 'PendingRequest', 'QueueFullError', 'Request',
           'Response', 'WatchdogTimeout']
