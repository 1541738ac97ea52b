"""Serving runtime of the port: one-shot batching and generative decode
with continuous batching over a paged (default) or fixed-slot KV cache.
Counterpart of ``paddle_tpu/serving`` (engine, runners, scheduler,
bucketing, kv_cache, paged_kv, paged_runner)."""
from . import kv_cache, paged_kv, paged_runner
from .bucketing import (DEFAULT_BATCH_BUCKETS, BucketSpec, pad_to_bucket,
                        select_bucket, stack_examples)
from .engine import Endpoint, ServingEngine
from .kv_cache import GenerativeSpec, TinyCausalLM
from .paged_kv import (PageAllocator, PagesExhaustedError, PrefixCache,
                       chain_hashes)
from .paged_runner import PagedGenerativeRunner
from .runners import BatchRunner, GenerativeRunner
from .scheduler import (STATUS_DEADLINE, STATUS_ERROR, STATUS_OK,
                        AdmissionQueue, PendingRequest, QueueFullError,
                        Request, Response, WatchdogTimeout)

__all__ = ['DEFAULT_BATCH_BUCKETS', 'BucketSpec', 'pad_to_bucket',
           'select_bucket', 'stack_examples', 'Endpoint', 'ServingEngine',
           'GenerativeSpec', 'TinyCausalLM', 'PageAllocator',
           'PagesExhaustedError', 'PrefixCache', 'chain_hashes',
           'PagedGenerativeRunner', 'BatchRunner', 'GenerativeRunner',
           'STATUS_DEADLINE', 'STATUS_ERROR', 'STATUS_OK', 'AdmissionQueue',
           'PendingRequest', 'QueueFullError', 'Request', 'Response',
           'WatchdogTimeout', 'kv_cache', 'paged_kv', 'paged_runner']
