"""Serving runtime of the port: multi-tenant one-shot batching and
generative decode with continuous batching over a paged (default) or
fixed-slot KV cache, with per-tenant quotas and weighted-fair admission
(``admission``), SLOs, cancel and kill, and telemetry on
``paddle_tpu_torch.observability``. Counterpart of ``paddle_tpu/serving``
(engine, runners, scheduler, bucketing, kv_cache, paged_kv, paged_runner,
admission); the fleet layer (router, fleet supervisor, autoscaler) comes
with ROADMAP.md, Queue 1 item 4c."""
from . import admission, kv_cache, paged_kv, paged_runner
from .admission import (DEFAULT_TENANT, QuotaExceededError, TenantArbiter,
                        TenantPolicy, WeightedFairQueue, tenant_stats)
from .bucketing import (DEFAULT_BATCH_BUCKETS, BucketSpec, pad_to_bucket,
                        select_bucket, stack_examples)
from .engine import Endpoint, EngineDeadError, ServingEngine
from .kv_cache import GenerativeSpec, TinyCausalLM
from .paged_kv import (PageAllocator, PagesExhaustedError, PrefixCache,
                       chain_hashes)
from .paged_runner import PagedGenerativeRunner
from .runners import BatchRunner, GenerativeRunner
from .scheduler import (STATUS_CANCELLED, STATUS_DEADLINE, STATUS_ERROR,
                        STATUS_OK, AdmissionQueue, PendingRequest,
                        QueueFullError, Request, Response, WatchdogTimeout)

__all__ = ['DEFAULT_BATCH_BUCKETS', 'BucketSpec', 'pad_to_bucket',
           'select_bucket', 'stack_examples', 'Endpoint', 'EngineDeadError',
           'ServingEngine', 'TenantPolicy', 'TenantArbiter',
           'WeightedFairQueue', 'QuotaExceededError', 'DEFAULT_TENANT',
           'tenant_stats', 'GenerativeSpec', 'TinyCausalLM', 'PageAllocator',
           'PagesExhaustedError', 'PrefixCache', 'chain_hashes',
           'PagedGenerativeRunner', 'BatchRunner', 'GenerativeRunner',
           'STATUS_CANCELLED', 'STATUS_DEADLINE', 'STATUS_ERROR',
           'STATUS_OK', 'AdmissionQueue', 'PendingRequest', 'QueueFullError',
           'Request', 'Response', 'WatchdogTimeout', 'admission', 'kv_cache',
           'paged_kv', 'paged_runner']
