"""Serving runtime of the port: multi-tenant one-shot batching and
generative decode with continuous batching over a paged (default) or
fixed-slot KV cache, with per-tenant quotas and weighted-fair admission
(``admission``), SLOs, cancel and kill, telemetry on
``paddle_tpu_torch.observability``, and the fleet layer above the engine:
``FleetRouter`` (health-gated failover, hedging, drain, the circuit
breaker, the shed ladder, prefix affinity), ``FleetSupervisor`` (reap and
relaunch a dead replica) and ``FleetAutoscaler`` (grow and shrink on SLO
burn). Counterpart of ``paddle_tpu/serving``."""
from . import (admission, autoscaler, fleet_supervisor, kv_cache, paged_kv,
               paged_runner, router)
from .admission import (DEFAULT_TENANT, QuotaExceededError, TenantArbiter,
                        TenantPolicy, WeightedFairQueue, tenant_stats)
from .autoscaler import FleetAutoscaler
from .bucketing import (DEFAULT_BATCH_BUCKETS, BucketSpec, pad_to_bucket,
                        select_bucket, stack_examples)
from .engine import Endpoint, EngineDeadError, ServingEngine
from .fleet_supervisor import FleetSupervisor
from .kv_cache import GenerativeSpec, TinyCausalLM
from .paged_kv import (PageAllocator, PagesExhaustedError, PrefixCache,
                       chain_hashes)
from .paged_runner import PagedGenerativeRunner
from .router import (CircuitBreaker, FleetOverloadError, FleetPending,
                     FleetRouter, NoHealthyReplicaError, ReplicaError,
                     ReplicaHandle, RouterPolicy)
from .runners import BatchRunner, GenerativeRunner
from .scheduler import (STATUS_CANCELLED, STATUS_DEADLINE, STATUS_ERROR,
                        STATUS_OK, AdmissionQueue, PendingRequest,
                        QueueFullError, Request, Response, WatchdogTimeout)

__all__ = ['DEFAULT_BATCH_BUCKETS', 'BucketSpec', 'pad_to_bucket',
           'select_bucket', 'stack_examples', 'Endpoint', 'EngineDeadError',
           'ServingEngine', 'FleetRouter', 'RouterPolicy', 'ReplicaHandle',
           'CircuitBreaker', 'FleetPending', 'ReplicaError',
           'NoHealthyReplicaError', 'FleetOverloadError', 'FleetSupervisor',
           'FleetAutoscaler', 'TenantPolicy', 'TenantArbiter',
           'WeightedFairQueue', 'QuotaExceededError', 'DEFAULT_TENANT',
           'tenant_stats', 'GenerativeSpec', 'TinyCausalLM', 'PageAllocator',
           'PagesExhaustedError', 'PrefixCache', 'chain_hashes',
           'PagedGenerativeRunner', 'BatchRunner', 'GenerativeRunner',
           'STATUS_CANCELLED', 'STATUS_DEADLINE', 'STATUS_ERROR',
           'STATUS_OK', 'AdmissionQueue', 'PendingRequest', 'QueueFullError',
           'Request', 'Response', 'WatchdogTimeout', 'admission',
           'autoscaler', 'fleet_supervisor', 'kv_cache', 'paged_kv',
           'paged_runner', 'router']
