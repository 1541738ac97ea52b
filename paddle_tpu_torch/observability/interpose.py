"""Interposed runtime counters: kernel builds and host transfers.
The port's counterpart of ``paddle_tpu/observability/interpose.py``.

- **kernel builds**: where the reference's ``install_jax_hooks()`` counts
  every jaxpr trace and XLA compile through ``jax.monitoring``, the port
  has one compile step of its own: ``kernels._build.build()``, which runs
  ``nvcc`` over ``kernels/csrc`` when no library for the sources' digest
  exists yet. ``install_build_hooks()`` registers a listener there;
  each build adds one to ``kernels.builds`` and its milliseconds to
  ``kernels.build_ms`` (and to the ``kernels.build_duration_ms``
  histogram). A library reused from an earlier build counts nothing.
- **host transfers**: the serving runners and the train step's loss
  fetch and state sync call ``record_host_transfer(nbytes)`` where they
  copy to the host; ``host_transfer.bytes`` is the "how much crosses
  PCIe" number.
- ``record_collective(op, nbytes)``: every collective of
  ``distributed.collective`` (and the train step's, which go through it)
  counts ``collective.<op>.calls`` and ``collective.<op>.bytes``; those
  on a model-parallel axis under the axis's name
  (``collective.model.all_reduce.calls``, ``collective.seq.ppermute.bytes``,
  ``collective.pipe.ppermute.calls``), and a gloo group's CUDA collectives
  that run as all-reduces also as ``host_transfer.collective.gloo_cuda``.
"""
from . import registry, state

__all__ = ['install_build_hooks', 'record_host_transfer',
           'record_collective', 'summary']

_installed = [False]


def install_build_hooks():
    """Register the kernel-build listener once. Safe to call repeatedly;
    returns True when the hook is (already) in place. The listener guards
    on ``state.enabled()``, so a later ``disable()`` silences it."""
    if _installed[0]:
        return True
    from ..kernels import _build
    if _on_build not in _build.build_listeners:
        _build.build_listeners.append(_on_build)
    _installed[0] = True
    return True


def _on_build(ms):
    if not state.enabled():
        return
    registry.counter('kernels.builds').inc()
    registry.counter('kernels.build_ms').inc(ms)
    registry.histogram('kernels.build_duration_ms').observe(ms)


def record_host_transfer(nbytes, kind='device_get'):
    """Count one device->host copy of ``nbytes`` bytes."""
    if not state.enabled():
        return
    registry.counter('host_transfer.calls').inc()
    registry.counter('host_transfer.bytes').inc(int(nbytes))
    registry.counter(f'host_transfer.{kind}.bytes').inc(int(nbytes))


def record_collective(op, nbytes):
    """Count one collective launch of ``nbytes`` payload bytes."""
    if not state.enabled():
        return
    registry.counter(f'collective.{op}.calls').inc()
    registry.counter(f'collective.{op}.bytes').inc(int(nbytes))


def summary():
    """The headline interposed counters: kernel builds, build ms,
    host-transfer traffic, the training and fault-tolerance tallies, the
    serving tallies and the cost ledger's. The reference's
    ``jax_traces`` / ``jax_compiles`` / ``jax_compile_ms`` are
    ``kernel_builds`` / ``kernel_build_ms`` here (the port has no trace
    to count); its distributed keys read ``distributed/``'s counters,
    the model-parallel axes' under ``collective.<axis>.<op>``."""
    snap = registry.snapshot()['counters']
    return {
        'kernel_builds': snap.get('kernels.builds', 0),
        'kernel_build_ms': round(float(snap.get('kernels.build_ms', 0)), 3),
        'host_transfer_bytes': snap.get('host_transfer.bytes', 0),
        'host_transfer_calls': snap.get('host_transfer.calls', 0),
        'engine_steps': snap.get('engine.steps', 0),
        'engine_loss_fetch_bytes': snap.get(
            'host_transfer.engine.loss_fetch.bytes', 0),
        'worker_restarts': snap.get('dataloader.worker_restarts', 0),
        'quarantined_samples': snap.get('dataloader.quarantined', 0),
        'watchdog_timeouts': snap.get('dataloader.watchdog_timeouts', 0),
        'dist_timeouts': snap.get('distributed.timeouts', 0),
        'rank_failures': snap.get('distributed.rank_failures', 0),
        'rank_restarts': snap.get('distributed.rank_restarts', 0),
        'serving_requests': snap.get('serving.requests', 0),
        'serving_shed': snap.get('serving.shed', 0),
        'serving_shed_queue_full': snap.get('serving.shed.queue_full', 0),
        'serving_shed_page_exhaustion': snap.get(
            'serving.shed.page_exhaustion', 0),
        'serving_shed_quota': snap.get('serving.shed.quota', 0),
        'serving_deadline_expired': snap.get('serving.deadline_expired', 0),
        'serving_kv_decode_stalls': snap.get('serving.kv.decode_stalls', 0),
        'serving_kv_prefill_stalls': snap.get(
            'serving.kv.prefill_stalls', 0),
        'serving_preemptions': snap.get('serving.preemptions', 0),
        'serving_prefix_hit_pages': snap.get(
            'serving.kv.prefix_hit_pages', 0),
        'serving_spec_proposed': snap.get('serving.spec.proposed', 0),
        'serving_spec_accepted': snap.get('serving.spec.accepted', 0),
        'slo_requests': snap.get('slo.requests_total', 0),
        'slo_violations': snap.get('slo.violations_total', 0),
        'cost_programs': snap.get('cost.programs', 0),
        'cost_captures': snap.get('cost.captures', 0),
    }
