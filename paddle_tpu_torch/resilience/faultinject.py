"""Deterministic fault injection: make every resilience behavior testable.
The port's own copy of ``paddle_tpu/resilience/faultinject.py`` (stdlib
only at import time).

The harness produces exactly the failures the resilience layer defends
against, on the CPU, deterministically:

- ``fail_writes`` — the next N atomic writes raise before commit (torn-write
  crash model; destinations must stay intact);
- ``corrupt_file``/``truncate_file`` — flip or drop committed bytes (disk
  corruption model; manifests must catch it);
- ``flaky`` — wrap a callable to fail its first N calls (transient-network
  model for retry());
- ``poison_loss`` — wrap a loss fn to return NaN at chosen global steps
  (NaN-guard model);
- ``PreemptAtStep`` — a hapi callback that delivers a real SIGTERM to this
  process at a chosen global batch (preemption model);
- ``poison_sample`` / ``kill_worker`` / ``hang_worker`` — Dataset wrappers
  producing a raising sample, a worker-process SIGKILL, or a worker hang at
  chosen indices (DataLoader quarantine / respawn / watchdog models);
- ``slow_rank`` — a picklable spawn-func wrapper adding a delay on one rank
  (straggler model for collective deadlines);
- ``slow_model`` — wrap a serving batch callable to sleep before every
  batch (overloaded-backend model for deadline expiry / load shedding);
- ``latency_ramp`` — wrap a callable so each call sleeps a little longer
  than the last (slow-degradation model: no call is an outlier, only the
  trend is wrong — drives the doctor's ``latency_creep`` detector);
- ``slow_loader`` — Dataset wrapper sleeping before EVERY sample (the
  input-bound model the anomaly doctor's dataloader-wait detector names);
- ``slow_collective`` — every collective of ``distributed/`` sleeps
  first, against ``distributed.set_timeout``'s deadline; ``boot_fail`` —
  a supervised ``spawn`` rank crashes before its started marker, the
  case ``max_restarts`` restarts (the model-parallel collectives,
  ``ppermute`` included, go through the same deadline and sleep too);
- ``retrace_bait`` and ``corrupt_compile_cache`` act on a subsystem the
  port does not have yet: each raises ``NotImplementedError`` naming where
  it comes (ROADMAP.md, Queue 1 item 7: ``compilecache/``, whose
  ``kernels.builds`` counter takes the place of the reference's
  ``jax.compiles``);
- ``kill_replica_at_request`` / ``hang_replica`` / ``slow_replica`` —
  serving-replica chaos (siblings of ``kill_rank_at_step``/``slow_rank``):
  abrupt engine death right after admitting the Nth request, a wedged
  scheduler that stays "alive" while nothing progresses, and a per-pump
  delay producing a deterministic p99 straggler for hedging tests;
- ``tenant_storm`` — deterministic Poisson request bursts from one tenant
  through ``submit()`` (engine, endpoint, or router) over VIRTUAL ticks —
  the noisy-neighbor model for per-tenant quotas, weighted-fair admission,
  and the doctor's ``noisy_neighbor`` detector; no wall-clock sleeps;
- ``burn_ramp`` — fabricate completed-request judgments straight into the
  SLO tracker so a model's error-budget burn rate reaches a chosen level
  deterministically (the sustained-burn model the fleet autoscaler's grow
  path and the doctor's ``slo_burn`` detector key on) without real traffic;
- ``hold_lock`` / ``RacingCall`` — the forced-interleaving hooks for data-
  race regression tests (graftlint GC001-class bugs): freeze a writer at
  its guarded critical section by holding the guard from the test thread,
  launch the racing call on a side thread with completion observability,
  assert it blocks, release, assert it lands. Deterministic: the schedule
  is pinned by the lock itself, not by sleeps.

All injectors are context-managed or idempotent to deactivate, so a failing
test cannot leak faults into the next one.
"""
import contextlib
import os
import signal
import time

from . import atomic_io

__all__ = ['FaultInjector', 'flaky', 'poison_loss', 'corrupt_file',
           'corrupt_compile_cache',
           'truncate_file', 'PreemptAtStep', 'InjectedWriteError',
           'poison_sample', 'kill_worker', 'hang_worker', 'slow_rank',
           'slow_model', 'latency_ramp', 'slow_loader', 'slow_collective',
           'retrace_bait',
           'boot_fail', 'PoisonedSampleError', 'slow_fs', 'disk_full',
           'sigterm_at_step', 'kill_rank_at_step', 'kill_replica_at_request',
           'hang_replica', 'slow_replica', 'ReplicaHang', 'hold_lock',
           'RacingCall', 'tenant_storm', 'burn_ramp']


class InjectedWriteError(OSError):
    """The injected failure for write faults."""


class FaultInjector:
    """Context manager arming write faults against atomic_io.

    >>> with FaultInjector().fail_writes(times=1, match='model'):
    ...     framework.save(state, 'model.pdparams')   # raises, untouched
    """

    def __init__(self):
        self._arms = []       # list of [stage, remaining, match]
        self._stream_arms = []   # list of [kind, param, match, remaining]
        self._prev_hook = None
        self._prev_stream = None
        self.triggered = 0

    def fail_writes(self, times=1, match=None, stage='write'):
        """Arm: the next ``times`` atomic writes whose destination contains
        ``match`` (substring; None = all) raise ``InjectedWriteError`` at
        ``stage`` ('write' = before any bytes, 'replace' = staged bytes
        written but commit rename never happens)."""
        self._arms.append([stage, times, match])
        return self

    def disk_full(self, after_bytes=0, match=None, times=1):
        """Arm: the next ``times`` atomic writes whose destination contains
        ``match`` hit ENOSPC once ``after_bytes`` staged bytes are down —
        the disk-fills-mid-shard model. The commit never happens, the temp
        is removed, and the destination (and every previously committed
        checkpoint) stays intact."""
        self._stream_arms.append(['enospc', int(after_bytes), match,
                                  int(times)])
        return self

    def slow_fs(self, delay_s, match=None):
        """Arm: every staged ``write()`` to a matching destination sleeps
        ``delay_s`` first — the NFS-on-a-bad-day model that makes a
        synchronous checkpoint save stall the training thread visibly (and
        an async one provably not)."""
        self._stream_arms.append(['slow', float(delay_s), match, None])
        return self

    def _hook(self, stage, path):
        for arm in self._arms:
            a_stage, remaining, match = arm
            if a_stage != stage or remaining <= 0:
                continue
            if match is not None and match not in os.fspath(path):
                continue
            arm[1] -= 1
            self.triggered += 1
            raise InjectedWriteError(
                "fault injection: forced %s failure for %r" % (stage, path))

    def _stream(self, path, so_far, chunk_len):
        for arm in self._stream_arms:
            kind, param, match, remaining = arm
            if match is not None and match not in os.fspath(path):
                continue
            if kind == 'slow':
                time.sleep(param)
            elif kind == 'enospc':
                if remaining <= 0 or so_far + chunk_len <= param:
                    continue
                arm[3] -= 1
                self.triggered += 1
                import errno
                raise OSError(
                    errno.ENOSPC,
                    "fault injection: no space left on device after "
                    "%d bytes of %r" % (so_far, path))

    def __enter__(self):
        # both hooks install unconditionally: arming disk_full/slow_fs
        # AFTER entering (like fail_writes allows) must work, not silently
        # inject nothing
        self._prev_hook = atomic_io._fault_hook
        atomic_io._fault_hook = self._hook
        self._prev_stream = atomic_io._stream_hook
        atomic_io._stream_hook = self._stream
        return self

    def __exit__(self, *exc):
        atomic_io._fault_hook = self._prev_hook
        atomic_io._stream_hook = self._prev_stream
        return False


def flaky(fn, fail_times=1, exc_factory=None):
    """Wrap ``fn`` to raise on its first ``fail_times`` calls, succeed after.
    The wrapper exposes ``.calls`` (total) and ``.failures`` (raised)."""
    state = {'calls': 0}

    def wrapper(*args, **kwargs):
        state['calls'] += 1
        if state['calls'] <= fail_times:
            if exc_factory is not None:
                raise exc_factory(state['calls'])
            raise ConnectionError(
                "fault injection: flaky call %d/%d failing"
                % (state['calls'], fail_times))
        return fn(*args, **kwargs)

    wrapper.state = state
    return wrapper


def poison_loss(loss_fn, at_steps):
    """Wrap a loss callable: at the given 0-based global call indices the
    returned loss is multiplied by NaN (keeps shape/dtype/graph so the guard
    sees exactly what a numeric blow-up produces)."""
    at_steps = set(int(s) for s in at_steps)
    state = {'calls': 0}

    def wrapper(*args, **kwargs):
        step = state['calls']
        state['calls'] += 1
        loss = loss_fn(*args, **kwargs)
        if step in at_steps:
            return loss * float('nan')
        return loss

    wrapper.state = state
    return wrapper


def corrupt_file(path, offset=0, nbytes=1):
    """Flip ``nbytes`` bytes of a committed file in place at ``offset``
    (negative offset = from end)."""
    size = os.path.getsize(path)
    if offset < 0:
        offset = max(0, size + offset)
    with open(path, 'r+b') as f:
        f.seek(offset)
        block = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in block))
    return path


def corrupt_compile_cache(cache_dir, n=None, mode='corrupt'):
    """Damage committed persistent-compile-cache entries: not ported yet,
    the port has no ``compilecache/`` (ROADMAP.md, Queue 1 item 7)."""
    raise NotImplementedError(
        "faultinject.corrupt_compile_cache is not ported to "
        "paddle_tpu_torch yet: it damages compilecache/ entries "
        "(ROADMAP.md, Queue 1 item 7)")


def truncate_file(path, keep_bytes=None, drop_bytes=None):
    """Truncate a committed file to ``keep_bytes`` (or drop ``drop_bytes``
    from the end) — the classic torn-write artifact."""
    size = os.path.getsize(path)
    if keep_bytes is None:
        keep_bytes = max(0, size - (drop_bytes if drop_bytes is not None
                                    else size // 2))
    with open(path, 'r+b') as f:
        f.truncate(keep_bytes)
    return path


class PoisonedSampleError(ValueError):
    """The injected failure for poisoned dataset samples."""


class _DatasetWrapper:
    """Picklable (top-level class) Dataset wrapper base: forwards len() and
    __getitem__, letting subclasses inject at chosen indices. Fork-safe —
    state is plain attributes copied into each worker."""

    def __init__(self, dataset, at_indices):
        self._dataset = dataset
        self._at = set(int(i) for i in at_indices)

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        if int(i) in self._at:
            self._inject(i)
        return self._dataset[i]

    def _inject(self, i):
        raise NotImplementedError


class _PoisonedDataset(_DatasetWrapper):
    def _inject(self, i):
        raise PoisonedSampleError(
            f"fault injection: poisoned sample at index {i}")


def poison_sample(dataset, at_indices):
    """Dataset wrapper raising ``PoisonedSampleError`` for the given
    indices — the corrupt-record model the DataLoader quarantine defends
    against."""
    return _PoisonedDataset(dataset, at_indices)


class _KillerDataset(_DatasetWrapper):
    """SIGKILL the current process when a chosen index is fetched — but
    only in a process that is NOT the one that built the wrapper, so a
    threaded DataLoader (or the parent's shm-probe fetch) can never shoot
    the trainer itself. ``once_file`` (required) makes the kill one-shot
    across respawns: the first victim leaves a marker, the respawned
    worker survives the same index."""

    def __init__(self, dataset, at_indices, once_file):
        super().__init__(dataset, at_indices)
        self._owner_pid = os.getpid()
        self._once_file = os.fspath(once_file)

    def _inject(self, i):
        if os.getpid() == self._owner_pid:
            return   # parent/threaded fetch: never kill the trainer
        if os.path.exists(self._once_file):
            return   # already fired once; the respawned worker survives
        with open(self._once_file, 'w'):
            pass
        os.kill(os.getpid(), signal.SIGKILL)


def kill_worker(dataset, at_index, once_file):
    """Dataset wrapper that SIGKILLs the (process) worker fetching
    ``at_index``, once — the crashed-worker model for respawn tests."""
    return _KillerDataset(dataset, [at_index], once_file)


class _HangingDataset(_DatasetWrapper):
    def __init__(self, dataset, at_indices, hang_s):
        super().__init__(dataset, at_indices)
        self._hang_s = float(hang_s)

    def _inject(self, i):
        time.sleep(self._hang_s)


def hang_worker(dataset, at_index, hang_s=5.0):
    """Dataset wrapper that sleeps ``hang_s`` seconds fetching
    ``at_index`` — the wedged-worker model for the deadlock watchdog."""
    return _HangingDataset(dataset, [at_index], hang_s)


class _SlowRankFn:
    """Picklable spawn-func wrapper: rank ``rank`` sleeps ``delay_s``
    before running — the straggler model for collective deadlines and
    join(timeout) supervision."""

    def __init__(self, fn, rank, delay_s):
        self.fn = fn
        self.rank = int(rank)
        self.delay_s = float(delay_s)

    def __call__(self, *args, **kwargs):
        if int(os.environ.get('PADDLE_TRAINER_ID', '0')) == self.rank:
            time.sleep(self.delay_s)
        return self.fn(*args, **kwargs)


def slow_rank(fn, rank, delay_s):
    return _SlowRankFn(fn, rank, delay_s)


def slow_model(fn, delay_s):
    """Wrap a serving batch callable so every batch sleeps ``delay_s``
    seconds first — the overloaded-backend model that drives serving
    deadline expiry and admission-queue load shedding deterministically
    on CPU (the serving-side sibling of ``slow_rank``)."""
    delay_s = float(delay_s)

    def slowed(*args, **kwargs):
        time.sleep(delay_s)
        return fn(*args, **kwargs)
    return slowed


def latency_ramp(fn, per_call_ms, start_ms=0.0):
    """Wrap a callable so call ``k`` sleeps ``start_ms + k*per_call_ms``
    milliseconds first — each call a little slower than the last. The
    slow-degradation model (resource exhaustion, fragmentation, thermal
    creep) behind the doctor's ``latency_creep`` detector: no single call
    is an outlier, only the TREND is wrong, which is exactly what a
    point-in-time snapshot cannot see. Deterministic: the ramp depends
    only on the call count. ``slowed.calls`` exposes it."""
    per_call_s = float(per_call_ms) / 1e3
    start_s = float(start_ms) / 1e3

    def slowed(*args, **kwargs):
        time.sleep(start_s + slowed.calls * per_call_s)
        slowed.calls += 1
        return fn(*args, **kwargs)
    slowed.calls = 0
    return slowed


class _SlowDataset(_DatasetWrapper):
    def __init__(self, dataset, delay_s):
        super().__init__(dataset, range(len(dataset)))
        self._delay_s = float(delay_s)

    def _inject(self, i):
        time.sleep(self._delay_s)


def slow_loader(dataset, delay_s):
    """Dataset wrapper sleeping ``delay_s`` seconds before EVERY sample —
    the input-bound model: the dataloader wait histogram dominates step
    time and the anomaly doctor names the run ``input_bound``."""
    return _SlowDataset(dataset, delay_s)


def retrace_bait(n=8, base=4):
    """Trigger ``n`` fresh compiles over distinct static shapes: not
    ported yet. The reference bumps JAX's compile counter; the port's
    counterpart, ``kernels.builds``, comes with ``compilecache/``
    (ROADMAP.md, Queue 1 item 7)."""
    raise NotImplementedError(
        "faultinject.retrace_bait is not ported to paddle_tpu_torch yet: "
        "its counter, kernels.builds, comes with compilecache/ "
        "(ROADMAP.md, Queue 1 item 7)")


@contextlib.contextmanager
def slow_collective(delay_s, ops=None):
    """Delay every collective this process issues by ``delay_s`` seconds
    (optionally only the named ``ops``), through ``distributed.deadline``'s
    ``_delay_hook``: the delay counts against ``distributed.set_timeout``,
    so that the deadline expires deterministically on the CPU."""
    from ..distributed import deadline as _deadline
    only = set(ops) if ops else None

    def hook(op):
        if only is None or op in only:
            time.sleep(delay_s)

    prev = _deadline._delay_hook[0]
    _deadline._delay_hook[0] = hook
    try:
        yield
    finally:
        _deadline._delay_hook[0] = prev


@contextlib.contextmanager
def slow_fs(delay_s, match=None):
    """Context manager: every staged atomic write in this process sleeps
    ``delay_s`` per ``write()`` call (optionally only destinations
    containing ``match``) — the slow-filesystem model behind the
    async-checkpoint save-stall comparison and the preemption fence
    regression test."""
    with FaultInjector().slow_fs(delay_s, match=match):
        yield


@contextlib.contextmanager
def disk_full(after_bytes=0, match=None, times=1):
    """Context manager: ENOSPC partway through the next ``times`` staged
    writes (see :meth:`FaultInjector.disk_full`)."""
    with FaultInjector().disk_full(after_bytes=after_bytes, match=match,
                                   times=times) as fi:
        yield fi


def sigterm_at_step(data, at_step):
    """Wrap a batch iterable: a real SIGTERM is raised in this process
    just before item ``at_step`` (0-based, counted across the wrapper's
    lifetime) is yielded — the preemption model for ``engine.fit`` loops
    (the hapi sibling is :class:`PreemptAtStep`). The item itself is still
    yielded, so the loop's PreemptionGuard sees the flag at the *next*
    step boundary, exactly like a scheduler-delivered signal."""
    return _SigtermIter(data, at_step)


class _SigtermIter:
    """Iterator behind :func:`sigterm_at_step`; exposes ``.state``
    (``seen``/``fired``) so a test can assert the signal really fired."""

    def __init__(self, data, at_step):
        self._it = iter(data)
        self._at = int(at_step)
        self.state = {'seen': 0, 'fired': False}

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        if self.state['seen'] == self._at and not self.state['fired']:
            self.state['fired'] = True
            signal.raise_signal(signal.SIGTERM)
        self.state['seen'] += 1
        return item


def kill_rank_at_step(at_step, once_file, rank=None):
    """The rank-death model for elastic training: returns ``maybe_die(step)``
    — call it once per training step; at global step ``at_step`` it SIGKILLs
    the CURRENT process (optionally only when ``PADDLE_TRAINER_ID == rank``),
    once across restarts (``once_file`` marker: the relaunched generation
    survives the same step)."""
    at_step = int(at_step)
    once_file = os.fspath(once_file)

    def maybe_die(step):
        if int(step) != at_step:
            return
        if rank is not None and \
                int(os.environ.get('PADDLE_TRAINER_ID', '0')) != int(rank):
            return
        if os.path.exists(once_file):
            return   # already fired once: the respawned rank survives
        with open(once_file, 'w'):   # atomic-ok: chaos one-shot marker
            pass
        os.kill(os.getpid(), signal.SIGKILL)

    return maybe_die


def kill_replica_at_request(engine, at_request):
    """Serving sibling of ``kill_rank_at_step``: arm ``engine`` to die
    abruptly (``ServingEngine.kill()``) immediately after ADMITTING its
    ``at_request``-th request (1-indexed, counted across models; shed
    submissions don't count). The just-admitted request and everything
    already queued/resident is stranded exactly as a real crash strands
    it — recovering the loss is the router's job, which is the point.
    Returns ``engine``; no unwrap needed — a dead engine stays dead."""
    at_request = int(at_request)
    if at_request < 1:
        raise ValueError("kill_replica_at_request: at_request is 1-indexed")
    state = {'admitted': 0}
    orig = engine.submit

    def submit(model, inputs, **kw):
        pending = orig(model, inputs, **kw)
        state['admitted'] += 1
        if state['admitted'] == at_request:
            engine.kill()
        return pending

    engine.submit = submit
    return engine


class ReplicaHang:
    """Handle from :func:`hang_replica` — ``release()`` un-wedges the
    replica (restores the original pump)."""

    def __init__(self, engine, orig_pump):
        self._engine = engine
        self._orig = orig_pump
        self.released = False

    def release(self):
        self._engine.pump = self._orig
        self.released = True


def hang_replica(engine):
    """Wedge ``engine``: every pump does NOTHING (the worker thread stays
    alive, liveness checks pass, queues grow, no request progresses)
    until the returned handle's ``release()`` — the hung-replica model (a
    deadlocked device, a stuck host callback) that is invisible to
    ``dispatchable()`` and only a router's attempt timeout or hedge can
    route around. Returns a :class:`ReplicaHang`."""
    orig = engine.pump
    hang = ReplicaHang(engine, orig)

    def pump():
        if hang.released:
            return orig()
        # bounded no-op tick: the worker must stay responsive to stop()
        time.sleep(0.005)
        return False

    engine.pump = pump
    return hang


def slow_replica(engine, delay_s):
    """Every scheduler pump on ``engine`` sleeps ``delay_s`` first — the
    degraded-replica model (overheating host, noisy neighbor) whose tail
    latency makes hedged-request wins deterministic on CPU (the replica
    sibling of ``slow_model``/``slow_rank``). Returns ``engine``; assign
    ``engine.pump`` back (or just stop the engine) to deactivate."""
    delay_s = float(delay_s)
    orig = engine.pump

    def pump():
        time.sleep(delay_s)
        return orig()

    engine.pump = pump
    return engine


@contextlib.contextmanager
def boot_fail(rank, times=1):
    """Arm ``times`` bootstrap crashes (``os._exit(43)`` before the started
    marker) for ``rank`` in every supervised ``spawn`` child started inside
    the context: the transient bring-up failure that bounded restart
    (``max_restarts``) exists for."""
    key = 'PADDLE_TPU_FI_BOOT_FAIL'
    prev = os.environ.get(key)
    os.environ[key] = f"{int(rank)}:{int(times)}"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prev


class PreemptAtStep:
    """hapi callback delivering a real SIGTERM at the end of global batch
    ``step`` (0-based, counted across epochs) — exercises the full
    PreemptionGuard -> CheckpointSaver -> stop_training path.

    Imported lazily as a Callback subclass so this module stays stdlib-only
    until a test actually uses it.
    """

    def __new__(cls, step):
        from ..hapi.callbacks import Callback

        class _Preempter(Callback):
            def __init__(self, at):
                super().__init__()
                self.at = int(at)
                self.seen = 0
                self.fired = False

            def on_train_batch_end(self, batch_step, logs=None):
                if self.seen == self.at and not self.fired:
                    self.fired = True
                    signal.raise_signal(signal.SIGTERM)
                self.seen += 1

        return _Preempter(step)


def _poisson(rng, lam):
    """Knuth's Poisson sampler off a seeded ``random.Random`` — the burst
    sizes are a pure function of (seed, draw index)."""
    import math
    limit = math.exp(-float(lam))
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def tenant_storm(target, model, inputs, tenant='storm', qps=8.0,
                 duration_ticks=10, seed=0, **submit_kw):
    """Deterministic noisy-neighbor traffic: Poisson bursts from one tenant.

    Each of ``duration_ticks`` VIRTUAL ticks draws a Poisson(``qps``)
    burst size from a seeded RNG and fires that many ``target.submit(model,
    inputs, tenant=tenant)`` calls back-to-back — ``target`` is anything
    with the serving submit signature (``ServingEngine``, ``Endpoint.submit``
    host object, ``FleetRouter``). No wall-clock sleeps anywhere: "qps" is
    per virtual tick, so the same seed always produces the same burst
    train and the same shed pattern, and the caller pumps/settles between
    ticks however its harness drives the engine.

    Over-quota and over-capacity submits (``QueueFullError`` and
    subclasses, e.g. ``QuotaExceededError``) are absorbed and tallied by
    their ``reason``. Returns::

        {'attempts': int, 'submitted': int, 'shed': {reason: n},
         'per_tick': [burst sizes], 'pending': [admitted handles]}

    so a test can assert the storm really was shed as ``quota`` (not
    ``queue_full``) and still settle the admitted remainder.
    """
    import random
    from ..serving.scheduler import QueueFullError
    rng = random.Random(int(seed))
    out = {'attempts': 0, 'submitted': 0, 'shed': {},
           'per_tick': [], 'pending': []}
    for _ in range(int(duration_ticks)):
        burst = _poisson(rng, qps)
        out['per_tick'].append(burst)
        for _ in range(burst):
            out['attempts'] += 1
            try:
                pending = target.submit(model, inputs, tenant=tenant,
                                        **submit_kw)
            except QueueFullError as e:
                reason = getattr(e, 'reason', 'queue_full')
                out['shed'][reason] = out['shed'].get(reason, 0) + 1
            else:
                out['submitted'] += 1
                out['pending'].append(pending)
    return out


def burn_ramp(model, burn=2.0, requests=20, target_ms=50.0,
              objective=0.9):
    """Drive ``model``'s SLO error-budget burn rate to ``burn``, now.

    Feeds ``requests`` fabricated completed-request judgments straight
    into the SLO tracker (``observability.slo.record``): the fraction
    needed for the target burn is recorded as over-target latencies
    (status ``'ok'`` but 2x the objective — exactly what a degrading
    backend produces), the rest comfortably under it. Registers a
    ``target_ms``/``objective`` objective when the model has none. Burn
    is a cumulative ratio, so one call *sustains*: every subsequent
    autoscaler/doctor observation sees the same rate until real traffic
    or ``slo.reset()`` dilutes it — which is what makes "sustained burn
    for N ticks" testable without wall-clock time. Returns the achieved
    burn rate.
    """
    from ..observability import slo as _slo
    obj = _slo.objective(model)
    if obj is None:
        obj = _slo.set_objective(model, target_ms, objective)
    budget = max(1.0 - obj['objective'], 1e-9)
    requests = max(1, int(requests))
    # burn = (violations/requests)/budget  =>  violations to fabricate:
    violations = min(requests, max(0, round(float(burn) * budget
                                            * requests)))
    achieved = None
    for i in range(requests):
        if i < violations:
            achieved = _slo.record(model, 'ok', obj['target_ms'] * 2.0)
        else:
            achieved = _slo.record(model, 'ok', obj['target_ms'] * 0.5)
    return achieved


@contextlib.contextmanager
def hold_lock(lock):
    """Freeze every writer that must take ``lock`` — the deterministic
    interleaving hook for data-race regression tests. Acquire the guard on
    the test thread, launch the racing call (``RacingCall``), assert it has
    NOT completed (it is parked at the exact formerly-racy critical
    section), release, assert it lands. A reverted fix turns the "still
    blocked" assertion false immediately — no timing luck involved."""
    lock.acquire()
    try:
        yield lock
    finally:
        lock.release()


class RacingCall:
    """A call launched on a daemon side thread with completion
    observability — the other half of ``hold_lock``.

    ``done`` is set when the call finished (result or exception);
    ``blocked(grace)`` waits ``grace`` seconds and reports True while the
    call is still parked; ``join()`` waits (watchdog-bounded) and returns
    the result, re-raising any error from the side thread."""

    def __init__(self, fn, *args, **kwargs):
        import threading
        self.done = threading.Event()
        self.result = None
        self.error = None

        def _run():
            try:
                self.result = fn(*args, **kwargs)
            except BaseException as e:   # re-raised in join()
                self.error = e
            finally:
                self.done.set()

        self._thread = threading.Thread(
            target=_run, name='paddle-tpu-torch-racing-call', daemon=True)
        self._thread.start()

    def blocked(self, grace=0.15):
        """True when the call is still parked after ``grace`` seconds."""
        return not self.done.wait(grace)

    def join(self, timeout=5.0):
        from .watchdog import join_thread
        join_thread(self._thread, timeout=timeout)
        if self.error is not None:
            raise self.error
        return self.result
