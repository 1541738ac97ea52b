"""ServingEngine: multi-tenant inference of ``nn.Module``s and generative
models on the GPU. Counterpart of ``paddle_tpu/serving/engine.py``.

One engine serves many models. Each registered model gets a bounded
admission queue and a runner; a single worker thread round-robins the
runners, so every pump is one bounded unit of work per model.

Registration adapters:

- ``layer=`` — a ``torch.nn.Module`` (e.g. ``text.bert.BertModel``): moved
  to the engine's device, put in eval mode and called under
  ``torch.inference_mode()`` with feeds bound to ``forward``'s parameters
  by name;
- ``predict_fn=`` — a callable over ``{name: tensor [B, ...]}`` on the
  engine's device;
- ``generative=`` — a ``kv_cache.GenerativeSpec`` on the engine's device,
  greedy-decoded with continuous batching over the **paged KV cache**
  (``kv_cache='paged'``, the default: ``page_size``, ``num_pages``,
  ``max_concurrency``, ``prefix_cache``, speculative decoding with
  ``draft=``/``draft_k=``) or the fixed-slot baseline
  (``kv_cache='slot'``). Requests are ``{'tokens': int array [L]}`` with
  ``max_new_tokens`` (default ``default_max_new_tokens``); responses
  carry ``{'tokens': the generated ids}``.

Tenancy and SLOs (``serving.admission``, ``observability.slo``):
``ServingEngine(tenants=TenantArbiter(...))`` gives every model a
``WeightedFairQueue`` (deficit-round-robin pops by tenant weight) and
charges each submit's tenant its token-bucket quota at the front door (an
over-quota submit sheds as ``QuotaExceededError``, reason ``'quota'``,
beside ``'queue_full'`` and ``'page_exhaustion'``); ``register(slo_ms=,
slo_objective=)`` judges every completed request against the model's
latency objective (``stats()['slo_burn']``, and per tenant
``stats()['tenants']``). ``cancel`` withdraws a queued request, ``kill``
is the abrupt death a router must survive (``EngineDeadError``).

Telemetry (``observability``, off until ``PADDLE_TPU_TELEMETRY=1`` or
``observability.enable()``): ``serving.*`` counters, gauges, histograms,
timers and events, one async trace lane a request. ``start()`` installs
the flight recorder's crash hooks and, with telemetry on, starts the
time-series sampler and (with ``PADDLE_TPU_TELEMETRY_HTTP``) the live
endpoint; ``start_endpoint(port=0)`` starts this engine's own
``/metrics`` + ``/healthz`` endpoint; ``stop()`` stops what this engine
started.

``jit_compile=False`` is accepted (the port always runs op by op). Not
ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
item (Queue 1 item 7): ``program=``/``executor=`` (``static/``),
``predictor=`` (``inference/``), ``quantize=``/``calib_data=``
(``slim/``), ``artifact_dir=`` and ``jit_compile=True``
(``compilecache/``, ``jit/``).

Drive it with ``start()`` (background worker thread; clients block on
``Endpoint.predict``) or synchronously with ``pump()`` /
``run_until_idle()``.
"""
import inspect
import threading

import torch

from .. import observability as _obs
from ..device import resolve_device
from .admission import WeightedFairQueue, record_shed
from .paged_runner import PagedGenerativeRunner
from .runners import BatchRunner, GenerativeRunner, _count, finish_request
from .scheduler import (STATUS_CANCELLED, STATUS_ERROR, AdmissionQueue,
                        PendingRequest, QueueFullError, Request,
                        WatchdogTimeout)

__all__ = ['ServingEngine', 'Endpoint', 'EngineDeadError']

# Idle backstop only: submit() and stop() notify the condition.
_IDLE_TICK = 0.5

# reference arguments whose parts are not ported yet (NotImplementedError),
# with where they come
_LATER_REGISTER_ARGS = {
    'program': "static/ programs (ROADMAP.md, Queue 1 item 7)",
    'executor': "static/ programs (ROADMAP.md, Queue 1 item 7)",
    'predictor': "inference/ predictors (ROADMAP.md, Queue 1 item 7)",
    'quantize': "slim/ quantisation (ROADMAP.md, Queue 1 item 7)",
    'calib_data': "slim/ quantisation (ROADMAP.md, Queue 1 item 7)",
    'artifact_dir': "compilecache/ artifacts (ROADMAP.md, Queue 1 item 7)",
    'jit_compile=True': "compiled programs, jit/ and compilecache/ "
                        "(ROADMAP.md, Queue 1 item 7); the port runs "
                        "op by op: pass jit_compile=False or nothing",
}


class EngineDeadError(RuntimeError):
    """Submit on an engine that was ``kill()``-ed. Distinguishable from
    model errors, so a router can classify it as replica death (fail over)
    rather than as a request's failure."""


def _refuse_later(what, given):
    unknown = sorted(set(given) - set(_LATER_REGISTER_ARGS))
    if unknown:
        raise TypeError(f"{what}: unexpected keyword arguments {unknown}")
    if given:
        key = sorted(given)[0]
        raise NotImplementedError(
            f"{what}: {key}= is not ported to paddle_tpu_torch yet: "
            f"{_LATER_REGISTER_ARGS[key]}")


class Endpoint:
    """Client-facing handle for one served model."""

    def __init__(self, engine, model):
        self._engine = engine
        self.model = model

    def submit(self, inputs, deadline_ms=None, max_new_tokens=None,
               tenant=None):
        """Enqueue one request -> ``PendingRequest``. Raises
        ``QueueFullError`` when the admission queue sheds it (including
        the tenant-quota kind, ``QuotaExceededError``), ``EngineDeadError``
        after ``kill()`` and ``ValueError`` when inputs don't match the
        registered spec."""
        return self._engine.submit(self.model, inputs,
                                   deadline_ms=deadline_ms,
                                   max_new_tokens=max_new_tokens,
                                   tenant=tenant)

    def predict(self, inputs, deadline_ms=None, max_new_tokens=None,
                timeout=None, tenant=None):
        """Blocking one-call convenience: submit + result."""
        return self.submit(inputs, deadline_ms=deadline_ms,
                           max_new_tokens=max_new_tokens,
                           tenant=tenant).result(timeout=timeout)


class ServingEngine:
    def __init__(self, queue_capacity=256, default_deadline_ms=None,
                 tenants=None, device=None):
        """``tenants=`` attaches a ``serving.admission.TenantArbiter``:
        every model's queue becomes a ``WeightedFairQueue`` and ``submit``
        charges the tenant's quota before the queue push.
        ``device=None`` serves on the CUDA device and raises without
        one; tests pass ``device='cpu'``."""
        self.device = resolve_device(device)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.tenants = tenants         # TenantArbiter or None
        self._models = {}              # name -> runner
        self._queues = {}              # name -> AdmissionQueue
        self._rr = []                  # round-robin order
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread = None
        self._stop = threading.Event()
        self._shed = 0
        self._shed_queue_full = 0       # offered load exceeds drain rate
        self._shed_page_exhaustion = 0  # a page-starved runner backed up
        self._shed_quota = 0            # a tenant over its quota
        self._submitted = 0
        self._endpoint = None          # MetricsServer this engine owns
        self._own_sampler = False      # ring sampler this engine started
        self._own_hooks = False        # crash hooks this engine installed
        self._killed = False           # abrupt death, see kill()

    # -- registration ---------------------------------------------------
    def register(self, name, predict_fn=None, layer=None, generative=None,
                 example=None, bucket_spec=None, queue_capacity=None,
                 default_max_new_tokens=32, kv_cache='paged', page_size=16,
                 num_pages=None, max_concurrency=None, draft=None, draft_k=4,
                 prefix_cache=True, slo_ms=None, slo_objective=0.99,
                 jit_compile=None, **later):
        """Register one model under ``name``: exactly one of ``predict_fn``
        / ``layer`` / ``generative``. One-shot kinds also need ``example``
        (one request's inputs, no batch axis) to pin the shape set.
        Generative models decode over the paged KV cache by default
        (``page_size`` tokens a page, ``num_pages`` in all — by default
        every row at ``max_seq``, ``max_concurrency`` block-table rows —
        by default ``spec.max_batch``, ``prefix_cache`` and
        ``draft``/``draft_k`` speculative decoding); ``kv_cache='slot'``
        keeps the fixed-slot cache. ``slo_ms=`` declares the model's
        latency objective: ``slo_objective`` (default 0.99) of requests
        must complete OK within ``slo_ms`` end to end. Returns the model's
        ``Endpoint``."""
        if jit_compile:
            later = dict(later, **{'jit_compile=True': True})
        _refuse_later(f"register({name!r})", later)
        given = [k for k, v in (('predict_fn', predict_fn),
                                ('layer', layer),
                                ('generative', generative)) if v is not None]
        if len(given) != 1:
            raise ValueError(
                f"register({name!r}): give exactly one model kind, got "
                f"{given or 'none'}")
        if name in self._models:
            raise ValueError(f"register: model {name!r} already registered")
        paged_given = [k for k, v in (
            ('num_pages', num_pages), ('draft', draft),
            ('max_concurrency', max_concurrency)) if v is not None]
        if generative is not None:
            bad = [k for k, v in (('example', example),
                                  ('bucket_spec', bucket_spec))
                   if v is not None]
            if bad:
                raise ValueError(
                    f"register({name!r}): {bad} do not apply to "
                    "generative= models — prompt buckets and batch size "
                    "come from the GenerativeSpec itself")
            if kv_cache not in ('paged', 'slot'):
                raise ValueError(
                    f"register({name!r}): kv_cache must be 'paged' or "
                    f"'slot', got {kv_cache!r}")
            if kv_cache == 'slot' and paged_given:
                raise ValueError(
                    f"register({name!r}): {paged_given} need the paged "
                    "KV cache — drop kv_cache='slot' (paged is the "
                    "default) to use pages, prefix sharing, and "
                    "speculative decoding")
            for what, spec in (('generative', generative), ('draft', draft)):
                dev = getattr(spec, 'device', None)
                if dev is not None and torch.device(dev) != self.device:
                    raise ValueError(
                        f"register({name!r}): the {what} spec lives on "
                        f"{dev}, the engine serves on {self.device}")
        elif paged_given:
            raise ValueError(
                f"register({name!r}): {paged_given} apply only to "
                "generative= models (the paged KV cache)")
        if queue_capacity is not None and int(queue_capacity) < 1:
            raise ValueError(
                f"register({name!r}): queue_capacity must be >= 1, got "
                f"{queue_capacity!r}")
        if slo_ms is not None:
            _obs.slo.set_objective(name, slo_ms, slo_objective)
        capacity = (self.queue_capacity if queue_capacity is None
                    else queue_capacity)
        if self.tenants is not None:
            queue = WeightedFairQueue(name, capacity, arbiter=self.tenants)
        else:
            queue = AdmissionQueue(name, capacity)
        if generative is not None and kv_cache == 'paged':
            runner = PagedGenerativeRunner(
                name, queue, generative, self.device, page_size=page_size,
                num_pages=num_pages, max_concurrency=max_concurrency,
                draft=draft, draft_k=draft_k, prefix_cache=prefix_cache,
                default_max_new_tokens=default_max_new_tokens)
        elif generative is not None:
            runner = GenerativeRunner(
                name, queue, generative, self.device,
                default_max_new_tokens=default_max_new_tokens)
        else:
            if example is None:
                raise ValueError(
                    f"register({name!r}): one-shot models need example= "
                    "(one request's inputs, no batch axis) to fix the "
                    "shape set")
            fn = predict_fn if layer is None else \
                self._layer_fn(name, layer, example)
            runner = BatchRunner(name, queue, fn, example, self.device,
                                 bucket_spec=bucket_spec)
        with self._cond:
            self._models[name] = runner
            self._queues[name] = queue
            self._rr.append(name)
        if _obs.enabled():
            _obs.gauge('serving.models').set(len(self._models))
        return Endpoint(self, name)

    def _layer_fn(self, name, layer, example):
        layer.to(self.device).eval()
        # Bind feeds to forward's parameters BY NAME (keyword arguments): a
        # dict has no positional order, and feeds that skip a parameter
        # (BERT's input_ids + attention_mask skip token_type_ids) must not
        # shift onto it.
        try:
            params = [
                p.name for p in
                inspect.signature(layer.forward).parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]
        except (TypeError, ValueError):
            params = []
        if len(example) > 1 and not set(example) <= set(params):
            raise ValueError(
                f"register({name!r}): multi-input layer — feed names "
                f"{sorted(example)} must match {type(layer).__name__}"
                f".forward parameter names {params} so arguments bind "
                "unambiguously; rename the feeds or register via "
                "predict_fn= with explicit binding")

        def fn(feeds):
            # inference_mode is thread-local: entered here, on whichever
            # thread runs the batch (the worker after start())
            with torch.inference_mode():
                if len(feeds) == 1:
                    return layer(*feeds.values())
                return layer(**feeds)
        return fn

    # -- client surface -------------------------------------------------
    def has_model(self, name):
        return name in self._models

    def model_kind(self, name):
        """'generative' or 'batch' for a registered model (KeyError
        else)."""
        return self._models[name].kind

    def page_starved(self, model):
        """Is ``model``'s paged runner unable to allocate KV pages right
        now? Always False for the other runners."""
        runner = self._models.get(model)
        return bool(getattr(runner, 'page_starved', lambda: False)())

    def submit(self, model, inputs, deadline_ms=None, max_new_tokens=None,
               tenant=None):
        if self._killed:
            raise EngineDeadError(
                f"serving: engine is dead (killed): request for {model!r} "
                "refused")
        runner = self._models.get(model)
        if runner is None:
            raise KeyError(f"serving: no model {model!r} registered")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(
                f"serving: max_new_tokens must be >= 1, got "
                f"{max_new_tokens!r}")
        req = Request(model, inputs, deadline_ms=deadline_ms,
                      max_new_tokens=max_new_tokens, tenant=tenant)
        runner.validate(req)
        if self.tenants is not None:
            # quota gate at the front door, BEFORE the queue push: a shed
            # here never touches the queue
            try:
                self.tenants.check(req.tenant, model)
            except QueueFullError as e:
                self._record_shed(req, e.reason)
                raise
        _count('serving.requests')
        if _obs.enabled():
            # open the request's async lane BEFORE the queue push: the
            # worker may pop, run and close it before this thread resumes
            _obs.async_begin('request', req.id, cat='serving.request',
                             model=model, deadline_ms=deadline_ms,
                             tenant=req.tenant)
        try:
            self._queues[model].push(req)
        except QueueFullError as e:
            # a queue that backed up behind a page-starved runner is
            # memory pressure, not traffic overload
            e.reason = ('page_exhaustion' if self.page_starved(model)
                        else 'queue_full')
            self._record_shed(req, e.reason, lane_open=True)
            raise
        with self._cond:
            self._submitted += 1
            if _obs.enabled():
                _obs.gauge('serving.queue_depth').set(
                    sum(len(q) for q in self._queues.values()))
            self._cond.notify_all()
        return PendingRequest(req, self.alive)

    def _record_shed(self, req, reason, lane_open=False):
        """Tally one shed (reason: queue_full / page_exhaustion / quota)
        under the lock, mirror it to telemetry, attribute it to the
        tenant."""
        with self._lock:
            self._shed += 1
            if reason == 'page_exhaustion':
                self._shed_page_exhaustion += 1
            elif reason == 'quota':
                self._shed_quota += 1
            else:
                self._shed_queue_full += 1
        _count('serving.shed')
        _count(f'serving.shed.{reason}')
        record_shed(req.tenant, reason)
        if _obs.enabled():
            _obs.event('serving.shed', model=req.model, request=req.id,
                       reason=reason, tenant=req.tenant)
            if lane_open:
                _obs.async_end('request', req.id, cat='serving.request',
                               status='shed', reason=reason)

    def cancel(self, pending):
        """Withdraw a still-queued request: it leaves the admission queue
        and completes with status ``'cancelled'`` without ever running.
        True on success, False when a runner already owns the request (it
        runs to completion)."""
        req = pending._req if isinstance(pending, PendingRequest) else pending
        queue = self._queues.get(req.model)
        if queue is None or not queue.remove(req):
            return False
        req.complete(STATUS_CANCELLED)
        _count('serving.cancelled')
        if _obs.enabled():
            _obs.event('serving.cancelled', model=req.model, request=req.id)
            _obs.async_end('request', req.id, cat='serving.request',
                           status='cancelled')
        return True

    def queued_count(self, model=None):
        """Requests admitted but not yet popped by a runner."""
        with self._lock:
            if model is not None:
                q = self._queues.get(model)
                return 0 if q is None else len(q)
            return sum(len(q) for q in self._queues.values())

    def resident_count(self, model=None):
        """Generative requests resident in KV rows (mid-decode). One-shot
        batches run inside one pump, so none is ever resident between
        pumps."""
        with self._lock:
            runners = ([self._models[model]] if model in self._models
                       else [] if model is not None
                       else list(self._models.values()))
        return sum(sum(1 for s in r.slots if s is not None)
                   for r in runners if r.kind == 'generative')

    # -- scheduler loop -------------------------------------------------
    def pump(self):
        """One scheduler iteration over every model (round-robin order).
        Returns True when any runner did work; a killed engine does
        none."""
        if self._killed:
            return False
        with self._lock:
            order = list(self._rr)
            if order:
                self._rr.append(self._rr.pop(0))
            runners = [self._models[n] for n in order]
            queues = list(self._queues.values())
        did = False
        for runner in runners:
            if runner.has_work():
                did = runner.step() or did
        if _obs.enabled():
            _obs.gauge('serving.queue_depth').set(
                sum(len(q) for q in queues))
            _obs.gauge('serving.active_slots').set(sum(
                sum(1 for s in r.slots if s is not None)
                for r in runners if r.kind == 'generative'))
        return did

    def run_until_idle(self, max_steps=100000):
        """Pump until no runner has work. Returns the number of iterations
        that did work."""
        steps = 0
        for _ in range(int(max_steps)):
            if not self.pump():
                if self._killed or not any(
                        r.has_work() for r in self._models.values()):
                    return steps
            else:
                steps += 1
        return steps

    def warmup(self):
        """Run every registered model's buckets once now, so the first real
        request pays no first-call cost. Returns {model: buckets run}."""
        with _obs.timer('serving.warmup'):
            return {name: runner.warmup()
                    for name, runner in list(self._models.items())}

    def start(self):
        """Start the background worker thread (idempotent). Installs the
        flight recorder's crash hooks (always on); with telemetry on, also
        starts the process's endpoint when ``PADDLE_TPU_TELEMETRY_HTTP``
        names a port, and the time-series sampler."""
        if not _obs.flight.hooks_installed():
            self._own_hooks = _obs.flight.install_crash_hooks()
        if _obs.enabled():
            _obs.endpoint.maybe_start_from_env(extra_health=self._health)
            had = _obs.timeseries.active_sampler() is not None
            self._own_sampler = (_obs.timeseries.start_sampler() is not None
                                 and not had)
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._worker, name='paddle-tpu-torch-serving',
                daemon=True)
            self._thread.start()
        return self

    def start_endpoint(self, port=0, host=None):
        """Serve this engine's live ``/metrics`` + ``/healthz`` (``port=0``
        picks a free port; binds 127.0.0.1 unless ``host`` or
        ``PADDLE_TPU_TELEMETRY_HTTP_HOST`` widens it). Returns the
        ``observability.MetricsServer``; ``stop()`` stops it."""
        if self._endpoint is None:
            self._endpoint = _obs.MetricsServer(
                host=host, port=port, extra_health=self._health).start()
        return self._endpoint

    def _health(self):
        """The serving part of ``/healthz``."""
        with self._lock:
            queues = {n: len(q) for n, q in self._queues.items()}
        starved = {n: bool(getattr(r, 'page_starved', lambda: False)())
                   for n, r in self._models.items()}
        out = {'serving': {
            'worker_alive': self.alive(),
            'models': sorted(queues),
            'queue_depth': queues,
            'resident': self.resident_count(),
            'page_starved': starved,
            'submitted': self._submitted,
            'shed': self._shed,
        }}
        burns = _obs.slo.burn_rates()
        if burns:
            out['serving']['slo_burn'] = burns
        return out

    def alive(self):
        if self._killed:
            return False
        return self._thread is not None and self._thread.is_alive()

    @property
    def killed(self):
        return self._killed

    def dispatchable(self):
        """Can this engine accept work and eventually run it? False once
        ``kill()``-ed, or once a started worker thread has died. A
        never-started engine is dispatchable (manual ``pump()`` mode)."""
        if self._killed:
            return False
        with self._lock:
            t = self._thread
        return t is None or t.is_alive()

    def kill(self):
        """Die abruptly, the in-process analogue of a replica's SIGKILL.
        Unlike ``stop()``, queued and resident requests are NOT completed:
        they are stranded as a real crash strands them, so their clients'
        bounded waits fire. The worker exits at its next iteration;
        ``alive()`` is False at once and ``submit`` raises
        ``EngineDeadError``. Idempotent; ``stop()`` still joins the worker
        and stops what ``start()`` started."""
        if self._killed:
            return
        self._killed = True
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
        _count('serving.killed')
        if _obs.enabled():
            _obs.event('serving.killed',
                       queued=sum(len(q) for q in self._queues.values()))
        _obs.flight.record('serving.killed', models=sorted(self._models))

    def stop(self, timeout=10.0):
        """Stop the worker; requests still queued and generative requests
        mid-decode are completed as errors rather than stranded, the
        latter with their partial tokens. Stops this engine's endpoint, and
        the sampler and crash hooks its ``start()`` started."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
            t = self._thread
        # join BEFORE clearing _thread: alive() must stay True while the
        # worker finishes its current batch
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise WatchdogTimeout(
                    f"serving: worker thread still running {timeout:.1f}s "
                    "after stop() — a batch is stuck")
        with self._cond:
            self._thread = None
        for runner in self._models.values():
            for req, outputs in runner.evict_in_flight():
                finish_request(req, STATUS_ERROR, outputs,
                               error=RuntimeError(
                                   f"serving: engine stopped with request "
                                   f"{req.id} mid-decode"))
        for q in self._queues.values():
            for req in q.drain():
                finish_request(req, STATUS_ERROR, error=RuntimeError(
                    f"serving: engine stopped before request {req.id} ran"))
        if self._endpoint is not None:
            self._endpoint.stop()
            self._endpoint = None
        _obs.endpoint.detach_health(self._health)
        if self._own_sampler:
            sm = _obs.timeseries.active_sampler()
            if sm is not None:
                sm.sample_now()   # the engine's tail lands in the ring
            _obs.timeseries.stop_sampler()
            self._own_sampler = False
        if self._own_hooks:
            _obs.flight.uninstall_crash_hooks()
            self._own_hooks = False

    def _worker(self):
        try:
            while not self._stop.is_set():
                if not self.pump():
                    with self._cond:
                        if self._stop.is_set():
                            break
                        if not any(r.has_work()
                                   for r in self._models.values()):
                            self._cond.wait(_IDLE_TICK)
        except BaseException as e:
            # runners contain model errors, so nothing should escape
            # pump(); if something does, leave a trace: a dead worker
            # otherwise looks like an idle engine
            _count('serving.worker_crash')
            if _obs.enabled():
                _obs.event('serving.worker_crash', error=repr(e))
            raise

    # -- introspection --------------------------------------------------
    def stats(self):
        """Engine tallies, each model's runner tallies, ``kv`` (the paged
        runners' page, prefix and draft accounting,
        ``PagedGenerativeRunner.kv_info``), ``slo_burn`` (each tracked
        model's error-budget burn) and, with tenants, ``tenants``: the
        arbiter's policies and the per-tenant ledger."""
        with self._lock:
            out = {
                'submitted': self._submitted,
                'shed': self._shed,
                'shed_queue_full': self._shed_queue_full,
                'shed_page_exhaustion': self._shed_page_exhaustion,
                'shed_quota': self._shed_quota,
                'queue_depth': {n: len(q) for n, q in self._queues.items()},
                'models': {n: r.stats.as_dict()
                           for n, r in self._models.items()},
                'kv': {n: r.kv_info() for n, r in self._models.items()
                       if hasattr(r, 'kv_info')},
            }
        out['slo_burn'] = _obs.slo.burn_rates()
        if self.tenants is not None:
            from .admission import tenant_stats
            out['tenants'] = {'policies': self.tenants.stats(),
                              'ledger': tenant_stats()}
        return out
