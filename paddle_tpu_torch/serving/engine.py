"""ServingEngine: inference of ``nn.Module``s and generative models on
the GPU. Counterpart of ``paddle_tpu/serving/engine.py``.

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

The reference's ``program=``, ``predictor=``, quantisation, ``jit_compile``,
tenant, SLO, artifact-dir and telemetry parts are not ported yet: asking
for them raises ``NotImplementedError``.

Drive it with ``start()`` (background worker thread; clients block on
``Endpoint.predict``) or synchronously with ``pump()`` /
``run_until_idle()``.
"""
import inspect
import threading

import torch

from ..device import resolve_device
from .paged_runner import PagedGenerativeRunner
from .runners import BatchRunner, GenerativeRunner
from .scheduler import (STATUS_ERROR, AdmissionQueue, PendingRequest,
                        QueueFullError, Request, WatchdogTimeout)

__all__ = ['ServingEngine', 'Endpoint']

# Idle backstop only: submit() and stop() notify the condition.
_IDLE_TICK = 0.5

# reference arguments whose parts are not ported yet (NotImplementedError)
_LATER_ENGINE_ARGS = frozenset({'tenants'})
_LATER_REGISTER_ARGS = frozenset({
    'program', 'executor', 'predictor', 'quantize', 'calib_data',
    'jit_compile', 'slo_ms', 'slo_objective', 'artifact_dir'})


def _refuse_later(what, given, later):
    unknown = sorted(set(given) - later)
    if unknown:
        raise TypeError(f"{what}: unexpected keyword arguments {unknown}")
    if given:
        raise NotImplementedError(
            f"{what}: {sorted(given)} belong to parts of the serving engine "
            "not ported to paddle_tpu_torch yet (program/predictor "
            "models, quantisation, jit_compile, tenants, SLOs, artifact "
            "dirs); see ROADMAP.md")


class Endpoint:
    """Client-facing handle for one served model."""

    def __init__(self, engine, model):
        self._engine = engine
        self.model = model

    def submit(self, inputs, deadline_ms=None, max_new_tokens=None):
        """Enqueue one request -> ``PendingRequest``. Raises
        ``QueueFullError`` when the admission queue sheds it and
        ``ValueError`` when inputs don't match the registered spec."""
        return self._engine.submit(self.model, inputs,
                                   deadline_ms=deadline_ms,
                                   max_new_tokens=max_new_tokens)

    def predict(self, inputs, deadline_ms=None, max_new_tokens=None,
                timeout=None):
        """Blocking one-call convenience: submit + result."""
        return self.submit(inputs, deadline_ms=deadline_ms,
                           max_new_tokens=max_new_tokens).result(
                               timeout=timeout)


class ServingEngine:
    def __init__(self, queue_capacity=256, default_deadline_ms=None,
                 device=None, **later):
        """``device=None`` serves on the CUDA device and raises without
        one; tests pass ``device='cpu'``."""
        _refuse_later('ServingEngine', later, _LATER_ENGINE_ARGS)
        self.device = resolve_device(device)
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
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
        self._submitted = 0

    # -- registration ---------------------------------------------------
    def register(self, name, predict_fn=None, layer=None, generative=None,
                 example=None, bucket_spec=None, queue_capacity=None,
                 default_max_new_tokens=32, kv_cache='paged', page_size=16,
                 num_pages=None, max_concurrency=None, draft=None, draft_k=4,
                 prefix_cache=True, **later):
        """Register one model under ``name``: exactly one of ``predict_fn``
        / ``layer`` / ``generative``. One-shot kinds also need ``example``
        (one request's inputs, no batch axis) to pin the shape set.
        Generative models decode over the paged KV cache by default
        (``page_size`` tokens a page, ``num_pages`` in all — by default
        every row at ``max_seq``, ``max_concurrency`` block-table rows —
        by default ``spec.max_batch``, ``prefix_cache`` and
        ``draft``/``draft_k`` speculative decoding); ``kv_cache='slot'``
        keeps the fixed-slot cache. Returns the model's ``Endpoint``."""
        _refuse_later(f"register({name!r})", later, _LATER_REGISTER_ARGS)
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
        queue = AdmissionQueue(name, self.queue_capacity
                               if queue_capacity is None else queue_capacity)
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
    def page_starved(self, model):
        """Is ``model``'s paged runner unable to allocate KV pages right
        now? Always False for the other runners."""
        runner = self._models.get(model)
        return bool(getattr(runner, 'page_starved', lambda: False)())

    def submit(self, model, inputs, deadline_ms=None, max_new_tokens=None):
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
                      max_new_tokens=max_new_tokens)
        runner.validate(req)
        try:
            self._queues[model].push(req)
        except QueueFullError as e:
            # a queue that backed up behind a page-starved runner is
            # memory pressure, not traffic overload
            e.reason = ('page_exhaustion' if self.page_starved(model)
                        else 'queue_full')
            with self._lock:
                self._shed += 1
                if e.reason == 'page_exhaustion':
                    self._shed_page_exhaustion += 1
                else:
                    self._shed_queue_full += 1
            raise
        with self._cond:
            self._submitted += 1
            self._cond.notify_all()
        return PendingRequest(req, self.alive)

    # -- scheduler loop -------------------------------------------------
    def pump(self):
        """One scheduler iteration over every model (round-robin order).
        Returns True when any runner did work."""
        with self._lock:
            order = list(self._rr)
            if order:
                self._rr.append(self._rr.pop(0))
            runners = [self._models[n] for n in order]
        did = False
        for runner in runners:
            if runner.has_work():
                did = runner.step() or did
        return did

    def run_until_idle(self, max_steps=100000):
        """Pump until no runner has work. Returns the number of iterations
        that did work."""
        steps = 0
        for _ in range(int(max_steps)):
            if not self.pump():
                if not any(r.has_work() for r in self._models.values()):
                    return steps
            else:
                steps += 1
        return steps

    def warmup(self):
        """Run every registered model's buckets once now, so the first real
        request pays no first-call cost. Returns {model: buckets run}."""
        return {name: runner.warmup()
                for name, runner in list(self._models.items())}

    def start(self):
        """Start the background worker thread (idempotent)."""
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._worker, name='paddle-tpu-torch-serving',
                daemon=True)
            self._thread.start()
        return self

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout=10.0):
        """Stop the worker; requests still queued and generative requests
        mid-decode are completed as errors rather than stranded, the
        latter with their partial tokens."""
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
            for req, outputs in getattr(runner, 'evict_in_flight',
                                        lambda: [])():
                req.complete(STATUS_ERROR, outputs, error=RuntimeError(
                    f"serving: engine stopped with request {req.id} "
                    "mid-decode"))
        for q in self._queues.values():
            for req in q.drain():
                req.complete(STATUS_ERROR, error=RuntimeError(
                    f"serving: engine stopped before request {req.id} ran"))

    def _worker(self):
        while not self._stop.is_set():
            if not self.pump():
                with self._cond:
                    if self._stop.is_set():
                        break
                    if not any(r.has_work() for r in self._models.values()):
                        self._cond.wait(_IDLE_TICK)

    # -- introspection --------------------------------------------------
    def stats(self):
        """Engine tallies, each model's runner tallies, and ``kv`` — the
        paged runners' page, prefix and draft accounting
        (``PagedGenerativeRunner.kv_info``)."""
        with self._lock:
            return {
                'submitted': self._submitted,
                'shed': self._shed,
                'shed_queue_full': self._shed_queue_full,
                'shed_page_exhaustion': self._shed_page_exhaustion,
                'queue_depth': {n: len(q) for n, q in self._queues.items()},
                'models': {n: r.stats.as_dict()
                           for n, r in self._models.items()},
                'kv': {n: r.kv_info() for n, r in self._models.items()
                       if hasattr(r, 'kv_info')},
            }
