"""ServingEngine: one-shot inference of ``nn.Module``s on the GPU.
Counterpart of ``paddle_tpu/serving/engine.py``.

One engine serves many models. Each registered model gets a bounded
admission queue and a ``BatchRunner``; a single worker thread round-robins
the runners, so every pump is one bounded unit of work per model.

Registration adapters:

- ``layer=`` — a ``torch.nn.Module`` (e.g. ``text.bert.BertModel``): moved
  to the engine's device, put in eval mode and called under
  ``torch.inference_mode()`` with feeds bound to ``forward``'s parameters
  by name;
- ``predict_fn=`` — a callable over ``{name: tensor [B, ...]}`` on the
  engine's device.

The reference's generative (paged KV cache), ``program=``, ``predictor=``,
quantisation, tenant, SLO, artifact-dir and telemetry parts are not
ported yet: asking for them raises ``NotImplementedError``.

Drive it with ``start()`` (background worker thread; clients block on
``Endpoint.predict``) or synchronously with ``pump()`` /
``run_until_idle()``.
"""
import inspect
import threading

import torch

from ..device import resolve_device
from .runners import BatchRunner
from .scheduler import (STATUS_ERROR, AdmissionQueue, PendingRequest,
                        QueueFullError, Request, WatchdogTimeout)

__all__ = ['ServingEngine', 'Endpoint']

# Idle backstop only: submit() and stop() notify the condition.
_IDLE_TICK = 0.5

# reference arguments whose parts are not ported yet (NotImplementedError)
_LATER_ENGINE_ARGS = frozenset({'tenants'})
_LATER_REGISTER_ARGS = frozenset({
    'program', 'executor', 'predictor', 'generative', 'quantize',
    'calib_data', 'default_max_new_tokens', 'jit_compile', 'kv_cache',
    'page_size', 'num_pages', 'max_concurrency', 'draft', 'draft_k',
    'prefix_cache', 'slo_ms', 'slo_objective', 'artifact_dir'})


def _refuse_later(what, given, later):
    unknown = sorted(set(given) - later)
    if unknown:
        raise TypeError(f"{what}: unexpected keyword arguments {unknown}")
    if given:
        raise NotImplementedError(
            f"{what}: {sorted(given)} belong to parts of the serving engine "
            "not ported to paddle_tpu_torch yet (generative/paged KV, "
            "program/predictor models, quantisation, tenants, SLOs, "
            "artifact dirs); see ROADMAP.md")


class Endpoint:
    """Client-facing handle for one served model."""

    def __init__(self, engine, model):
        self._engine = engine
        self.model = model

    def submit(self, inputs, deadline_ms=None):
        """Enqueue one request -> ``PendingRequest``. Raises
        ``QueueFullError`` when the admission queue sheds it and
        ``ValueError`` when inputs don't match the registered spec."""
        return self._engine.submit(self.model, inputs,
                                   deadline_ms=deadline_ms)

    def predict(self, inputs, deadline_ms=None, timeout=None):
        """Blocking one-call convenience: submit + result."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(
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
        self._submitted = 0

    # -- registration ---------------------------------------------------
    def register(self, name, predict_fn=None, layer=None, example=None,
                 bucket_spec=None, queue_capacity=None, **later):
        """Register one model under ``name``: exactly one of ``predict_fn``
        / ``layer``, plus ``example`` (one request's inputs, no batch axis)
        to pin the shape set. Returns its ``Endpoint``."""
        _refuse_later(f"register({name!r})", later, _LATER_REGISTER_ARGS)
        given = [k for k, v in (('predict_fn', predict_fn),
                                ('layer', layer)) if v is not None]
        if len(given) != 1:
            raise ValueError(
                f"register({name!r}): give exactly one model kind, got "
                f"{given or 'none'}")
        if name in self._models:
            raise ValueError(f"register: model {name!r} already registered")
        if queue_capacity is not None and int(queue_capacity) < 1:
            raise ValueError(
                f"register({name!r}): queue_capacity must be >= 1, got "
                f"{queue_capacity!r}")
        if example is None:
            raise ValueError(
                f"register({name!r}): one-shot models need example= "
                "(one request's inputs, no batch axis) to fix the shape set")
        fn = predict_fn if layer is None else \
            self._layer_fn(name, layer, example)
        queue = AdmissionQueue(name, self.queue_capacity
                               if queue_capacity is None else queue_capacity)
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
    def submit(self, model, inputs, deadline_ms=None):
        runner = self._models.get(model)
        if runner is None:
            raise KeyError(f"serving: no model {model!r} registered")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        req = Request(model, inputs, deadline_ms=deadline_ms)
        runner.validate(req)
        try:
            self._queues[model].push(req)
        except QueueFullError:
            with self._lock:
                self._shed += 1
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
        """Stop the worker; requests still queued are completed as errors
        rather than stranded."""
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
        with self._lock:
            return {
                'submitted': self._submitted,
                'shed': self._shed,
                'queue_depth': {n: len(q) for n, q in self._queues.items()},
                'models': {n: r.stats.as_dict()
                           for n, r in self._models.items()},
            }
