"""SLO tracker: per-model latency objectives + error-budget burn.
The port's own copy of ``paddle_tpu/observability/slo.py``.

A serving model registered with a latency objective (``ServingEngine.
register(..., slo_ms=50, slo_objective=0.99)``) gets every completed
request judged against it: a request **violates** when it errored, missed
its deadline, or took longer than ``slo_ms`` end-to-end. The tracker keeps
always-on tallies (the ``_Stats`` discipline — plain dict math, telemetry
mirrors it when enabled) and computes the **error-budget burn rate**::

    burn = (violations / requests) / (1 - objective)

``burn == 1`` means the model is spending its budget exactly as fast as
the objective allows; ``burn > 1`` is an SLO on fire (the reference's
doctor names it; the port's doctor comes with ROADMAP.md Queue 1 item 4b).

Telemetry surface (while enabled): ``slo.requests{model=}`` /
``slo.violations{model=}`` counters, ``slo.burn_rate{model=}`` gauge,
unlabeled ``slo.requests_total`` / ``slo.violations_total`` for the
interposed-counter summary, and one ``slo.violation`` event per bad
request.

``PADDLE_TPU_SLO_MS`` (+ optional ``PADDLE_TPU_SLO_OBJECTIVE``, default
0.99) sets a process-wide default objective for models without an explicit
one. Stdlib-only.
"""
import os
import threading

from . import events, registry, state

__all__ = ['set_objective', 'clear_objective', 'objective', 'objectives',
           'record', 'burn_rates', 'tallies', 'reset']

DEFAULT_OBJECTIVE = 0.99

_lock = threading.Lock()
_objectives = {}     # model -> {'target_ms': float, 'objective': float}
_tallies = {}        # model -> {'requests': int, 'violations': int}


def _env_default():
    raw = os.environ.get('PADDLE_TPU_SLO_MS', '')
    if not raw:
        return None
    try:
        target = float(raw)
    except ValueError:
        return None
    try:
        obj = float(os.environ.get('PADDLE_TPU_SLO_OBJECTIVE', '')
                    or DEFAULT_OBJECTIVE)
    except ValueError:
        obj = DEFAULT_OBJECTIVE
    return {'target_ms': target, 'objective': obj}


def set_objective(model, target_ms, objective=DEFAULT_OBJECTIVE):
    """Declare the latency SLO for ``model``: ``objective`` of requests
    must complete OK within ``target_ms``."""
    target_ms = float(target_ms)
    objective = float(objective)
    if target_ms <= 0:
        raise ValueError(f"slo: target_ms must be > 0, got {target_ms}")
    if not 0.0 < objective < 1.0:
        raise ValueError(
            f"slo: objective must be in (0, 1), got {objective} "
            "(0.99 == 99% of requests within target)")
    with _lock:
        _objectives[model] = {'target_ms': target_ms,
                              'objective': objective}
    return _objectives[model]


def clear_objective(model):
    with _lock:
        _objectives.pop(model, None)
        _tallies.pop(model, None)


def objective(model):
    """The model's objective dict, the env default, or None (untracked)."""
    with _lock:
        obj = _objectives.get(model)
    return obj or _env_default()


def objectives():
    with _lock:
        out = {m: dict(o) for m, o in _objectives.items()}
    env = _env_default()
    if env:
        out.setdefault('*', env)
    return out


def record(model, status, latency_ms):
    """Judge one completed request against the model's objective. Returns
    the updated burn rate, or None when the model has no objective.
    Always-on tallies; telemetry mirrored only while enabled."""
    obj = objective(model)
    if obj is None:
        return None
    violated = status != 'ok' or float(latency_ms) > obj['target_ms']
    with _lock:
        t = _tallies.setdefault(model, {'requests': 0, 'violations': 0})
        t['requests'] += 1
        if violated:
            t['violations'] += 1
        requests, violations = t['requests'], t['violations']
    budget = max(1.0 - obj['objective'], 1e-9)
    burn = (violations / requests) / budget
    if state.enabled():
        lbl = {'model': str(model)}
        registry.counter('slo.requests', labels=lbl).inc()
        registry.counter('slo.requests_total').inc()
        registry.gauge('slo.burn_rate', labels=lbl).set(round(burn, 4))
        if violated:
            registry.counter('slo.violations', labels=lbl).inc()
            registry.counter('slo.violations_total').inc()
            events.emit('slo.violation', model=str(model), status=status,
                        latency_ms=round(float(latency_ms), 3),
                        target_ms=obj['target_ms'],
                        objective=obj['objective'],
                        burn_rate=round(burn, 4))
    return burn


def burn_rates():
    """{model: burn} for every tracked model with traffic."""
    out = {}
    with _lock:
        items = [(m, dict(t)) for m, t in _tallies.items()]
    for model, t in items:
        obj = objective(model)
        if obj is None or not t['requests']:
            continue
        budget = max(1.0 - obj['objective'], 1e-9)
        out[model] = round((t['violations'] / t['requests']) / budget, 4)
    return out


def tallies():
    with _lock:
        return {m: dict(t) for m, t in _tallies.items()}


def reset():
    with _lock:
        _objectives.clear()
        _tallies.clear()
