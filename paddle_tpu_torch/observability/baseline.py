"""Cross-run performance baseline: the ``runs.jsonl`` registry + sentinel.
The port's own copy of ``paddle_tpu/observability/baseline.py``.

The in-run time series (``timeseries.py``) answers "what changed during
this run"; this module answers "what changed since last run". A run
appends one summary record (its metrics, counter totals, the cost
ledger's headline and a config fingerprint) to an append-only JSONL
registry with ``record_run``, and ``detect_regressions`` compares the
latest record against the rolling median of the prior runs, per metric:

- **robust**: rolling median + MAD (median absolute deviation), so one
  noisy historical run cannot drag the baseline; a metric must deviate by
  ``mad_k`` robust sigmas AND ``rel_threshold`` relative before it counts.
- **min-sample guard**: no verdicts until ``min_samples`` prior runs carry
  the metric — a two-run history proves nothing.
- **direction-aware**: qps/throughput DOWN is bad, latency/stall/compile
  UP is bad; metrics whose good direction is unknown stay quiet instead
  of guessing.

Registry record schema (one JSON object per line)::

    {'ts': 1722999999.5,            # epoch seconds (stamped if absent)
     'run': 'smoke',                # optional label
     'fingerprint': 'a3f9c2e1',     # config identity (same-config compare)
     'metrics': {'serving.latency_ms.p99': 12.5, 'train.qps': 3041, ...},
     'meta': {...}}                 # free-form, ignored by detection

Read by the doctor's ``perf_regression`` detector (the reference's
``tools/perfwatch.py`` has no port yet). Stdlib-only and importable BY
PATH (no package imports at load); writes go through
``resilience.atomic_io`` when the package is importable, else the same
staged-rename spelling locally.
"""
import json
import os
import tempfile
import time

__all__ = ['default_runs_path', 'record_run', 'load_runs', 'flatten',
           'detect_regressions', 'compare', 'history', 'bad_direction']

#: metric-name markers whose GOOD direction is up (drop = regression) ...
_DOWN_BAD_MARKERS = ('qps', 'throughput', 'samples_per_sec',
                     'tokens_per_sec', 'goodput', 'bandwidth')
#: ... and whose BAD direction is up (growth = regression)
_UP_BAD_MARKERS = ('_ms', 'latency', 'p50', 'p99', 'stall', 'wait',
                   'compile', 'retrace', 'shed', 'expired', 'evict',
                   'preempt', 'restart', 'failure', 'error', 'cost',
                   'bytes')


def default_runs_path():
    """``PADDLE_TPU_RUNS_REGISTRY`` if set, else ``runs.jsonl`` under the
    telemetry dir (matching ``state.log_dir()`` without importing it)."""
    explicit = os.environ.get('PADDLE_TPU_RUNS_REGISTRY')
    if explicit:
        return explicit
    base = os.environ.get('PADDLE_TPU_TELEMETRY_DIR',
                          os.path.join(tempfile.gettempdir(),
                                       'paddle_tpu_telemetry'))
    return os.path.join(base, 'runs.jsonl')


def _atomic_write():
    """``resilience.atomic_io.atomic_write`` when this module was loaded
    as part of the package (imported at first use: the resilience
    modules import the observability package), else None."""
    if not __package__:
        return None
    try:
        from ..resilience.atomic_io import atomic_write
    except ImportError:
        return None
    return atomic_write


def _commit(path, text):
    atomic_write = _atomic_write()
    if atomic_write is not None:
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        atomic_write(path, text.encode('utf-8'))
        return
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, 'w', encoding='utf-8') as f:   # atomic-ok: staged,
        f.write(text)                             # committed by rename
    os.replace(tmp, path)


def record_run(record, path=None):
    """Append one run record to the registry (whole-file rewrite committed
    by rename, so a concurrent reader never sees a torn line). Stamps
    ``ts`` when absent. Returns the registry path."""
    path = path or default_runs_path()
    record = dict(record)
    record.setdefault('ts', round(time.time(), 3))
    lines = []
    try:
        with open(path, 'r', encoding='utf-8') as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    except OSError:
        pass
    lines.append(json.dumps(record, sort_keys=True, default=repr))
    _commit(path, '\n'.join(lines) + '\n')
    return path


def load_runs(path=None):
    """Every parseable record in the registry, file order (= append
    order: oldest first, latest last)."""
    path = path or default_runs_path()
    out = []
    try:
        with open(path, 'r', encoding='utf-8') as f:
            text = f.read()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def flatten(record):
    """Numeric metrics of one record as a flat ``{dotted_name: value}``
    (nested dicts flatten with ``.`` joins; non-numeric leaves drop)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            out[prefix] = node

    walk('', (record or {}).get('metrics') or {})
    return out


def bad_direction(metric):
    """``'down'`` when a drop regresses (qps-like), ``'up'`` when growth
    regresses (latency-like), None when unknown (stay quiet, don't
    guess)."""
    name = metric.lower()
    if any(m in name for m in _DOWN_BAD_MARKERS):
        return 'down'
    if any(m in name for m in _UP_BAD_MARKERS):
        return 'up'
    return None


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    mid = vals[n // 2]
    return (vals[n // 2 - 1] + mid) / 2 if n % 2 == 0 else mid


def detect_regressions(runs, min_samples=4, mad_k=4.0, rel_threshold=0.2,
                       same_fingerprint=True):
    """Latest run vs the rolling median+MAD of prior runs, per metric.

    Prior runs filter to the latest record's config fingerprint when it
    has one and enough matches exist (``same_fingerprint``) — comparing a
    new config against an old one measures the config change, not a
    regression; with too few same-config priors the full history is the
    baseline. Returns one dict per regressed metric::

        {'metric', 'value', 'median', 'mad', 'rel_change', 'direction',
         'bad_direction', 'n_baseline'}
    """
    if len(runs) < min_samples + 1:
        return []
    last, prior = runs[-1], runs[:-1]
    fp = last.get('fingerprint')
    if same_fingerprint and fp:
        matching = [r for r in prior if r.get('fingerprint') == fp]
        if len(matching) >= min_samples:
            prior = matching
    last_metrics = flatten(last)
    history_by_metric = {}
    for rec in prior:
        for name, v in flatten(rec).items():
            history_by_metric.setdefault(name, []).append(v)
    out = []
    for name, value in sorted(last_metrics.items()):
        bad = bad_direction(name)
        if bad is None:
            continue
        hist = history_by_metric.get(name) or []
        if len(hist) < min_samples:
            continue
        med = _median(hist)
        mad = _median([abs(v - med) for v in hist])
        # robust sigma with a relative floor: a perfectly flat history
        # (mad 0) must not turn measurement noise into a verdict
        scale = max(mad * 1.4826, abs(med) * 0.05, 1e-9)
        dev = (value - med) / scale
        rel = (value - med) / max(abs(med), 1e-9)
        direction = 'up' if value > med else 'down'
        if direction != bad:
            continue
        if abs(dev) < mad_k or abs(rel) < rel_threshold:
            continue
        out.append({'metric': name, 'value': value,
                    'median': round(med, 6), 'mad': round(mad, 6),
                    'rel_change': round(rel, 4), 'direction': direction,
                    'bad_direction': bad, 'n_baseline': len(hist)})
    out.sort(key=lambda r: -abs(r['rel_change']))
    return out


def compare(runs_or_path=None, **kw):
    """Convenience wrapper: latest-vs-history verdict for the CLI/doctor.
    Accepts a loaded run list or a registry path (None = default path)."""
    runs = (runs_or_path if isinstance(runs_or_path, list)
            else load_runs(runs_or_path))
    verdict = {'n_runs': len(runs), 'regressions': [],
               'last': runs[-1] if runs else None}
    if runs:
        verdict['regressions'] = detect_regressions(runs, **kw)
    return verdict


def history(runs, metric):
    """``[(ts, value), ...]`` for one metric across the registry."""
    out = []
    for rec in runs:
        v = flatten(rec).get(metric)
        if v is not None:
            out.append((rec.get('ts', 0), v))
    return out
