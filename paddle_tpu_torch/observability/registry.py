"""Process-wide metrics registry: counters, gauges, bounded histograms.
The port's own copy of ``paddle_tpu/observability/registry.py``: the same
calls give the same ``snapshot()`` and byte-identical ``to_prometheus()``
text, labels and escaping included.

One thread-safe singleton (``get_registry()``) shared by every instrumented
layer; exporters read a consistent ``snapshot()`` or the Prometheus-style
text exposition (``to_prometheus()``). All instruments are created lazily by
name — ``counter('executor.program_cache.misses').inc()`` is the whole API
at a call site — so instrumentation never needs registration boilerplate.

Instruments may carry **labels** (``counter('cluster.step_ms', labels=
{'rank': '3'})``): one metric family, many label sets — the shape the
cross-rank aggregator and the Prometheus exposition need for per-rank
series. A family's label *keys* are pinned by its first use; re-creating
the same name with a different key set raises (two meanings under one
exposition name would silently merge in a scrape).

Updates are metric-local locks (an ``inc()`` never contends with an
unrelated ``observe()``); creation takes the registry lock once per name.
"""
import math
import random
import re
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry',
           'get_registry', 'counter', 'gauge', 'histogram',
           'reset', 'snapshot', 'to_prometheus', 'escape_label_value']


def _norm_labels(labels):
    """Validated ``{str: str}`` copy of a labels mapping (or None)."""
    if not labels:
        return None
    out = {}
    for k, v in labels.items():
        k = str(k)
        if not re.match(r'^[a-zA-Z_][a-zA-Z0-9_]*$', k):
            raise ValueError(f"invalid metric label name {k!r}")
        out[k] = str(v)
    return out


def _labels_key(labels):
    """Canonical instrument-key suffix for a label set ('' when unlabeled).
    json keeps values with commas/quotes unambiguous."""
    if not labels:
        return ''
    import json
    return json.dumps(labels, sort_keys=True, separators=(',', ':'))


class Counter:
    """Monotonically increasing value (int or float increments)."""

    kind = 'counter'

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = _norm_labels(labels)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache size, ...)."""

    kind = 'gauge'

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = _norm_labels(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value


class Histogram:
    """Streaming distribution with a bounded reservoir.

    Exact count/sum/min/max plus a ``reservoir_size``-bounded uniform sample
    (Vitter's algorithm R, deterministic per-instrument seed) for quantile
    estimates — memory stays O(reservoir) over arbitrarily long runs.
    """

    kind = 'histogram'

    def __init__(self, name, reservoir_size=512, labels=None):
        self.name = name
        self.labels = _norm_labels(labels)
        self.reservoir_size = int(reservoir_size)
        self._lock = threading.Lock()
        self._rng = random.Random(hash(name) & 0xffffffff)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir = []

    def observe(self, x):
        x = float(x)
        with self._lock:
            self.count += 1
            self.sum += x
            self.min = min(self.min, x)
            self.max = max(self.max, x)
            if len(self._reservoir) < self.reservoir_size:
                self._reservoir.append(x)
            else:
                j = self._rng.randrange(self.count)
                if j < self.reservoir_size:
                    self._reservoir[j] = x

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p):
        """Estimated p-th percentile (0..100) from the reservoir."""
        with self._lock:
            if not self._reservoir:
                return 0.0
            vals = sorted(self._reservoir)
        k = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[k]

    def stats(self):
        with self._lock:
            if not self.count:
                return {'count': 0, 'sum': 0.0, 'min': 0.0, 'max': 0.0,
                        'mean': 0.0, 'p50': 0.0, 'p99': 0.0}
        return {'count': self.count, 'sum': self.sum, 'min': self.min,
                'max': self.max, 'mean': self.mean,
                'p50': self.percentile(50), 'p99': self.percentile(99)}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}        # (name, labels_key) -> instrument
        self._label_keys = {}     # name -> frozenset of label key names
        self._kinds = {}          # name -> instrument class (one per family)

    def _get(self, cls, name, labels=None, **kwargs):
        labels = _norm_labels(labels)
        key = (name, _labels_key(labels))
        keyset = frozenset(labels) if labels else frozenset()
        with self._lock:
            # kind is pinned per FAMILY, not per (name, labels) — a
            # counter('x', m=a) followed by gauge('x', m=b) would otherwise
            # be created fine and then poison every to_prometheus() call
            pinned_cls = self._kinds.get(name)
            if pinned_cls is not None and pinned_cls is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{pinned_cls.kind}, requested as {cls.kind}")
            m = self._metrics.get(key)
            if m is None:
                pinned = self._label_keys.get(name)
                if pinned is not None and pinned != keyset:
                    raise ValueError(
                        f"metric {name!r} already registered with label set "
                        f"{sorted(pinned) or '(none)'}, requested with "
                        f"{sorted(keyset) or '(none)'} — one family, one "
                        "label key set (a scrape would merge two meanings "
                        "under one exposition name)")
                m = cls(name, labels=labels, **kwargs)
                self._metrics[key] = m
                self._label_keys.setdefault(name, keyset)
                self._kinds.setdefault(name, cls)
            return m

    def counter(self, name, labels=None):
        return self._get(Counter, name, labels=labels)

    def gauge(self, name, labels=None):
        return self._get(Gauge, name, labels=labels)

    def histogram(self, name, reservoir_size=512, labels=None):
        return self._get(Histogram, name, labels=labels,
                         reservoir_size=reservoir_size)

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._label_keys.clear()
            self._kinds.clear()

    def _sorted_instruments(self):
        with self._lock:
            items = list(self._metrics.items())
        return [m for _, m in sorted(items, key=lambda kv: kv[0])]

    def snapshot(self):
        """Consistent point-in-time dict: counters/gauges as scalars,
        histograms as their stats dicts. Labeled instruments appear under
        ``name{k=v,...}`` keys (sorted label order)."""
        out = {'counters': {}, 'gauges': {}, 'histograms': {}}
        for m in self._sorted_instruments():
            key = m.name if not m.labels else m.name + '{' + ','.join(
                f"{k}={v}" for k, v in sorted(m.labels.items())) + '}'
            if m.kind == 'counter':
                out['counters'][key] = m.value
            elif m.kind == 'gauge':
                out['gauges'][key] = m.value
            else:
                out['histograms'][key] = m.stats()
        return out

    def to_prometheus(self, prefix='paddle_tpu'):
        """Prometheus-style text exposition.

        Metric names are sanitized to ``[a-z0-9_]``; label values are
        escaped per the exposition format (backslash, double-quote, and
        newline); histograms are exposed summary-style. Two distinct
        metric families that sanitize to the SAME exposition name (e.g. a
        serving counter and a dataloader counter differing only in
        punctuation) raise instead of silently merging their series."""
        by_name = {}    # exposition name -> (raw name, kind, [instruments])
        for m in self._sorted_instruments():
            n = _sanitize(prefix, m.name)
            entry = by_name.get(n)
            if entry is None:
                by_name[n] = (m.name, m.kind, [m])
            elif entry[0] != m.name or entry[1] != m.kind:
                raise ValueError(
                    f"metric-name collision in Prometheus exposition: "
                    f"{entry[0]!r} ({entry[1]}) and {m.name!r} ({m.kind}) "
                    f"both sanitize to {n!r} — rename one family")
            else:
                entry[2].append(m)
        lines = []
        for n, (_raw, kind, instruments) in by_name.items():
            if kind == 'histogram':
                lines.append(f"# TYPE {n} summary")
                for m in instruments:
                    st = m.stats()
                    lbl = _render_labels(m.labels)
                    lines.append(f"{n}_count{lbl} {st['count']}")
                    lines.append(f"{n}_sum{lbl} {_fmt(st['sum'])}")
                    for q, key in (('0.5', 'p50'), ('0.99', 'p99')):
                        qlbl = _render_labels(dict(m.labels or {},
                                                   quantile=q))
                        lines.append(f"{n}{qlbl} {_fmt(st[key])}")
            else:
                lines.append(f"# TYPE {n} {kind}")
                for m in instruments:
                    lines.append(
                        f"{n}{_render_labels(m.labels)} {_fmt(m.value)}")
        return '\n'.join(lines) + ('\n' if lines else '')


def _sanitize(prefix, name):
    return re.sub(r'[^a-zA-Z0-9_]', '_', f"{prefix}_{name}").lower()


def escape_label_value(v):
    """Escape one label value per the Prometheus text exposition format:
    backslash, double-quote, and line feed."""
    return (str(v).replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


def _render_labels(labels):
    if not labels:
        return ''
    inner = ','.join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return '{' + inner + '}'


def _fmt(v):
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


_REGISTRY = MetricsRegistry()


def get_registry():
    return _REGISTRY


def counter(name, labels=None):
    return _REGISTRY.counter(name, labels=labels)


def gauge(name, labels=None):
    return _REGISTRY.gauge(name, labels=labels)


def histogram(name, reservoir_size=512, labels=None):
    return _REGISTRY.histogram(name, reservoir_size=reservoir_size,
                               labels=labels)


def reset():
    _REGISTRY.reset()


def snapshot():
    return _REGISTRY.snapshot()


def to_prometheus(prefix='paddle_tpu'):
    return _REGISTRY.to_prometheus(prefix=prefix)
