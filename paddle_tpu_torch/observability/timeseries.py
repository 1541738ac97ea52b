"""In-run telemetry time series: a bounded ring sampler over the registry.
The port's own copy of ``paddle_tpu/observability/timeseries.py``.

``registry.snapshot()`` is one frame; a page-pool leak or a throughput
cliff mid-run only shows over time. A ``TimeSeriesSampler`` snapshots
every registered counter and gauge plus histogram p50/p99/count at a fixed
cadence (``PADDLE_TPU_TELEMETRY_SAMPLE_EVERY``, default 1 s; off with
telemetry off) into a bounded ring
(``PADDLE_TPU_TELEMETRY_TIMESERIES_CAP`` samples), so memory stays
O(cap) over arbitrarily long runs.

Counters are **delta-encoded**: each sample stores the increment since the
previous sample (zero deltas are dropped), and deltas evicted off the ring
fold into a per-series base, so ``base + cumsum(deltas)`` always
reconstructs the true cumulative totals. ``export()`` is one process's
document and ``to_series`` turns it into per-series timelines; the
endpoint's ``/timeseries`` serves both. The reference's cross-rank merge
and trend detectors come with ROADMAP.md Queue 1 item 4b.

Stdlib-only.
"""
import collections
import threading

from . import events, registry, state
from .state import rank_id

__all__ = ['TimeSeriesSampler', 'start_sampler', 'stop_sampler',
           'active_sampler', 'export_active', 'to_series', 'clear']

#: histogram stats carried per sample (the trend detectors' working set)
_HIST_KEYS = ('p50', 'p99', 'count')

_lock = threading.Lock()
_active = [None]


class TimeSeriesSampler:
    """Cadenced snapshots of the metrics registry in a bounded ring.

    ``sample_now()`` is the one sample site: a single ``state.enabled()``
    check while telemetry is off, one registry snapshot plus dict
    bookkeeping while on. The sampling thread
    is a daemon off the step path — instrumented code never pays for it.
    """

    def __init__(self, interval=None, capacity=None):
        self.interval = (state.sample_every() if interval is None
                         else float(interval))
        self.capacity = (state.timeseries_cap() if capacity is None
                         else max(2, int(capacity)))
        # explicit ring (not deque(maxlen)): eviction must fold the
        # evicted counter deltas into the base so cumulative totals
        # survive the drop
        self._buf = collections.deque()
        self._base = {}            # counter name -> evicted-delta total
        self._last = {}            # counter name -> raw total at last sample
        self._sample_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    @property
    def n_samples(self):
        return len(self._buf)

    def sample_now(self):
        """Take one sample; returns True when one landed. The only work
        while telemetry is disabled is this first flag check."""
        if not state.enabled():
            return False
        snap = registry.snapshot()
        ts = round(events.wall_ts(), 6)
        with self._sample_lock:
            deltas = {}
            for name, total in snap['counters'].items():
                if not isinstance(total, (int, float)):
                    continue
                d = total - self._last.get(name, 0)
                self._last[name] = total
                if d:
                    deltas[name] = round(d, 6) if isinstance(d, float) else d
            gauges = {k: v for k, v in snap['gauges'].items()
                      if isinstance(v, (int, float))}
            hists = {name: {k: st.get(k, 0) for k in _HIST_KEYS}
                     for name, st in snap['histograms'].items()
                     if st.get('count')}
            self._buf.append({'ts': ts, 'counters': deltas,
                              'gauges': gauges, 'histograms': hists})
            while len(self._buf) > self.capacity:
                evicted = self._buf.popleft()
                for name, d in evicted['counters'].items():
                    self._base[name] = self._base.get(name, 0) + d
        return True

    def export(self):
        """This process's document (None while the ring is empty)."""
        with self._sample_lock:
            if not self._buf:
                return None
            return {
                'rank': rank_id(),
                'sample_every': self.interval,
                'capacity': self.capacity,
                'counters_base': dict(self._base),
                'samples': [dict(s) for s in self._buf],
            }

    def clear(self):
        with self._sample_lock:
            self._buf.clear()
            self._base.clear()
            self._last.clear()

    # -- cadence thread --------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample_now()

    def start(self):
        if self._thread is None and self.interval > 0:
            self._thread = threading.Thread(
                target=self._run, name='paddle-tpu-torch-telemetry-sample',
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            from ..resilience.watchdog import join_thread
            join_thread(t, timeout=max(self.interval * 4, 2.0))
            self._thread = None


def start_sampler(interval=None):
    """Start (or return) the process-wide sampler. None when telemetry is
    disabled or the cadence knob is 0 (sampler off)."""
    if not state.enabled():
        return None
    with _lock:
        sm = _active[0]
        if sm is not None:
            return sm
        sm = TimeSeriesSampler(interval=interval)
        if sm.interval <= 0:
            return None
        _active[0] = sm.start()
        return _active[0]


def stop_sampler():
    """Stop the cadence thread; the ring keeps its samples (the final
    flush still exports them)."""
    with _lock:
        sm = _active[0]
    if sm is not None:
        sm.stop()


def active_sampler():
    return _active[0]


def export_active():
    sm = _active[0]
    return sm.export() if sm is not None else None


def clear():
    """Drop the process-wide sampler and its ring (test isolation)."""
    with _lock:
        sm, _active[0] = _active[0], None
    if sm is not None:
        sm.stop()
        sm.clear()


def to_series(doc, rank=None):
    """Per-series timelines from one rank's export document:
    ``{'counter:<name>'|'gauge:<name>'|'hist:<name>:<stat>':
    {rank: [[ts, value], ...]}}``. Counter timelines carry reconstructed
    cumulative totals (``base + cumsum(deltas)``)."""
    series = {}
    if not isinstance(doc, dict):
        return series
    r = doc.get('rank', 0) if rank is None else rank
    cum = dict(doc.get('counters_base') or {})
    for s in doc.get('samples') or []:
        if not isinstance(s, dict):
            continue
        ts = s.get('ts', 0)
        for name, d in (s.get('counters') or {}).items():
            if isinstance(d, (int, float)):
                cum[name] = cum.get(name, 0) + d
        # dense counter timelines: a sample with no delta still contributes
        # its (unchanged) cumulative point — a qps cliff IS the run of
        # flat points, and dropping them would hide exactly that
        for name, total in cum.items():
            series.setdefault(f'counter:{name}', {}) \
                .setdefault(r, []).append([ts, total])
        for name, v in (s.get('gauges') or {}).items():
            if isinstance(v, (int, float)):
                series.setdefault(f'gauge:{name}', {}) \
                    .setdefault(r, []).append([ts, v])
        for name, st in (s.get('histograms') or {}).items():
            if not isinstance(st, dict):
                continue
            for k in _HIST_KEYS:
                v = st.get(k)
                if isinstance(v, (int, float)):
                    series.setdefault(f'hist:{name}:{k}', {}) \
                        .setdefault(r, []).append([ts, v])
    return series
