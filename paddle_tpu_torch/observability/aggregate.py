"""Cross-rank telemetry aggregation: the supervisor side of mission control.
The port's own copy of ``paddle_tpu/observability/aggregate.py``.

Reads the per-rank files a ``flush.RankFlusher`` writes into a run dir
(``telemetry_rank<R>.json`` / ``events_rank<R>.jsonl`` /
``trace_rank<R>.json``, plus a supervisor's ``hb_<R>`` heartbeat files
where there are any; the port's heartbeats come with the fleet supervisor)
and merges them into:

- ``cluster_snapshot(run_dir)`` — one dict: per-rank step-time stats,
  compile/retrace counters, heartbeat ages, and cluster-wide counter
  totals. A straggling rank shows up as a skewed ``step_ms`` row, a
  rebuild storm as one rank's ``kernel_builds`` still climbing (the
  reference's ``jax_compiles`` / ``jax_traces``).
- ``merged_events(run_dir)`` — every rank's JSONL events, rank-stamped and
  time-ordered: the stream the anomaly doctor diagnoses.
- ``merged_chrome_trace(run_dir)`` — a single Perfetto-loadable trace with
  ONE LANE PER RANK (rank = pid row, named ``rank <R> (host:pid)``), so a
  slow collective or straggling rank is visible as skewed lanes instead of
  a hang.
- ``merged_timeseries(run_dir)`` — per-series timelines merged from every
  rank's ``timeseries_rank<R>.json`` ring-sampler export (also embedded in
  the cluster snapshot under ``timeseries``): the trend evidence the
  doctor's ``page_leak`` / ``latency_creep`` / ``qps_collapse`` /
  ``compile_creep`` detectors read.
- ``write_merged(run_dir)`` — commits all three artifacts
  (``cluster_snapshot.json`` / ``merged_events.jsonl`` /
  ``merged_trace.json``) back into the run dir.

Deliberately standalone: stdlib-only and importable BY PATH (no package
imports), so a run dir can be aggregated on a machine with no torch
installed.
"""
import json
import os
import re
import time

__all__ = ['rank_files', 'load_rank_snapshots', 'heartbeat_ages',
           'cluster_snapshot', 'merged_events', 'merged_chrome_trace',
           'merged_timeseries', 'flight_dumps', 'write_merged']

_RANK_FILE_RE = re.compile(
    r'^(telemetry|events|trace|flight|timeseries)_rank(\d+)\.(json|jsonl)$')

#: histogram stats carried per time-series sample (mirrors timeseries.py)
_TS_HIST_KEYS = ('p50', 'p99', 'count')


def rank_files(run_dir):
    """``{rank: {'telemetry': path, 'events': path, 'trace': path}}`` for
    every per-rank telemetry file present in ``run_dir``."""
    out = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in sorted(names):
        m = _RANK_FILE_RE.match(name)
        if not m:
            continue
        kind, rank = m.group(1), int(m.group(2))
        out.setdefault(rank, {})[kind] = os.path.join(run_dir, name)
    return out


def _load_json(path):
    try:
        with open(path, 'r', encoding='utf-8') as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_rank_snapshots(run_dir):
    """``{rank: head-dict}`` from each rank's ``telemetry_rank<R>.json``
    (rank/pid/host/ts/metrics/counters); unreadable files are skipped."""
    out = {}
    for rank, files in rank_files(run_dir).items():
        path = files.get('telemetry')
        if not path:
            continue
        head = _load_json(path)
        if isinstance(head, dict):
            out[rank] = head
    return out


def heartbeat_ages(run_dir, ranks=None):
    """Seconds since each rank's ``hb_<R>`` heartbeat file was touched
    (None = never written). Ranks default to every hb file present."""
    ages = {}
    if ranks is None:
        try:
            ranks = sorted(
                int(n[3:]) for n in os.listdir(run_dir)
                if n.startswith('hb_') and n[3:].isdigit())
        except OSError:
            ranks = []
    for rank in ranks:
        path = os.path.join(run_dir, f'hb_{rank}')
        try:
            ages[rank] = round(
                max(time.time() - os.path.getmtime(path), 0.0), 3)
        except OSError:
            ages[rank] = None
    return ages


def _hist(metrics, name):
    return (metrics or {}).get('histograms', {}).get(name) or {}


def cluster_snapshot(run_dir):
    """One cluster-wide dict merged from every rank's snapshot file.

    ``per_rank[rank]``: host/pid, flush ts, ``step_ms`` stats (hapi step
    histogram), step/kernel-build/host-transfer tallies, dataloader
    wait sums, and heartbeat age. ``counters_total``: cluster sums of the
    interposed-counter summary. ``step_ms_skew``: max/median of per-rank
    mean step time — the straggler headline number."""
    heads = load_rank_snapshots(run_dir)
    ages = heartbeat_ages(run_dir, ranks=sorted(heads) or None)
    flights = flight_dumps(run_dir)
    per_rank, totals = {}, {}
    for rank, head in sorted(heads.items()):
        metrics = head.get('metrics') or {}
        counters = head.get('counters') or {}
        step = _hist(metrics, 'hapi.step_ms') or _hist(metrics, 'step_ms')
        per_rank[rank] = {
            'host': head.get('host'),
            'pid': head.get('pid'),
            'ts': head.get('ts'),
            'steps': step.get('count', 0),
            'step_ms': {k: step.get(k, 0.0)
                        for k in ('count', 'mean', 'p50', 'p99', 'max')},
            'kernel_builds': counters.get('kernel_builds', 0),
            'host_transfer_bytes': counters.get('host_transfer_bytes', 0),
            'dataloader_wait_ms_sum': round(
                _hist(metrics, 'dataloader.next_wait_ms').get('sum', 0.0),
                3),
            'heartbeat_age_s': ages.get(rank),
        }
        for k, v in counters.items():
            if isinstance(v, (int, float)):
                totals[k] = round(totals.get(k, 0) + v, 3)
    means = [r['step_ms']['mean'] for r in per_rank.values()
             if r['step_ms'].get('count')]
    skew = 0.0
    if means:
        # lower median: with an even rank count the upper middle can BE the
        # straggler, flattening the very skew this number exists to show
        med = sorted(means)[(len(means) - 1) // 2]
        skew = round(max(means) / med, 3) if med > 0 else 0.0
    return {
        'run_dir': os.path.abspath(run_dir),
        'n_ranks': len(per_rank),
        'per_rank': per_rank,
        'counters_total': totals,
        'heartbeat_age_s': ages,
        'step_ms_skew': skew,
        # crash post-mortems: {rank: {reason, ts, exception?}} for every
        # flight_rank<R>.json a dying rank left behind — a rank may have a
        # dump and NO telemetry head (telemetry off, flight always-on)
        'flight_dumps': flights,
        # per-series timelines from the ring sampler (empty series dict
        # when no rank wrote a timeseries file — sampler off or old run)
        'timeseries': merged_timeseries(run_dir),
    }


def flight_dumps(run_dir):
    """``{rank: {'reason', 'ts', 'path', 'exception'?}}`` for every
    flight-recorder dump in the run dir (``flight.load_dump`` reads the
    full documents; the snapshot carries the headline)."""
    out = {}
    for rank, files in rank_files(run_dir).items():
        path = files.get('flight')
        if not path:
            continue
        doc = _load_json(path)
        if not isinstance(doc, dict) or 'reason' not in doc:
            continue
        row = {'reason': doc.get('reason'), 'ts': doc.get('ts'),
               'path': path}
        exc = doc.get('exception')
        if isinstance(exc, dict):
            row['exception'] = {'type': exc.get('type'),
                                'message': exc.get('message')}
        out[rank] = row
    return out


def merged_timeseries(run_dir):
    """Per-series timelines merged from every rank's
    ``timeseries_rank<R>.json`` (the ring sampler's delta-encoded export).

    Returns ``{'sample_every', 'per_rank': {rank: {'n_samples',
    'span_s'}}, 'series': {'counter:<name>'|'gauge:<name>'|
    'hist:<name>:<stat>': {rank: [[ts, value], ...]}}}`` — the shape the
    doctor's trend detectors consume.
    Counter timelines carry reconstructed cumulative totals
    (``counters_base + cumsum(deltas)``) and are dense: a sample with no
    delta still contributes its unchanged point, because a qps cliff IS
    the run of flat points. (Logic duplicated from ``timeseries.to_series``
    — this module stays standalone / importable by path.)"""
    series, per_rank, sample_every = {}, {}, None
    for rank, files in sorted(rank_files(run_dir).items()):
        path = files.get('timeseries')
        if not path:
            continue
        doc = _load_json(path)
        if not isinstance(doc, dict):
            continue
        samples = [s for s in (doc.get('samples') or [])
                   if isinstance(s, dict)]
        if sample_every is None and doc.get('sample_every'):
            sample_every = doc['sample_every']
        ts_list = [s.get('ts', 0) for s in samples]
        per_rank[rank] = {
            'n_samples': len(samples),
            'span_s': round(max(ts_list) - min(ts_list), 3)
            if len(ts_list) > 1 else 0.0,
        }
        cum = {k: v for k, v in (doc.get('counters_base') or {}).items()
               if isinstance(v, (int, float))}
        for s in samples:
            ts = s.get('ts', 0)
            for name, d in (s.get('counters') or {}).items():
                if isinstance(d, (int, float)):
                    cum[name] = cum.get(name, 0) + d
            for name, total in cum.items():
                series.setdefault(f'counter:{name}', {}) \
                    .setdefault(rank, []).append([ts, total])
            for name, v in (s.get('gauges') or {}).items():
                if isinstance(v, (int, float)):
                    series.setdefault(f'gauge:{name}', {}) \
                        .setdefault(rank, []).append([ts, v])
            for name, st in (s.get('histograms') or {}).items():
                if not isinstance(st, dict):
                    continue
                for k in _TS_HIST_KEYS:
                    v = st.get(k)
                    if isinstance(v, (int, float)):
                        series.setdefault(f'hist:{name}:{k}', {}) \
                            .setdefault(rank, []).append([ts, v])
    return {'sample_every': sample_every, 'per_rank': per_rank,
            'series': series}


def merged_events(run_dir):
    """Every rank's events, rank-stamped, ordered by wall timestamp."""
    out = []
    for rank, files in rank_files(run_dir).items():
        path = files.get('events')
        if not path:
            continue
        try:
            with open(path, 'r', encoding='utf-8') as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                rec.setdefault('rank', rank)
                out.append(rec)
    out.sort(key=lambda e: (e.get('ts', 0), e.get('rank', 0)))
    return out


def merged_chrome_trace(run_dir):
    """One Chrome trace-event list with a lane per rank.

    Each rank's span buffer uses its own pid/tid; remapping pid -> rank
    (plus ``process_name``/``process_sort_index`` metadata) gives Perfetto
    one named, ordered lane per rank, so cross-rank skew reads directly
    off the timeline."""
    heads = load_rank_snapshots(run_dir)
    out = []
    for rank, files in sorted(rank_files(run_dir).items()):
        path = files.get('trace')
        if not path:
            continue
        evs = _load_json(path)
        if not isinstance(evs, list):
            continue
        head = heads.get(rank) or {}
        label = f"rank {rank}"
        if head.get('host') or head.get('pid'):
            label += f" ({head.get('host', '?')}:{head.get('pid', '?')})"
        out.append({'name': 'process_name', 'ph': 'M', 'pid': rank,
                    'args': {'name': label}})
        out.append({'name': 'process_sort_index', 'ph': 'M', 'pid': rank,
                    'args': {'sort_index': rank}})
        for ev in evs:
            if isinstance(ev, dict):
                ev = dict(ev, pid=rank)
                out.append(ev)
    return out


def _commit(path, text):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, 'w', encoding='utf-8') as f:   # atomic-ok: staged,
        f.write(text)                             # committed by rename
    os.replace(tmp, path)


def write_merged(run_dir, out_dir=None):
    """Aggregate ``run_dir`` and commit the three merged artifacts into
    ``out_dir`` (default: the run dir itself). Returns
    ``{'snapshot': path, 'events': path, 'trace': path, 'n_ranks': n}``
    or None when the run dir has no per-rank telemetry files."""
    snap = cluster_snapshot(run_dir)
    if not snap['n_ranks']:
        return None
    out_dir = os.fspath(out_dir or run_dir)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        'snapshot': os.path.join(out_dir, 'cluster_snapshot.json'),
        'events': os.path.join(out_dir, 'merged_events.jsonl'),
        'trace': os.path.join(out_dir, 'merged_trace.json'),
    }
    _commit(paths['snapshot'], json.dumps(snap, sort_keys=True, indent=1))
    _commit(paths['events'], ''.join(
        json.dumps(e, sort_keys=True) + '\n' for e in merged_events(run_dir)))
    _commit(paths['trace'], json.dumps(merged_chrome_trace(run_dir)))
    paths['n_ranks'] = snap['n_ranks']
    return paths
