#!/usr/bin/env python
"""doctor: ranked anomaly diagnosis for a paddle_tpu_torch run dir or live
endpoint. Counterpart of the reference's ``tools/doctor.py``.

Usage::

    python paddle_tpu_torch/tools/doctor.py <run_dir>   # per-rank telemetry
                                                # files, or a
                                                # TelemetryCallback log dir
    python paddle_tpu_torch/tools/doctor.py <events.jsonl>  # an event log
    python paddle_tpu_torch/tools/doctor.py --url http://127.0.0.1:9100
    python paddle_tpu_torch/tools/doctor.py <run_dir> --json
    python paddle_tpu_torch/tools/doctor.py <run_dir> --fail-on critical
                                                # CI gate: exit 1
    python paddle_tpu_torch/tools/doctor.py <run_dir> --fail-on slo_burn
                                                # gate on specific causes

Reads whatever evidence the path holds — per-rank ``telemetry_rank<R>``
files (merged into a cluster snapshot), heartbeat files, merged or
single-process ``events.jsonl`` — runs every anomaly detector (straggler,
retrace storm, input-bound, serving overload, rank flatline), and prints
the ranked report with a fix-it per finding. Stdlib-only: loads
``paddle_tpu_torch/observability/{aggregate,doctor}.py`` BY PATH, so it
runs without importing torch (or the package) and on a machine with no
torch installed. Importing this file as ``paddle_tpu_torch.tools.doctor``
does nothing but define its functions.
"""
import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_OBS_DIR = os.path.join(os.path.dirname(_HERE), 'observability')


def load_obs_module(name):
    """Load paddle_tpu_torch/observability/<name>.py standalone (no
    package, no torch): aggregate.py and doctor.py are written to be
    importable this way."""
    path = os.path.join(_OBS_DIR, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'_mc_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_jsonl(path):
    events = []
    with open(path, 'r', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                events.append(rec)
    return events


def merged_snapshot(run_dir, aggregate):
    """Cluster-merged registry snapshot from each rank's telemetry head.

    The head's ``metrics`` field is a full ``registry.snapshot()`` — the
    same ``{'counters': {dotted}, 'gauges': ...}`` shape the in-process
    detectors consume (``kernels.*``, ``serving.*``, ...), which the
    curated flat ``counters`` summary does not carry. Counters sum across
    ranks; gauges take the max (a gauge is a level, not a tally). Returns
    ``None`` when no rank recorded either."""
    counters, gauges = {}, {}
    for _, head in sorted(aggregate.load_rank_snapshots(run_dir).items()):
        snap = head.get('metrics') or {}
        for k, v in (snap.get('counters') or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (snap.get('gauges') or {}).items():
            if isinstance(v, (int, float)):
                gauges[k] = max(gauges.get(k, v), v)
    if not counters and not gauges:
        return None
    return {'counters': counters, 'gauges': gauges}


def gather(path, aggregate):
    """(events, snapshot, cluster, describe-string) for a run dir / log
    dir / jsonl file."""
    if os.path.isfile(path):
        return load_jsonl(path), None, None, f"event log {path}"
    cluster = None
    snapshot = None
    events = []
    parts = []
    if aggregate.rank_files(path):
        cluster = aggregate.cluster_snapshot(path)
        snapshot = merged_snapshot(path, aggregate)
        events = aggregate.merged_events(path)
        parts.append(f"{cluster['n_ranks']} rank(s), "
                     f"step skew {cluster['step_ms_skew']}x")
    else:
        ages = aggregate.heartbeat_ages(path)
        if ages:
            cluster = {'per_rank': {}, 'heartbeat_age_s': ages,
                       'n_ranks': 0, 'counters_total': {},
                       'step_ms_skew': 0.0}
            parts.append(f"{len(ages)} heartbeat file(s)")
    for name in ('merged_events.jsonl', 'events.jsonl'):
        if not events and os.path.exists(os.path.join(path, name)):
            events = load_jsonl(os.path.join(path, name))
            parts.append(name)
    if events and not any('event' in p for p in parts):
        parts.append(f"{len(events)} event(s)")
    return (events, snapshot, cluster,
            f"run dir {path} ({', '.join(parts) or 'empty'})")


def from_url(url):
    """Ask a live endpoint for its own diagnosis (+ health context)."""
    from urllib.request import urlopen
    from urllib.error import URLError
    url = url.rstrip('/')
    try:
        diagnoses = json.load(urlopen(f"{url}/diagnosis", timeout=10))
    except (URLError, OSError, ValueError) as e:
        print(f"doctor: cannot reach {url}/diagnosis: {e}", file=sys.stderr)
        return None, None
    try:
        health = json.load(urlopen(f"{url}/healthz", timeout=10))
    except Exception:
        health = None
    return diagnoses, health


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='doctor',
        description='ranked anomaly diagnosis over paddle_tpu_torch '
                    'telemetry')
    p.add_argument('path', nargs='?',
                   help='run dir with per-rank telemetry files, a '
                        'TelemetryCallback log dir, or an events.jsonl')
    p.add_argument('--url', default=None,
                   help='live /metrics endpoint base URL instead of a path '
                        '(e.g. http://127.0.0.1:9100)')
    p.add_argument('--json', action='store_true', dest='as_json',
                   help='print the diagnoses as JSON')
    p.add_argument('--fail-on', default=None, metavar='SEVERITY|CAUSE[,..]',
                   help='exit 1 when any finding matches — CI gate mode. '
                        'Accepts a severity (critical/warning/info: fail '
                        'at or above it) and/or specific causes '
                        '(straggler, retrace_storm, memory_pressure, '
                        'slo_burn, ...), comma-separated')
    args = p.parse_args(argv)
    if bool(args.path) == bool(args.url):
        p.error('give exactly one of <path> or --url')

    doctor = load_obs_module('doctor')
    if args.url:
        diagnoses, health = from_url(args.url)
        if diagnoses is None:
            return 2
        describe = f"live endpoint {args.url}"
        if health:
            describe += (f" (status {health.get('status')}, "
                         f"{health.get('n_ranks', 0)} rank(s))")
    else:
        if not os.path.exists(args.path):
            print(f"doctor: no such path: {args.path}", file=sys.stderr)
            return 2
        aggregate = load_obs_module('aggregate')
        events, snapshot, cluster, describe = gather(args.path, aggregate)
        diagnoses = doctor.diagnose(events=events, snapshot=snapshot,
                                    cluster=cluster)

    if args.as_json:
        print(json.dumps(diagnoses, sort_keys=True, indent=1, default=repr))
    else:
        print(f"doctor: examining {describe}")
        print(doctor.render_report(diagnoses))

    if args.fail_on:
        order = doctor.SEVERITY_ORDER
        tokens = [t.strip() for t in args.fail_on.split(',') if t.strip()]
        severities = [t for t in tokens if t in order]
        causes = [t for t in tokens if t not in order]
        unknown = [c for c in causes
                   if c not in doctor.DETECTORS and c != 'doctor_error']
        if unknown:
            p.error(f"--fail-on: unknown severity/cause {unknown} "
                    f"(severities: {sorted(order)}; causes: "
                    f"{sorted(doctor.DETECTORS)})")
        worst = min((order[s] for s in severities), default=None)
        for d in diagnoses:
            if worst is not None and order.get(d['severity'], 9) <= worst:
                return 1
            if d['cause'] in causes:
                return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
