#!/usr/bin/env python
"""postmortem: render a flight-recorder crash dump and diagnose it.

Counterpart of the reference's ``tools/postmortem.py``.

Usage::

    python paddle_tpu_torch/tools/postmortem.py <flight_rank0.json>  # one
    python paddle_tpu_torch/tools/postmortem.py <run_dir>   # every dump
    python paddle_tpu_torch/tools/postmortem.py <dump> --json
    python paddle_tpu_torch/tools/postmortem.py <dump> --tail 20
    python paddle_tpu_torch/tools/postmortem.py <dump> --fail-on warning

A flight dump is the black box ``paddle_tpu_torch.observability.flight``
commits
atomically when a process dies an abnormal death (NaN-abort, rank failure,
watchdog timeout, SIGTERM, unhandled worker exception): the reason, the
exception traceback, the last seconds of events from the always-on ring
buffer, a metrics snapshot, the interposed-counter summary, and the cost
ledger. This tool renders all of that for an operator and runs the anomaly
doctor over the dump's own evidence (ring records double as the event
stream, the embedded snapshot as the metrics), so the post-mortem names a
probable cause — not just a stack trace.

Stdlib-only: loads ``paddle_tpu_torch/observability/doctor.py`` BY PATH,
so it runs without importing torch (or the package). Importing this file
as ``paddle_tpu_torch.tools.postmortem`` only defines its functions.
"""
import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_OBS_DIR = os.path.join(os.path.dirname(_HERE), 'observability')


def load_obs_module(name):
    path = os.path.join(_OBS_DIR, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'_pm_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_dump(path):
    """Parse one flight dump; (doc, error-string)."""
    try:
        with open(path, 'r', encoding='utf-8') as f:
            doc = json.load(f)
    except OSError as e:
        return None, f"cannot read {path}: {e}"
    except ValueError as e:
        return None, (f"{path} does not parse as JSON ({e}) — flight dumps "
                      "are committed atomically, so this is not a torn "
                      "write; the file was truncated or edited after the "
                      "fact")
    if not isinstance(doc, dict) or 'reason' not in doc:
        return None, f"{path} is not a flight dump (no 'reason' field)"
    return doc, None


def find_dumps(path):
    """Dump paths for a file or a run dir of flight dumps: the per-rank
    black boxes (``flight_rank<R>.json``), the watchdog's rate-limited
    side files (``flight_rank<R>_watchdog.json``), and the supervisor's
    own record (``flight_supervisor.json``)."""
    if os.path.isfile(path):
        return [path]
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return []
    return [os.path.join(path, n) for n in names
            if n.startswith('flight_') and n.endswith('.json')]


def diagnose_dump(doc, doctor):
    """Run the anomaly doctor over the dump's own evidence."""
    records = [r for r in doc.get('records') or [] if isinstance(r, dict)]
    try:
        return doctor.diagnose(events=records, snapshot=doc.get('metrics'))
    except Exception as e:
        return [{'cause': 'doctor_error', 'severity': 'info',
                 'detail': f'doctor failed over this dump: {e!r}',
                 'fix': 'report this as a paddle_tpu_torch bug',
                 'evidence': {}}]


def _fmt_counters(counters, keys):
    parts = []
    for k in keys:
        v = (counters or {}).get(k)
        if v:
            parts.append(f"{k}={v}")
    return ', '.join(parts) or '(none)'


def render(doc, diagnoses, tail=None):
    lines = []
    head = (f"flight dump: reason={doc.get('reason')!r} rank="
            f"{doc.get('rank')} pid={doc.get('pid')} host="
            f"{doc.get('host')}")
    if doc.get('dumps_before'):
        head += f" (dump #{doc['dumps_before'] + 1} of this process)"
    lines.append(head)
    if not doc.get('telemetry_enabled', True):
        lines.append("  telemetry was OFF — the ring below is the "
                     "always-on flight surface only")
    exc = doc.get('exception')
    if isinstance(exc, dict):
        lines.append(f"exception: {exc.get('type')}: {exc.get('message')}")
        tb = (exc.get('traceback') or '').rstrip()
        if tb:
            lines.append('  ' + tb.replace('\n', '\n  '))
    extra = doc.get('extra')
    if isinstance(extra, dict) and extra:
        lines.append("context: " + ', '.join(
            f"{k}={v}" for k, v in sorted(extra.items())))
    counters = doc.get('counters') or {}
    lines.append("headline counters: " + _fmt_counters(counters, (
        'kernel_builds', 'host_transfer_bytes', 'worker_restarts',
        'quarantined_samples', 'dist_timeouts', 'rank_failures',
        'serving_requests', 'serving_shed', 'slo_violations',
        'cost_programs')))
    costs = doc.get('costs') or {}
    if costs.get('programs'):
        lines.append(
            f"cost ledger: {costs['programs']} program(s), peak "
            f"{costs.get('max_peak_bytes', 0) / 1e6:.1f} MB in "
            f"{costs.get('max_peak_program')!r}")
    records = [r for r in doc.get('records') or [] if isinstance(r, dict)]
    shown = records[-tail:] if tail else records
    lines.append(f"last {len(shown)} of {len(records)} ring record(s):")
    t0 = min((r.get('ts', 0) for r in records), default=0)
    for r in shown:
        rel = (r.get('ts', t0) or t0) - t0
        fields = ' '.join(f"{k}={_short(v)}" for k, v in sorted(r.items())
                          if k not in ('ev', 'ts'))
        lines.append(f"  {rel:>9.3f}s  {r.get('ev', '?'):<24} {fields}")
    lines.append('')
    if diagnoses:
        lines.append(f"doctor: {len(diagnoses)} finding(s), most severe "
                     "first")
        for i, d in enumerate(diagnoses, 1):
            lines.append(f"{i}. [{d['severity'].upper():8s}] {d['cause']}: "
                         f"{d['detail']}")
            lines.append(f"   fix: {d['fix']}")
    else:
        lines.append("doctor: no anomalies detected in the dump — read the "
                     "ring records above for the sequence of events")
    return '\n'.join(lines)


def _short(v, n=60):
    s = json.dumps(v, sort_keys=True) if isinstance(v, (dict, list)) \
        else str(v)
    return s if len(s) <= n else s[:n - 3] + '...'


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='postmortem',
        description='render + diagnose a paddle_tpu_torch '
                    'flight-recorder crash dump')
    p.add_argument('path', help='a flight_rank<R>.json dump, or a run dir '
                                'containing per-rank dumps')
    p.add_argument('--json', action='store_true', dest='as_json',
                   help='print {dump, diagnoses} as JSON')
    p.add_argument('--tail', type=int, default=None,
                   help='show only the last N ring records')
    p.add_argument('--fail-on', choices=('critical', 'warning', 'info'),
                   default=None,
                   help='exit 1 when any doctor finding at (or above) this '
                        'severity exists — CI gate mode')
    args = p.parse_args(argv)

    paths = find_dumps(args.path)
    if not paths:
        print(f"postmortem: no flight dump at {args.path!r} (expected a "
              "flight_rank<R>.json file or a run dir holding some)",
              file=sys.stderr)
        return 2
    doctor = load_obs_module('doctor')
    worst = None
    out_json = []
    loaded = 0
    for path in paths:
        doc, err = load_dump(path)
        if doc is None:
            print(f"postmortem: {err}", file=sys.stderr)
            continue
        loaded += 1
        diagnoses = diagnose_dump(doc, doctor)
        for d in diagnoses:
            sev = doctor.SEVERITY_ORDER.get(d['severity'], 9)
            worst = sev if worst is None else min(worst, sev)
        if args.as_json:
            out_json.append({'path': path, 'dump': doc,
                             'diagnoses': diagnoses})
        else:
            if len(paths) > 1:
                print(f"== {path} ==")
            print(render(doc, diagnoses, tail=args.tail))
    if args.as_json:
        print(json.dumps(out_json if len(out_json) != 1 else out_json[0],
                         sort_keys=True, indent=1, default=repr))
    if not loaded:
        return 2
    if args.fail_on is not None and worst is not None and \
            worst <= doctor.SEVERITY_ORDER[args.fail_on]:
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
