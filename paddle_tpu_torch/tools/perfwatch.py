#!/usr/bin/env python
"""perfwatch: cross-run performance sentinel over the ``runs.jsonl``
registry. Counterpart of the reference's ``tools/perfwatch.py``.

``observability.baseline.record_run`` appends one summary record per run
(counter totals, cost headline, kernel builds, config fingerprint); this
CLI compares the latest record against the rolling median + MAD of the prior
runs — robust, min-sample-guarded, direction-aware (qps down = bad,
latency/stall up = bad).

Usage::

    python paddle_tpu_torch/tools/perfwatch.py compare   # default registry
    python paddle_tpu_torch/tools/perfwatch.py compare --runs runs.jsonl
    python paddle_tpu_torch/tools/perfwatch.py compare --json
    python paddle_tpu_torch/tools/perfwatch.py compare --fail-on regression
                                                  # CI gate: exit 1 on any
                                                  # regression
    python paddle_tpu_torch/tools/perfwatch.py history --metric M  # one
    python paddle_tpu_torch/tools/perfwatch.py history   # list metrics

Stdlib-only: loads ``paddle_tpu_torch/observability/baseline.py`` BY PATH
(like ``doctor.py`` here), so it runs without importing torch (or the
package). Importing this file as ``paddle_tpu_torch.tools.perfwatch`` only
defines its functions.
"""
import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_OBS_DIR = os.path.join(os.path.dirname(_HERE), 'observability')

_SPARK = '▁▂▃▄▅▆▇█'


def load_baseline():
    path = os.path.join(_OBS_DIR, 'baseline.py')
    spec = importlib.util.spec_from_file_location('_pw_baseline', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sparkline(values):
    """One-line ASCII sketch of a value series."""
    vals = [v for v in values if isinstance(v, (int, float))]
    if not vals:
        return ''
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return ''.join(
        _SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)),
                   len(_SPARK) - 1)] for v in vals)


def cmd_compare(args, baseline):
    runs = baseline.load_runs(args.runs)
    verdict = baseline.compare(
        runs, min_samples=args.min_samples, mad_k=args.mad_k,
        rel_threshold=args.rel_threshold)
    regs = verdict['regressions']
    if args.as_json:
        print(json.dumps(verdict, sort_keys=True, indent=1, default=repr))
    elif not runs:
        print(f"perfwatch: no runs in {args.runs or '(default registry)'}")
    else:
        last = verdict['last'] or {}
        print(f"perfwatch: {len(runs)} run(s), latest "
              f"'{last.get('run', '?')}' "
              f"fingerprint={last.get('fingerprint', '?')}")
        if len(runs) <= args.min_samples:
            print(f"perfwatch: only {len(runs) - 1} prior run(s) — "
                  f"min-sample guard ({args.min_samples}) keeps every "
                  "verdict quiet until the baseline is deep enough")
        elif not regs:
            print("perfwatch: no regressions — latest run is within the "
                  "rolling median + MAD envelope of its baseline")
        for r in regs:
            print(f"  REGRESSION {r['metric']}: {r['value']:g} vs median "
                  f"{r['median']:g} ({r['direction']} "
                  f"{100 * abs(r['rel_change']):.0f}%, mad {r['mad']:g}, "
                  f"n={r['n_baseline']})")
    if args.fail_on == 'regression' and regs:
        return 1
    return 0


def cmd_history(args, baseline):
    runs = baseline.load_runs(args.runs)
    if not runs:
        print(f"perfwatch: no runs in {args.runs or '(default registry)'}")
        return 0 if args.metric is None else 2
    if args.metric is None:
        names = sorted({n for r in runs for n in baseline.flatten(r)})
        if args.as_json:
            print(json.dumps(names, indent=1))
        else:
            print(f"perfwatch: {len(runs)} run(s), "
                  f"{len(names)} metric(s):")
            for n in names:
                print(f"  {n}")
        return 0
    tl = baseline.history(runs, args.metric)
    if args.as_json:
        print(json.dumps({'metric': args.metric, 'history': tl}, indent=1))
        return 0
    if not tl:
        print(f"perfwatch: metric {args.metric!r} appears in no run")
        return 2
    vals = [v for _ts, v in tl]
    print(f"{args.metric}  ({len(vals)} run(s), min {min(vals):g}, "
          f"max {max(vals):g})")
    print(f"  {sparkline(vals)}")
    print('  ' + ' '.join(f"{v:g}" for v in vals))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='perfwatch',
        description='cross-run perf regression sentinel over runs.jsonl')
    p.add_argument('command', choices=['compare', 'history'],
                   help='compare: latest run vs rolling baseline; '
                        'history: one metric across every run')
    p.add_argument('--runs', default=None, metavar='PATH',
                   help='registry path (default: PADDLE_TPU_RUNS_REGISTRY '
                        'or runs.jsonl under the telemetry dir)')
    p.add_argument('--metric', default=None,
                   help='history: the metric to plot (omit to list)')
    p.add_argument('--json', action='store_true', dest='as_json',
                   help='machine-readable output')
    p.add_argument('--fail-on', default=None, choices=['regression'],
                   help='compare: exit 1 when any metric regressed '
                        '(CI gate mode)')
    p.add_argument('--min-samples', type=int, default=4,
                   help='prior runs required before verdicts (default 4)')
    p.add_argument('--mad-k', type=float, default=4.0,
                   help='robust-sigma threshold (default 4.0)')
    p.add_argument('--rel-threshold', type=float, default=0.2,
                   help='relative-change threshold (default 0.2)')
    args = p.parse_args(argv)
    baseline = load_baseline()
    if args.command == 'compare':
        return cmd_compare(args, baseline)
    return cmd_history(args, baseline)


if __name__ == '__main__':
    sys.exit(main())
