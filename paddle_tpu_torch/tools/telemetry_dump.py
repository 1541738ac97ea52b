#!/usr/bin/env python
"""telemetry_dump: pretty-print a telemetry JSONL event log, or convert it
to Chrome trace-event format (loadable in Perfetto / chrome://tracing).

Counterpart of the reference's ``tools/telemetry_dump.py``.

Usage (``T=paddle_tpu_torch/tools/telemetry_dump.py``)::

    python $T <events.jsonl>                    # table
    python $T <events.jsonl> --tail 50          # last 50
    python $T <events.jsonl> --ev step          # filter kind
    python $T <events.jsonl> --chrome out.json
    python $T <events.jsonl> --serving          # serving, tenant and fleet
    python $T <events.jsonl> --costs            # cost table
    python $T --merge <run_dir>                 # cluster
    python $T --timeline <run_dir>              # sparklines
    python $T --timeline <run_dir> --series page_util

The input is what ``observability.dump_jsonl`` / ``TelemetryCallback`` write
(one JSON object per line with ``ev`` and ``ts`` keys). Conversion maps
events carrying a ``duration_ms``/``step_ms`` field to complete ("X") trace
events and everything else to instant ("i") events, timestamped relative to
the first event.

``--merge`` treats the positional argument as a SUPERVISOR RUN DIR holding
per-rank telemetry files (``telemetry_rank<R>.json`` / ``events_rank<R>.
jsonl`` / ``trace_rank<R>.json``, written by the mission-control flusher)
and — through the same aggregator the package uses — commits the merged
Chrome trace (one Perfetto lane per rank), the combined rank-stamped
JSONL, and the cluster snapshot back into the run dir (or ``--out DIR``).

Stdlib-only: loads ``paddle_tpu_torch/observability/aggregate.py`` BY PATH,
so it runs without importing torch (or the package). Importing this file
as ``paddle_tpu_torch.tools.telemetry_dump`` only defines its functions.
"""
import argparse
import importlib.util
import json
import os
import sys


def load_events(path):
    """Parse a JSONL event log; malformed lines are skipped with a count."""
    events, bad = [], 0
    with open(path, 'r', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(rec, dict):
                events.append(rec)
            else:
                bad += 1
    return events, bad


_DUR_KEYS = ('duration_ms', 'step_ms')


def to_chrome_trace(events):
    """Chrome trace-event list: durations as 'X' events, the rest instant."""
    if not events:
        return []
    t0 = min(e.get('ts', 0) for e in events)
    out = []
    for e in events:
        ts_us = (e.get('ts', t0) - t0) * 1e6
        args = {k: v for k, v in e.items() if k not in ('ev', 'ts')}
        ev = {'name': e.get('ev', '?'), 'pid': 0, 'tid': 0, 'args': args}
        dur_ms = next((e[k] for k in _DUR_KEYS if isinstance(
            e.get(k), (int, float))), None)
        if dur_ms is not None:
            # the event is stamped at completion: start the slice dur earlier
            ev.update(ph='X', ts=round(ts_us - dur_ms * 1e3, 3),
                      dur=round(dur_ms * 1e3, 3))
        else:
            ev.update(ph='i', ts=round(ts_us, 3), s='p')
        out.append(ev)
    out.sort(key=lambda e: e['ts'])
    return out


def serving_summary(events):
    """Aggregate ``serving.*`` events into one operator-facing dict: request
    count, status mix, latency/queue-wait percentiles, shed count (split by
    reason), join/leave tallies for the continuous-batching path, the
    paged-KV columns — page utilization, prefix-hit rate, draft acceptance
    (from the ``serving.kv_stats`` records the paged runner emits) — and
    the fleet-router table: per-replica dispatched / retried / hedged /
    hedge-wins / drained / circuit-state from the cumulative
    ``serving.router_stats`` records the FleetRouter emits."""
    reqs = [e for e in events if e.get('ev') == 'serving.request']
    sheds = [e for e in events if e.get('ev') == 'serving.shed']
    joins = [e for e in events if e.get('ev') == 'serving.join']
    leaves = [e for e in events if e.get('ev') == 'serving.leave']
    kv = [e for e in events if e.get('ev') == 'serving.kv_stats']
    preempts = [e for e in events if e.get('ev') == 'serving.preempt']
    exhausted = [e for e in events if e.get('ev') == 'serving.page_exhausted']
    by_status, by_model = {}, {}
    lats, queues = [], []
    for e in reqs:
        by_status[e.get('status', '?')] = \
            by_status.get(e.get('status', '?'), 0) + 1
        by_model[e.get('model', '?')] = \
            by_model.get(e.get('model', '?'), 0) + 1
        if isinstance(e.get('latency_ms'), (int, float)):
            lats.append(float(e['latency_ms']))
        if isinstance(e.get('queue_ms'), (int, float)):
            queues.append(float(e['queue_ms']))

    def pct(vals, p):
        if not vals:
            return 0.0
        vals = sorted(vals)
        k = min(len(vals) - 1,
                max(0, int(round(p / 100.0 * (len(vals) - 1)))))
        return round(vals[k], 3)

    def kv_last(key):
        # the kv_stats records carry cumulative figures: the last one wins
        for e in reversed(kv):
            if isinstance(e.get(key), (int, float)):
                return round(float(e[key]), 4)
        return None

    # fleet-router columns: serving.router_stats is cumulative per replica
    # (last one wins), same contract as kv_stats
    replicas = {}
    shed_level = None
    for e in reversed(events):
        if e.get('ev') == 'serving.router_stats':
            replicas = {str(k): v for k, v in (e.get('replicas') or {}).items()
                        if isinstance(v, dict)}
            if isinstance(e.get('shed_level'), int):
                shed_level = e['shed_level']
            break
    fleet_reqs = [e for e in events if e.get('ev') == 'serving.router.request']
    router_sheds = sum(1 for e in events
                       if e.get('ev') == 'serving.router.shed')

    # per-tenant table: the cumulative serving.tenant_stats ledger event is
    # authoritative where present (last one wins, same contract as
    # kv_stats/router_stats); tenant-stamped serving.request/serving.shed
    # events fill latency percentiles and cover bare event-log runs
    ledger = {}
    for e in reversed(events):
        if e.get('ev') == 'serving.tenant_stats' and \
                isinstance(e.get('tenants'), dict):
            ledger = {str(t): dict(row) for t, row in e['tenants'].items()
                      if isinstance(row, dict)}
            break
    t_reqs, t_lats, t_sheds = {}, {}, {}
    for e in reqs:
        ten = e.get('tenant')
        if ten is None:
            continue
        ten = str(ten)
        t_reqs[ten] = t_reqs.get(ten, 0) + 1
        if isinstance(e.get('latency_ms'), (int, float)):
            t_lats.setdefault(ten, []).append(float(e['latency_ms']))
    for e in sheds:
        ten = e.get('tenant')
        if ten is None:
            continue
        ten = str(ten)
        reason = str(e.get('reason', '?'))
        t_sheds.setdefault(ten, {})[reason] = \
            t_sheds.get(ten, {}).get(reason, 0) + 1
    tenants = {}
    for ten in sorted(set(ledger) | set(t_reqs) | set(t_sheds)):
        row = ledger.get(ten, {})
        shed_by_reason = row.get('shed') if isinstance(row.get('shed'),
                                                       dict) \
            else t_sheds.get(ten, {})
        tenants[ten] = {
            'requests': int(row.get('requests', t_reqs.get(ten, 0))),
            'violations': int(row.get('violations', 0)),
            'shed': {str(k): int(v)
                     for k, v in (shed_by_reason or {}).items()},
            'p50_latency_ms': pct(t_lats.get(ten, []), 50),
            'p99_latency_ms': pct(t_lats.get(ten, []), 99),
            'burn': row.get('burn'),
        }
    # one implicit default-tenant row with nothing shed is just the
    # single-tenant engine talking about itself — not a tenant table
    if set(tenants) == {'default'} and \
            not tenants['default']['shed'] and \
            not tenants['default']['violations']:
        tenants = {}

    return {
        'requests': len(reqs),
        'by_status': by_status,
        'by_model': by_model,
        'shed': len(sheds),
        'shed_page_exhaustion': sum(
            1 for e in sheds if e.get('reason') == 'page_exhaustion'),
        'joins': len(joins),
        'leaves': len(leaves),
        'p50_latency_ms': pct(lats, 50),
        'p99_latency_ms': pct(lats, 99),
        'p50_queue_ms': pct(queues, 50),
        'p99_queue_ms': pct(queues, 99),
        'page_utilization': kv_last('page_utilization'),
        'prefix_hit_rate': kv_last('prefix_hit_rate'),
        'draft_acceptance': kv_last('draft_acceptance'),
        'preemptions': len(preempts),
        'page_exhausted_events': len(exhausted),
        'fleet_replicas': replicas,
        'fleet_requests': len(fleet_reqs),
        'fleet_shed': router_sheds,
        'fleet_shed_level': shed_level,
        'tenants': tenants,
    }


def render_serving(summary):
    shed_note = f"{summary['shed']} shed"
    if summary.get('shed_page_exhaustion'):
        shed_note += (f" ({summary['shed_page_exhaustion']} from page "
                      "exhaustion)")
    lines = [f"serving: {summary['requests']} request(s), {shed_note}"]
    if summary['by_model']:
        lines.append("  by model: " + ', '.join(
            f"{k}: {v}" for k, v in sorted(summary['by_model'].items())))
    if summary['by_status']:
        lines.append("  by status: " + ', '.join(
            f"{k}: {v}" for k, v in sorted(summary['by_status'].items())))
    lines.append(f"  latency p50/p99: {summary['p50_latency_ms']}/"
                 f"{summary['p99_latency_ms']} ms, queue p50/p99: "
                 f"{summary['p50_queue_ms']}/{summary['p99_queue_ms']} ms")
    if summary['joins'] or summary['leaves']:
        lines.append(f"  continuous batching: {summary['joins']} join(s), "
                     f"{summary['leaves']} leave(s)")
    kv_bits = []
    if summary.get('page_utilization') is not None:
        kv_bits.append(f"page util {summary['page_utilization']}")
    if summary.get('prefix_hit_rate') is not None:
        kv_bits.append(f"prefix hit rate {summary['prefix_hit_rate']}")
    if summary.get('draft_acceptance') is not None:
        kv_bits.append(f"draft acceptance {summary['draft_acceptance']}")
    if summary.get('preemptions'):
        kv_bits.append(f"{summary['preemptions']} preemption(s)")
    if summary.get('page_exhausted_events'):
        kv_bits.append(
            f"{summary['page_exhausted_events']} page-exhausted stall(s)")
    if kv_bits:
        lines.append("  paged kv: " + ', '.join(kv_bits))
    reps = summary.get('fleet_replicas') or {}
    if reps:
        head = (f"  fleet: {summary.get('fleet_requests', 0)} routed "
                f"request(s), {summary.get('fleet_shed', 0)} shed by the "
                "ladder")
        if summary.get('fleet_shed_level'):
            head += f" (shed level {summary['fleet_shed_level']})"
        lines.append(head)
        width = max([len('replica')] + [len(n) for n in reps])
        lines.append(
            f"    {'replica':<{width}} {'dispatched':>10} {'retried':>8} "
            f"{'hedged':>7} {'hedge-wins':>10} {'drained':>8} "
            f"{'deaths':>7} {'circuit':>9}")
        for name in sorted(reps):
            r = reps[name]
            lines.append(
                f"    {name:<{width}} {int(r.get('dispatched', 0)):>10} "
                f"{int(r.get('retried', 0)):>8} "
                f"{int(r.get('hedged', 0)):>7} "
                f"{int(r.get('hedge_wins', 0)):>10} "
                f"{int(r.get('drained', 0)):>8} "
                f"{int(r.get('deaths', 0)):>7} "
                f"{str(r.get('circuit', '?')):>9}")
    tenants = summary.get('tenants') or {}
    if tenants:
        lines.append(f"  tenants: {len(tenants)}")
        width = max([len('tenant')] + [len(t) for t in tenants])
        lines.append(
            f"    {'tenant':<{width}} {'requests':>8} {'shed':>16} "
            f"{'p50 ms':>8} {'p99 ms':>8} {'burn':>6}")
        for name in sorted(tenants):
            t = tenants[name]
            shed = ', '.join(f"{k}: {v}"
                             for k, v in sorted(t['shed'].items())) or '-'
            burn = ('-' if t.get('burn') is None
                    else f"{float(t['burn']):.2f}")
            lines.append(
                f"    {name:<{width}} {t['requests']:>8} {shed:>16} "
                f"{t['p50_latency_ms']:>8} {t['p99_latency_ms']:>8} "
                f"{burn:>6}")
    return '\n'.join(lines)


def costs_table(events):
    """Rows for the cost-explorer table from ``cost.program`` events (one
    per captured program; the last record per program wins)."""
    rows = {}
    for e in events:
        if e.get('ev') != 'cost.program':
            continue
        rows[str(e.get('program', '?'))] = e
    out = []
    for name in sorted(rows, key=lambda n: -float(
            rows[n].get('flops', 0) or 0)):
        e = rows[name]
        out.append({
            'program': name,
            'kind': e.get('program_kind', '?'),
            'flops': float(e.get('flops', 0) or 0),
            'bytes_accessed': float(e.get('bytes_accessed', 0) or 0),
            'peak_bytes': float(e.get('peak_bytes', 0) or 0),
            'ai': float(e.get('arithmetic_intensity', 0) or 0),
            'bound': e.get('bound', '?'),
            'est_ms': float(e.get('est_ms', 0) or 0),
        })
    return out


def render_costs(rows):
    """Aligned cost-explorer table (flops-descending)."""
    if not rows:
        return ('(no cost.program events — enable telemetry and run the '
                'programs once so the cost ledger captures them)')
    width = max([len('program')] + [len(r['program']) for r in rows])
    lines = [f"{'program':<{width}}  {'kind':<16} {'MFLOP':>10} "
             f"{'MB acc':>9} {'MB peak':>9} {'AI':>7} {'bound':>7} "
             f"{'est ms':>9}"]
    for r in rows:
        lines.append(
            f"{r['program']:<{width}}  {r['kind']:<16} "
            f"{r['flops'] / 1e6:>10.3f} "
            f"{r['bytes_accessed'] / 1e6:>9.3f} "
            f"{r['peak_bytes'] / 1e6:>9.3f} {r['ai']:>7.2f} "
            f"{r['bound']:>7} {r['est_ms']:>9.4f}")
    total_flops = sum(r['flops'] for r in rows)
    peak = max(rows, key=lambda r: r['peak_bytes'])
    lines.append(f"-- {len(rows)} program(s), {total_flops / 1e6:.2f} "
                 f"MFLOP total, peak memory {peak['peak_bytes'] / 1e6:.3f} "
                 f"MB ({peak['program']})")
    return '\n'.join(lines)


_SPARK = '▁▂▃▄▅▆▇█'


def _sparkline(values):
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


def render_timeline(merged, needle=None, width=64):
    """ASCII sparklines for a ``merged_timeseries`` document: one line per
    (series, rank), min..max annotated — the terminal version of the
    trend evidence the doctor's page_leak/latency_creep/qps_collapse/
    compile_creep detectors consume."""
    series = (merged or {}).get('series') or {}
    if needle:
        series = {k: v for k, v in series.items() if needle in k}
    if not series:
        return ('(no time-series samples — sampler off, or filter '
                'matched nothing)')
    per_rank = (merged or {}).get('per_rank') or {}
    head = ', '.join(
        f"rank {r}: {row.get('n_samples', 0)} sample(s)/"
        f"{row.get('span_s', 0)}s"
        for r, row in sorted(per_rank.items(), key=lambda kv: str(kv[0])))
    lines = [f"timeline: {len(series)} series "
             f"(cadence {merged.get('sample_every')}s; {head})"]
    name_w = min(max(len(k) for k in series), 44)
    for name in sorted(series):
        for rank, tl in sorted(series[name].items(),
                               key=lambda kv: str(kv[0])):
            vals = [p[1] for p in tl
                    if isinstance(p, (list, tuple)) and len(p) == 2
                    and isinstance(p[1], (int, float))]
            if not vals:
                continue
            spark = _sparkline(vals[-width:])
            lines.append(f"{name:<{name_w}} r{rank} "
                         f"[{min(vals):>10.3f} .. {max(vals):>10.3f}] "
                         f"{spark}")
    return '\n'.join(lines)


def _load_aggregate():
    """Load the mission-control aggregator BY PATH (the module is written
    to be standalone) so this tool keeps its no-torch contract."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, 'observability', 'aggregate.py')
    spec = importlib.util.spec_from_file_location('_mc_aggregate', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge_run_dir(run_dir, out_dir=None):
    """Merge a run dir's per-rank telemetry (the shared aggregator code
    path). Returns (paths, cluster_snapshot) or (None, None)."""
    aggregate = _load_aggregate()
    paths = aggregate.write_merged(run_dir, out_dir=out_dir)
    if paths is None:
        return None, None
    # the snapshot was just committed — read it back rather than re-listing
    # and re-parsing every per-rank file a second time
    with open(paths['snapshot'], encoding='utf-8') as f:
        return paths, json.load(f)


def render_table(events, limit=None):
    """Aligned human listing: relative time, kind, then the fields."""
    if not events:
        return '(no events)'
    t0 = min(e.get('ts', 0) for e in events)
    shown = events[-limit:] if limit else events
    kw = max(len(e.get('ev', '?')) for e in shown)
    lines = []
    for e in shown:
        rel = e.get('ts', t0) - t0
        fields = ' '.join(f"{k}={_short(v)}" for k, v in sorted(e.items())
                          if k not in ('ev', 'ts'))
        lines.append(f"{rel:>10.3f}s  {e.get('ev', '?'):<{kw}}  {fields}")
    if limit and len(events) > limit:
        lines.insert(0, f"... ({len(events) - limit} earlier event(s))")
    return '\n'.join(lines)


def _short(v, n=60):
    s = json.dumps(v, sort_keys=True) if isinstance(v, (dict, list)) \
        else str(v)
    return s if len(s) <= n else s[:n - 3] + '...'


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='telemetry_dump',
        description='pretty-print / convert a paddle_tpu_torch telemetry '
                    'JSONL event log')
    p.add_argument('log', help='events.jsonl written by TelemetryCallback / '
                               'observability.dump_jsonl (with --merge: a '
                               'supervisor run dir of per-rank files)')
    p.add_argument('--merge', action='store_true',
                   help='treat the positional argument as a run dir of '
                        'per-rank telemetry files; write the merged Chrome '
                        'trace (one lane per rank), combined JSONL, and '
                        'cluster snapshot')
    p.add_argument('--out', metavar='DIR', default=None,
                   help='with --merge: where the merged artifacts land '
                        '(default: the run dir itself)')
    p.add_argument('--chrome', metavar='OUT',
                   help='write Chrome trace-event JSON to OUT instead of '
                        'printing a table')
    p.add_argument('--ev', default=None,
                   help='only events of this kind (e.g. step, retry.attempt)')
    p.add_argument('--tail', type=int, default=None,
                   help='show only the last N events')
    p.add_argument('--serving', action='store_true',
                   help='summarize serving.* events (request counts by '
                        'status/model, latency + queue percentiles, shed '
                        'and join/leave tallies, per-tenant requests/'
                        'shed-by-reason/p50/p99/burn) instead of the table')
    p.add_argument('--costs', action='store_true',
                   help='tabulate cost.program events (the cost explorer: '
                        'per-program FLOPs, bytes accessed, peak memory, '
                        'arithmetic intensity, roofline bound + estimate)')
    p.add_argument('--timeline', action='store_true',
                   help='treat the positional argument as a run dir of '
                        'timeseries_rank<R>.json ring-sampler exports and '
                        'render per-series ASCII sparklines (one line per '
                        'series and rank)')
    p.add_argument('--series', default=None, metavar='SUBSTR',
                   help='with --timeline: only series whose name contains '
                        'SUBSTR (e.g. page_utilization, kernels.builds)')
    args = p.parse_args(argv)

    if args.timeline:
        if not os.path.isdir(args.log):
            print(f"telemetry_dump: --timeline expects a run dir, not "
                  f"{args.log!r}", file=sys.stderr)
            return 2
        aggregate = _load_aggregate()
        merged = aggregate.merged_timeseries(args.log)
        print(render_timeline(merged, needle=args.series))
        return 0 if merged.get('series') else 2

    if args.merge:
        if not os.path.isdir(args.log):
            print(f"telemetry_dump: --merge expects a run dir, not "
                  f"{args.log!r}", file=sys.stderr)
            return 2
        paths, snap = merge_run_dir(args.log, out_dir=args.out)
        if paths is None:
            print(f"telemetry_dump: no per-rank telemetry files "
                  f"(telemetry_rank<R>.json) in {args.log}",
                  file=sys.stderr)
            return 2
        print(f"merged {paths.pop('n_ranks')} rank(s) "
              f"(step skew {snap['step_ms_skew']}x):")
        for kind in ('trace', 'events', 'snapshot'):
            print(f"  {kind:8s} -> {paths[kind]}")
        flights = snap.get('flight_dumps') or {}
        for rank, row in sorted(flights.items()):
            note = row.get('reason')
            exc = row.get('exception') or {}
            if exc.get('type'):
                note += f" ({exc['type']}: {exc.get('message')})"
            print(f"  flight   rank {rank}: {note} -> {row.get('path')}")
        return 0

    try:
        events, bad = load_events(args.log)
    except OSError as e:
        print(f"telemetry_dump: cannot read {args.log}: {e}",
              file=sys.stderr)
        return 2
    if bad:
        print(f"telemetry_dump: skipped {bad} malformed line(s)",
              file=sys.stderr)
    if args.ev:
        events = [e for e in events if e.get('ev') == args.ev]

    if args.serving:
        print(render_serving(serving_summary(events)))
        return 0

    if args.costs:
        print(render_costs(costs_table(events)))
        return 0

    if args.chrome:
        trace = to_chrome_trace(events)
        with open(args.chrome, 'w', encoding='utf-8') as f:
            json.dump(trace, f)
        print(f"wrote {len(trace)} trace event(s) to {args.chrome}")
        return 0

    print(render_table(events, limit=args.tail))
    counts = {}
    for e in events:
        counts[e.get('ev', '?')] = counts.get(e.get('ev', '?'), 0) + 1
    tally = ', '.join(f"{k}: {v}" for k, v in sorted(counts.items()))
    print(f"-- {len(events)} event(s){' (' + tally + ')' if tally else ''}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
