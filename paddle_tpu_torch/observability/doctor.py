"""Anomaly doctor: streaming detectors over the telemetry spine.
The port's own copy of ``paddle_tpu/observability/doctor.py``: the same
detectors, thresholds, causes, severities and evidence. A name changes
only where the reference's names JAX: its ``jax.compiles`` counter is
``kernels.builds`` here (``interpose``), the cluster row's
``jax_compiles`` is ``kernel_builds``; the fix-it texts name the port's
knobs and no tool the port does not have.

Turns the raw counters/events mission control collects into a NAMED cause
and a fix-it hint. Each detector inspects the merged event stream and/or a
metrics snapshot (single-process or the aggregator's cluster snapshot) and
yields ``Diagnosis`` dicts::

    {'cause': 'straggler', 'severity': 'critical',
     'detail': 'rank 3 mean step 48.1ms vs cluster median 9.7ms (5.0x)',
     'fix': '...', 'evidence': {...}}

Detector catalog (docs/OBSERVABILITY.md has the operator version):

- ``straggler``       per-rank step-time skew in the cluster snapshot —
                      one rank's mean step time >= ``skew_threshold`` x
                      the cluster median (a thermally throttled or
                      mis-scheduled card, a slow host).
- ``retrace_storm``   ``kernels.builds`` still growing after the warmup
                      steps (in the reference, XLA compiles: the
                      dynamic-shape and unhashable-capture traps; here
                      each build is an nvcc run over the kernel sources,
                      at most one a process unless they change).
- ``input_bound``     dataloader wait dominates step time — the
                      accelerator starves on host feed.
- ``serving_overload`` shed + deadline-expired requests trending up on the
                      serving event stream / counters — offered load
                      exceeds engine capacity. Page-exhaustion sheds are
                      EXCLUDED (that is memory pressure, not traffic —
                      see ``kv_page_exhaustion``).
- ``kv_page_exhaustion`` the paged KV cache ran out of pages: admission
                      blocked, decode rows stalled, sequences preempted,
                      or queue-full sheds attributed to page starvation.
                      The fix is memory-side (num_pages / page_size /
                      prefix_cache), never replicas or queue capacity.
- ``rank_flatline``   a rank's heartbeat is stale while siblings beat on
                      (wedged collective / dead process).
- ``memory_pressure`` the cost ledger's worst per-program ``peak_bytes``
                      approaches (>= 80%) or exceeds the device memory
                      budget (``PADDLE_TPU_HBM_BUDGET`` or the device's
                      reported limit) — the next bigger batch/sequence
                      OOMs. The fix is memory-side: microbatch, remat,
                      FSDP sharding.
- ``slo_burn``        a served model is burning its latency error budget
                      faster than its objective allows (the SLO tracker's
                      ``burn_rate``; warning at 1x, critical at 5x).
- ``checkpoint_stall`` synchronous checkpoint saves block the training
                      thread for >= 25% of the mean step time — the fix-it
                      is the async save path (``async_=True``), which
                      moves snapshot+commit off the step path.
- ``elastic_downsize`` the world size shrank mid-run: a rank died and the
                      elastic supervisor resumed on the survivors (info —
                      the run survived, but capacity is reduced; names
                      the dead rank from the supervisor's heartbeats).
- ``replica_flapping`` a serving replica's circuit breaker opened >=
                      ``flap_opens`` times this window — the half-open
                      gate keeps re-admitting a replica that is not
                      better (cold rejoin without warmup, flaky host);
                      the fix-it names the replica and the half-open
                      warmup knobs.
- ``retry_storm``     router failover retries >= 20% of offered load —
                      retry amplification melting the surviving
                      replicas; fix the failing replica, then bound
                      max_retries / hedging and let the shed ladder
                      engage first.
- ``noisy_neighbor``  one tenant owns >= ``noisy_share`` of the serving
                      pressure (quota/capacity sheds + SLO violations)
                      while other tenants share the same fleet — the
                      multi-tenant fairness failure per-tenant quotas
                      exist for. Reads the ``serving.tenant.*`` labeled
                      counters (snapshot) or tenant-stamped
                      ``serving.shed`` / ``serving.request`` events; the
                      fix-it names the tenant and its ``TenantPolicy``
                      rate/burst/weight knobs. Quiet with one tenant or a
                      healthy (shed-free) fleet.
- ``autoscale_flap``  the fleet autoscaler (or whatever is driving
                      replica count) reversed direction grow<->shrink
                      within a few cooldown windows, repeatedly — the
                      oscillation the hysteresis band + cooldown are
                      meant to make impossible; firing means a degenerate
                      band, cooldown 0, or two controllers fighting.
- ``cold_compile_storm`` a persistent compile cache is bound yet the boot
                      is compiling anyway: cached executables rejected at
                      load (CRC mismatch / version skew —
                      ``compilecache.incompat`` climbing), or the hit
                      rate collapsed against a populated dir (wrong dir /
                      stale program set). The fix-it names the
                      ``PADDLE_TPU_COMPILE_CACHE`` knob. Quiet when no
                      cache is bound or on the first populate pass (the
                      port's persistent cache comes with ``compilecache/``,
                      ROADMAP.md Queue 1 item 7: until then, always).
- ``lint_debt``       the tree's justified graftlint waivers (inline
                      ``graftlint: disable`` + ``[[graftlint.waiver]]``
                      blocks) outgrew the ``lint_debt_threshold`` budget
                      recorded in graftlint.toml (info — the lint gate
                      still passes; this flags the creeping debt).

Trend detectors (need the ring sampler's timelines — ``timeseries`` in the
cluster snapshot, via ``aggregate.merged_timeseries``; quiet without them):

- ``page_leak``       KV page utilization grows monotonically while
                      occupancy (active slots) stays flat — pages are
                      allocated and never freed; a point snapshot shows
                      "high utilization", only the timeline shows it never
                      coming back down.
- ``latency_creep``   request p99 rises steadily over the run (last third
                      vs first third) — degradation too slow for any
                      single snapshot to flag.
- ``qps_collapse``    throughput cliff: the trailing window's per-sample
                      request rate collapsed vs the run median. The dense
                      counter timelines make the cliff visible — a stall
                      IS the run of flat cumulative points.
- ``compile_creep``   ``kernels.builds`` starts growing again after the
                      warmup plateau — the time-resolved upgrade of
                      ``retrace_storm`` (which needs compiles/steps to
                      already look bad in aggregate; this fires on the
                      inflection).
- ``perf_regression`` the latest run in the cross-run registry
                      (``runs.jsonl``, see ``baseline.py``) regressed vs
                      the rolling
                      median + MAD of prior runs, direction-aware (qps
                      down = bad, latency/stall up = bad).

Ranked output: ``critical`` > ``warning`` > ``info``. Standalone on
purpose — stdlib-only, importable by path — so a run dir can be
diagnosed with no torch installed. When imported as part of the package,
``run_doctor(..., emit=True)`` also lands each diagnosis as a structured
``diagnosis`` event on the step-event log.
"""

__all__ = ['diagnose', 'run_doctor', 'render_report', 'DETECTORS',
           'SEVERITY_ORDER']

SEVERITY_ORDER = {'critical': 0, 'warning': 1, 'info': 2}

# tunables (detectors take overrides via **cfg)
SKEW_THRESHOLD = 1.75          # rank mean step vs cluster median
WARMUP_STEPS = 5               # compiles inside warmup are expected
RETRACE_GRACE = 3              # compiles beyond warmup that are tolerated
INPUT_BOUND_RATIO = 0.5        # dataloader wait / step time
OVERLOAD_RATIO = 0.05          # (shed + expired) / offered
STALE_HEARTBEAT_S = 10.0
MEMORY_PRESSURE_RATIO = 0.8    # worst program peak_bytes / memory budget
SLO_BURN_WARNING = 1.0         # error-budget burn rate thresholds
SLO_BURN_CRITICAL = 5.0
CHECKPOINT_STALL_RATIO = 0.25  # mean save stall / mean step time
FLAP_OPENS = 4                 # circuit opens per window = flapping
RETRY_STORM_RATIO = 0.2        # router retries / offered requests
RETRY_STORM_MIN = 10           # offered requests before the ratio counts
# trend-detector tunables (need the ring sampler's timelines)
PAGE_LEAK_MIN_SAMPLES = 5      # utilization points before a leak can fire
PAGE_LEAK_GROWTH = 0.1         # absolute utilization growth start -> end
PAGE_LEAK_OCCUPANCY_RANGE = 0.25   # active-slots rel. range still "stable"
PAGE_LEAK_CRITICAL_UTIL = 0.9  # last utilization point => critical
LATENCY_CREEP_MIN_SAMPLES = 6
LATENCY_CREEP_RATIO = 1.5      # last-third mean p99 / first-third mean
QPS_COLLAPSE_MIN_SAMPLES = 6
QPS_COLLAPSE_RATIO = 0.3       # trailing-window rate / run median rate
QPS_COLLAPSE_WINDOW = 3        # samples in the trailing window
COMPILE_CREEP_PLATEAU = 3      # consecutive zero-delta samples = warmed up
COMPILE_CREEP_GRACE = 3        # post-plateau compiles tolerated
COLD_STORM_COMPILES = 5        # boot compiles despite a populated cache
COLD_STORM_HIT_RATE = 0.5      # persistent-tier hit rate below = storm
COLD_STORM_INCOMPAT = 1        # rejected cache entries tolerated - 1
NOISY_SHARE = 0.6              # one tenant's share of sheds + violations
NOISY_MIN_PRESSURE = 5         # sheds + violations before a share counts
FLAP_REVERSALS = 2             # grow<->shrink direction flips = flapping
FLAP_WINDOW_COOLDOWNS = 3      # reversal counts within N cooldown spans


def _labeled(section, prefix, key='model'):
    """``{label_value: number}`` from snapshot keys shaped
    ``prefix{key=value}`` (the registry's labeled-instrument spelling).
    These families carry exactly ONE label key, so everything between
    ``key=`` and the closing brace IS the value — no comma split, which
    would truncate values that legitimately contain commas (the
    Executor's ``executor.p1[4x8,16x2]`` shape-signature labels)."""
    out = {}
    marker = prefix + '{' + key + '='
    for k, v in (section or {}).items():
        if k.startswith(marker) and k.endswith('}') and \
                isinstance(v, (int, float)):
            out[k[len(marker):-1]] = v
    return out


def _diag(cause, severity, detail, fix, **evidence):
    return {'cause': cause, 'severity': severity, 'detail': detail,
            'fix': fix, 'evidence': evidence}


def _hist(snapshot, name):
    return (snapshot or {}).get('histograms', {}).get(name) or {}


def _ctr(snapshot, name):
    return (snapshot or {}).get('counters', {}).get(name, 0)


# -- detectors --------------------------------------------------------------

def detect_straggler(events=None, snapshot=None, cluster=None,
                     skew_threshold=SKEW_THRESHOLD, **_):
    """Per-rank step-time skew from the cluster snapshot (>= 2 ranks with
    steps). Falls back to rank-stamped ``step`` events when no snapshot
    carries step histograms."""
    per_rank = {}
    if cluster:
        for rank, row in (cluster.get('per_rank') or {}).items():
            st = row.get('step_ms') or {}
            if st.get('count'):
                per_rank[int(rank)] = (float(st.get('mean', 0.0)),
                                       int(st['count']))
    if not per_rank and events:
        sums = {}
        for e in events:
            if e.get('ev') == 'step' and isinstance(
                    e.get('step_ms'), (int, float)) and 'rank' in e:
                s, n = sums.get(int(e['rank']), (0.0, 0))
                sums[int(e['rank'])] = (s + float(e['step_ms']), n + 1)
        per_rank = {r: (s / n, n) for r, (s, n) in sums.items() if n}
    if len(per_rank) < 2:
        return
    means = sorted(m for m, _n in per_rank.values())
    # lower median: with an even rank count the upper middle can BE the
    # straggler, hiding the skew
    median = means[(len(means) - 1) // 2]
    if median <= 0:
        return
    worst_rank, (worst_mean, worst_n) = max(
        per_rank.items(), key=lambda kv: kv[1][0])
    skew = worst_mean / median
    if skew < skew_threshold:
        return
    yield _diag(
        'straggler', 'critical',
        f"rank {worst_rank} mean step {worst_mean:.1f}ms vs cluster median "
        f"{median:.1f}ms ({skew:.1f}x) over {worst_n} step(s)",
        "inspect that rank's lane in merged_trace.json: a slow host "
        "(input pipeline, checkpoint I/O) shows host-side spans stretching; "
        "a slow card shows uniform step stretch — reschedule the rank or "
        "drop it via elastic restart",
        rank=worst_rank, mean_step_ms=round(worst_mean, 3),
        median_step_ms=round(median, 3), skew=round(skew, 3),
        per_rank_mean_step_ms={r: round(m, 3)
                               for r, (m, _n) in sorted(per_rank.items())})


def detect_retrace_storm(events=None, snapshot=None, cluster=None,
                         warmup_steps=WARMUP_STEPS,
                         retrace_grace=RETRACE_GRACE, **_):
    """Kernel-build growth after warmup (the reference's XLA compiles): in
    steady state every step reuses the built library, so builds beyond the
    warmed-up set mean something keeps invalidating it."""
    rows = []
    if cluster:
        for rank, row in (cluster.get('per_rank') or {}).items():
            rows.append((f"rank {rank}", int(row.get('steps') or 0),
                         int(row.get('kernel_builds') or 0)))
    elif snapshot is not None:
        steps = int(_ctr(snapshot, 'hapi.steps')
                    or _hist(snapshot, 'hapi.step_ms').get('count', 0))
        rows.append(('process', steps,
                     int(_ctr(snapshot, 'kernels.builds'))))
    for who, steps, compiles in rows:
        if steps <= warmup_steps:
            continue
        excess = compiles - warmup_steps - retrace_grace
        if excess <= 0 or compiles < 0.5 * steps:
            continue
        yield _diag(
            'retrace_storm', 'critical',
            f"{who}: {compiles} kernel build(s) over {steps} step(s) — "
            "steady state should build ~once; something rebuilds every "
            "step",
            "the kernel library is rebuilt when its sources' digest "
            "changes: keep paddle_tpu_torch/kernels/csrc and the build "
            "flags fixed during a run, and keep kernels/build/ writable so "
            "a built library is reused",
            who=who, steps=steps, compiles=compiles)


def detect_input_bound(events=None, snapshot=None, cluster=None,
                       input_bound_ratio=INPUT_BOUND_RATIO, **_):
    """Dataloader wait dominating step time: the device idles on host
    feed. Uses histogram sums (wait vs step) per process/cluster, plus the
    streamed ``input_stall`` events as corroborating evidence."""
    rows = []
    if cluster:
        for rank, row in (cluster.get('per_rank') or {}).items():
            st = row.get('step_ms') or {}
            step_sum = float(st.get('mean', 0.0)) * int(st.get('count') or 0)
            rows.append((f"rank {rank}",
                         float(row.get('dataloader_wait_ms_sum') or 0.0),
                         step_sum))
    elif snapshot is not None:
        rows.append(('process',
                     float(_hist(snapshot,
                                 'dataloader.next_wait_ms').get('sum', 0.0)),
                     float(_hist(snapshot, 'hapi.step_ms').get('sum', 0.0))))
    stalls = sum(1 for e in (events or []) if e.get('ev') == 'input_stall')
    for who, wait_ms, step_ms in rows:
        if step_ms <= 0 or wait_ms <= 0:
            continue
        ratio = wait_ms / step_ms
        if ratio < input_bound_ratio:
            continue
        yield _diag(
            'input_bound', 'warning',
            f"{who}: dataloader wait {wait_ms:.0f}ms is "
            f"{100 * ratio:.0f}% of step time {step_ms:.0f}ms — the step "
            "starves on host feed",
            "raise DataLoader num_workers / prefetch depth, move decode or "
            "augmentation off the step path, or shard the input files "
            "wider; dataloader.queue_depth should sit near its capacity",
            who=who, wait_ms=round(wait_ms, 1), step_ms=round(step_ms, 1),
            ratio=round(ratio, 3), input_stall_events=stalls)


def detect_serving_overload(events=None, snapshot=None, cluster=None,
                            overload_ratio=OVERLOAD_RATIO, **_):
    """Load shedding / deadline expiry trending up on the serving stream:
    offered load exceeds what the engine drains."""
    counters = (cluster or {}).get('counters_total') if cluster else None
    if counters is None and snapshot is not None:
        counters = {
            'serving_requests': _ctr(snapshot, 'serving.requests'),
            'serving_shed': _ctr(snapshot, 'serving.shed'),
            'serving_shed_page_exhaustion': _ctr(
                snapshot, 'serving.shed.page_exhaustion'),
            'serving_deadline_expired': _ctr(snapshot,
                                             'serving.deadline_expired'),
        }
    # serving.requests counts every submission (sheds included), so it IS
    # the offered load; the event stream reconstructs the same totals when
    # no counter snapshot is available. Page-exhaustion sheds are memory
    # pressure wearing a queue-full mask — kv_page_exhaustion owns those,
    # and counting them here would prescribe replicas for an OOM.
    offered = shed = expired = page_shed = 0
    if counters:
        offered = int(counters.get('serving_requests') or 0)
        shed = int(counters.get('serving_shed') or 0)
        page_shed = int(counters.get('serving_shed_page_exhaustion') or 0)
        expired = int(counters.get('serving_deadline_expired') or 0)
    if events:
        ev_shed = sum(1 for e in events if e.get('ev') == 'serving.shed')
        ev_pshed = sum(1 for e in events if e.get('ev') == 'serving.shed'
                       and e.get('reason') == 'page_exhaustion')
        ev_exp = sum(1 for e in events if e.get('ev') == 'serving.request'
                     and e.get('status') == 'deadline')
        ev_req = sum(1 for e in events if e.get('ev') == 'serving.request')
        shed = max(shed, ev_shed)
        page_shed = max(page_shed, ev_pshed)
        expired = max(expired, ev_exp)
        offered = max(offered, ev_req + ev_shed)
    shed = max(0, shed - page_shed)
    bad = shed + expired
    if not offered or not bad:
        return
    ratio = bad / offered
    if ratio < overload_ratio:
        return
    yield _diag(
        'serving_overload', 'warning' if ratio < 0.25 else 'critical',
        f"{bad} of {offered} request(s) shed or deadline-expired "
        f"({100 * ratio:.0f}%) — offered load exceeds engine capacity",
        "add engine replicas or raise queue_capacity only with more "
        "compute behind it; widen the bucket set so batches fill, or "
        "lower client deadlines so doomed work is shed at admission "
        "instead of after queueing",
        offered=offered, shed=shed, deadline_expired=expired,
        ratio=round(ratio, 3))


def detect_kv_page_exhaustion(events=None, snapshot=None, cluster=None, **_):
    """The paged KV cache ran out of pages: admission blocked behind page
    starvation (sheds attributed ``page_exhaustion``), decode rows
    stalled, or sequences were preempted to free memory. Distinct from
    ``serving_overload`` on purpose — the fix is pages, not replicas."""
    counters = (cluster or {}).get('counters_total') if cluster else None
    if counters is None and snapshot is not None:
        counters = {
            'serving_shed_page_exhaustion': _ctr(
                snapshot, 'serving.shed.page_exhaustion'),
            'serving_kv_decode_stalls': _ctr(snapshot,
                                             'serving.kv.decode_stalls'),
            'serving_kv_prefill_stalls': _ctr(snapshot,
                                              'serving.kv.prefill_stalls'),
            'serving_preemptions': _ctr(snapshot, 'serving.preemptions'),
        }
    page_shed = stalls = preempts = 0
    if counters:
        page_shed = int(counters.get('serving_shed_page_exhaustion') or 0)
        stalls = (int(counters.get('serving_kv_decode_stalls') or 0) +
                  int(counters.get('serving_kv_prefill_stalls') or 0))
        preempts = int(counters.get('serving_preemptions') or 0)
    if events:
        page_shed = max(page_shed, sum(
            1 for e in events if e.get('ev') == 'serving.shed'
            and e.get('reason') == 'page_exhaustion'))
        stalls = max(stalls, sum(
            1 for e in events if e.get('ev') == 'serving.page_exhausted'))
        preempts = max(preempts, sum(
            1 for e in events if e.get('ev') == 'serving.preempt'))
    if not (page_shed or stalls or preempts):
        return
    util = None
    if snapshot is not None:
        util = (snapshot.get('gauges') or {}).get(
            'serving.kv.page_utilization')
    severity = 'critical' if (page_shed or preempts) else 'warning'
    yield _diag(
        'kv_page_exhaustion', severity,
        f"paged KV cache out of pages: {page_shed} shed(s) attributed to "
        f"page exhaustion, {stalls} stall(s), {preempts} preemption(s)"
        + (f" at {100 * util:.0f}% page utilization"
           if isinstance(util, (int, float)) else ""),
        "grow num_pages (or shrink page_size to cut tail waste), enable "
        "prefix_cache= for shared system prompts, or lower "
        "max_new_tokens/deadlines; raising queue_capacity or adding "
        "replicas will NOT help — memory, not traffic, is the limit",
        page_exhaustion_sheds=page_shed, stalls=stalls,
        preemptions=preempts,
        **({'page_utilization': round(util, 4)}
           if isinstance(util, (int, float)) else {}))


def detect_rank_flatline(events=None, snapshot=None, cluster=None,
                         stale_heartbeat_s=STALE_HEARTBEAT_S, **_):
    """A rank whose heartbeat went stale while siblings stay fresh: a
    wedged collective or a dead process the deadline layer hasn't named
    yet."""
    ages = (cluster or {}).get('heartbeat_age_s') or {}
    fresh = [r for r, a in ages.items()
             if a is not None and a < stale_heartbeat_s]
    for rank, age in sorted(ages.items()):
        if age is None or age < stale_heartbeat_s or not fresh:
            continue
        yield _diag(
            'rank_flatline', 'critical',
            f"rank {rank} heartbeat is {age:.1f}s stale while "
            f"{len(fresh)} sibling(s) beat on — wedged or dead rank",
            "the supervisor's fail-fast should fire shortly; if not, check "
            "distributed.set_timeout (collective deadline) and the rank's "
            "stderr log in the run dir",
            rank=rank, heartbeat_age_s=age, fresh_ranks=sorted(fresh))


def detect_memory_pressure(events=None, snapshot=None, cluster=None,
                           hbm_budget=None,
                           memory_pressure_ratio=MEMORY_PRESSURE_RATIO, **_):
    """Worst per-program peak memory vs. the device budget, from the cost
    ledger's ``cost.peak_bytes{program=}`` gauges (snapshot) or
    ``cost.program`` events. Budget: the ``hbm_budget`` override, the
    ``PADDLE_TPU_HBM_BUDGET`` env (bytes), or — when the process has
    torch loaded already and CUDA available — the card's total memory
    (``torch.cuda.mem_get_info``). The detector never imports torch
    itself: the operator's tools run this module by path without it."""
    import os
    import sys
    budget = hbm_budget
    if budget is None:
        raw = os.environ.get('PADDLE_TPU_HBM_BUDGET', '')
        if raw:
            try:
                budget = int(float(raw))
            except ValueError:
                budget = None
    torch = sys.modules.get('torch')
    if budget is None and torch is not None:
        try:
            budget = (int(torch.cuda.mem_get_info()[1]) or None
                      if torch.cuda.is_available() else None)
        except Exception:
            budget = None
    if not budget:
        return
    peaks = {}
    if snapshot is not None:
        peaks.update(_labeled(snapshot.get('gauges'), 'cost.peak_bytes',
                              key='program'))
    for e in (events or []):
        if e.get('ev') == 'cost.program' and isinstance(
                e.get('peak_bytes'), (int, float)):
            name = str(e.get('program', '?'))
            peaks[name] = max(peaks.get(name, 0), float(e['peak_bytes']))
    if not peaks:
        return
    worst_prog, worst = max(peaks.items(), key=lambda kv: kv[1])
    ratio = worst / budget
    if ratio < memory_pressure_ratio:
        return
    yield _diag(
        'memory_pressure', 'critical' if ratio >= 1.0 else 'warning',
        f"program {worst_prog!r} peaks at {worst / 1e6:.1f} MB = "
        f"{100 * ratio:.0f}% of the {budget / 1e6:.1f} MB device budget"
        + (" — it does not fit" if ratio >= 1.0 else
           " — the next bigger batch/sequence will not fit"),
        "cut live memory: engine.build_train_step(microbatch=k) to shrink "
        "the per-dispatch batch, remat='dots'/'full' to trade FLOPs for "
        "activations, FSDP sharding (with distributed/) to split "
        "params/optimizer state, or page the serving KV cache down; raise "
        "PADDLE_TPU_HBM_BUDGET only if the budget was set conservatively",
        program=worst_prog, peak_bytes=int(worst), budget_bytes=int(budget),
        ratio=round(ratio, 4))


def detect_slo_burn(events=None, snapshot=None, cluster=None,
                    slo_burn_warning=SLO_BURN_WARNING,
                    slo_burn_critical=SLO_BURN_CRITICAL, **_):
    """Error-budget burn per served model, from the SLO tracker's
    ``slo.burn_rate{model=}`` gauge (snapshot) or the ``slo.violation``
    event stream. The gauge WINS where both exist: it is updated on every
    request, while a violation event carries the burn at emission — stale
    the moment good requests follow — so events only fill models the
    snapshot does not cover (bare event-log runs, flight dumps). Counts
    likewise take the max of the two sources, never their sum."""
    burns = {}
    counts = {}
    if snapshot is not None:
        burns.update(_labeled(snapshot.get('gauges'), 'slo.burn_rate'))
        counts.update(_labeled(snapshot.get('counters'), 'slo.violations'))
    ev_burns, ev_counts = {}, {}
    for e in (events or []):
        if e.get('ev') == 'slo.violation' and isinstance(
                e.get('burn_rate'), (int, float)):
            model = str(e.get('model', '?'))
            ev_burns[model] = float(e['burn_rate'])  # stream: last wins
            ev_counts[model] = ev_counts.get(model, 0) + 1
    for model, b in ev_burns.items():
        burns.setdefault(model, b)
    for model, n in ev_counts.items():
        counts[model] = max(counts.get(model, 0), n)
    for model, burn in sorted(burns.items()):
        if burn < slo_burn_warning:
            continue
        severity = 'critical' if burn >= slo_burn_critical else 'warning'
        yield _diag(
            'slo_burn', severity,
            f"model {model!r} is burning its latency error budget at "
            f"{burn:.1f}x the sustainable rate"
            + (f" ({int(counts[model])} violation(s))"
               if counts.get(model) else ""),
            "cut tail latency (widen buckets so batches fill, shrink "
            "max_new_tokens/deadlines, add prefix caching) or add "
            "capacity; if the objective is wrong, re-register with a "
            "realistic slo_ms — burning quietly hides real regressions",
            model=model, burn_rate=round(burn, 3),
            violations=int(counts.get(model, 0)))


def detect_checkpoint_stall(events=None, snapshot=None, cluster=None,
                            checkpoint_stall_ratio=CHECKPOINT_STALL_RATIO,
                            **_):
    """Checkpoint saves stalling the training thread: the mean
    ``checkpoint.save_stall_ms`` (training-thread blocked time — the full
    commit for synchronous saves, ~0 for async ones) is a large fraction
    of the mean step time. The fix is the async save path, not a faster
    disk."""
    stall_mean = stall_count = step_mean = 0.0
    if snapshot is not None:
        h = _hist(snapshot, 'checkpoint.save_stall_ms')
        stall_mean, stall_count = float(h.get('mean', 0.0)), \
            int(h.get('count') or 0)
        for name in ('hapi.step_ms', 'engine.step_ms'):
            sh = _hist(snapshot, name)
            if sh.get('count'):
                step_mean = float(sh.get('mean', 0.0))
                break
    if (not stall_count or not step_mean) and events:
        # event-stream fallback: synchronous saves' commit time IS their
        # stall; async saves are excluded (their stall is the enqueue)
        durs = [float(e['duration_ms']) for e in events
                if e.get('ev') == 'checkpoint.save'
                and not e.get('async_')
                and isinstance(e.get('duration_ms'), (int, float))]
        steps = [float(e['step_ms']) for e in events
                 if e.get('ev') == 'step'
                 and isinstance(e.get('step_ms'), (int, float))]
        if durs and steps:
            stall_mean = sum(durs) / len(durs)
            stall_count = len(durs)
            step_mean = sum(steps) / len(steps)
    if not stall_count or step_mean <= 0 or stall_mean <= 0:
        return
    ratio = stall_mean / step_mean
    if ratio < checkpoint_stall_ratio:
        return
    yield _diag(
        'checkpoint_stall', 'warning',
        f"checkpoint saves stall the training thread {stall_mean:.1f}ms "
        f"on average = {100 * ratio:.0f}% of the {step_mean:.1f}ms mean "
        f"step, over {stall_count} save(s)",
        "use the async save path: CheckpointManager.save(async_=True), "
        "CheckpointSaver(async_save=True), or engine.fit(checkpoint=..., "
        "async_save=True) — the snapshot+commit move to a background "
        "thread and checkpoint.save_stall_ms drops to ~0 "
        "(checkpoint.commit_ms keeps the true disk latency)",
        stall_ms=round(stall_mean, 3), step_ms=round(step_mean, 3),
        ratio=round(ratio, 3), saves=stall_count)


def detect_elastic_downsize(events=None, snapshot=None, cluster=None, **_):
    """The world size shrank mid-run: a rank died and the elastic
    supervisor re-formed the mesh with the survivors instead of
    fail-fasting. Informational by design — the run SURVIVED — but every
    downsize means less throughput and one less failure the budget can
    absorb, so it must never pass silently."""
    downs = [e for e in (events or [])
             if e.get('ev') == 'elastic.downsize']
    count = len(downs)
    for src in (snapshot, None if cluster is None else
                {'counters': cluster.get('counters_total') or {}}):
        if src is not None:
            count = max(count, int(_ctr(
                src, 'distributed.elastic_downsizes') or 0))
    if not count:
        return
    recov = _hist(snapshot, 'elastic.recovery_ms') if snapshot else {}
    for e in downs or [{}]:
        dead = e.get('dead_rank')
        detail = (f"world shrank {e.get('old_world', '?')} -> "
                  f"{e.get('new_world', '?')}"
                  + (f" after rank {dead} died"
                     + (f" ({e['signal']})" if e.get('signal') else "")
                     if dead is not None else "")) if e else \
            f"{count} elastic downsize(s) this run"
        yield _diag(
            'elastic_downsize', 'info', detail,
            "the job survived on fewer ranks; restore full capacity by "
            "bringing a replacement up inside the rejoin grace window "
            "(rejoin_<rank> marker / a rescheduled node), or expect "
            "proportionally lower throughput until the next full restart",
            downsizes=count,
            **({'dead_rank': dead} if e and dead is not None else {}),
            **({'recovery_ms_p50': round(recov['p50'], 1)}
               if recov.get('count') else {}))
        if not e:
            break


def detect_replica_flapping(events=None, snapshot=None, cluster=None,
                            flap_opens=FLAP_OPENS, **_):
    """A serving replica's circuit breaker is oscillating: it opened
    ``flap_opens``+ times this window (``serving.router.circuit``
    events), usually with closes in between — the half-open probe window
    keeps re-admitting a replica that is not actually better (cold
    compile storm on rejoin, flaky host, undersized warmup), so live
    traffic keeps paying the failure tax."""
    opens, closes, last_reason = {}, {}, {}
    for e in (events or []):
        if e.get('ev') != 'serving.router.circuit':
            continue
        rep = str(e.get('replica', '?'))
        if e.get('state') == 'open':
            opens[rep] = opens.get(rep, 0) + 1
            if e.get('reason'):
                last_reason[rep] = str(e['reason'])
        elif e.get('state') == 'closed':
            closes[rep] = closes.get(rep, 0) + 1
    if not opens:
        # last-wins router_stats fallback (flight dumps with a short
        # event window): lifetime trip counts, no close attribution
        for e in reversed(events or []):
            if e.get('ev') == 'serving.router_stats':
                for rep, row in (e.get('replicas') or {}).items():
                    if isinstance(row, dict) and row.get('trips'):
                        opens[str(rep)] = int(row['trips'])
                break
    for rep, n in sorted(opens.items()):
        if n < flap_opens:
            continue
        severity = 'critical' if n >= 2 * flap_opens else 'warning'
        yield _diag(
            'replica_flapping', severity,
            f"replica {rep!r} circuit opened {n} time(s)"
            + (f", closed {closes[rep]} time(s)" if closes.get(rep) else "")
            + (f" (last trip: {last_reason[rep]})"
               if last_reason.get(rep) else "")
            + " — it keeps being re-admitted and keeps failing",
            f"stop the flap at replica {rep!r}: lengthen its half-open "
            "warmup (raise RouterPolicy.half_open_probes and "
            "circuit_cooldown_s so a rejoining replica proves itself on "
            "more probes before taking real traffic), make sure the "
            "relaunch path calls warmup() so probes don't hit a cold "
            "compile storm, and if it still trips, drain() it and "
            "inspect the host instead of letting the breaker babysit it",
            replica=rep, opens=n, closes=int(closes.get(rep, 0)),
            **({'last_trip': last_reason[rep]}
               if last_reason.get(rep) else {}))


def detect_retry_storm(events=None, snapshot=None, cluster=None,
                       retry_storm_ratio=RETRY_STORM_RATIO,
                       retry_storm_min=RETRY_STORM_MIN, **_):
    """Router failover retries are a large fraction of offered load —
    retry amplification: every failed request multiplies into several
    dispatched ones, which is exactly how a degraded fleet melts the
    healthy replicas too. Offered = first-attempt dispatches (dispatched
    minus retries minus hedges); fires at ``retries/offered >=``
    ``retry_storm_ratio`` once at least ``retry_storm_min`` requests were
    offered."""
    dispatched = retries = hedges = 0
    if snapshot is not None:
        # per-replica labeled families (one label set per family): the
        # fleet total is the sum over replica labels
        ctrs = snapshot.get('counters')
        dispatched = int(sum(_labeled(
            ctrs, 'serving.router.dispatched', key='replica').values()))
        retries = int(sum(_labeled(
            ctrs, 'serving.router.retries', key='replica').values()))
        hedges = int(sum(_labeled(
            ctrs, 'serving.router.hedges', key='replica').values()))
    if not dispatched:
        for e in reversed(events or []):   # last-wins cumulative event
            if e.get('ev') == 'serving.router_stats':
                for row in (e.get('replicas') or {}).values():
                    if isinstance(row, dict):
                        dispatched += int(row.get('dispatched') or 0)
                        retries += int(row.get('retried') or 0)
                        hedges += int(row.get('hedged') or 0)
                break
    offered = dispatched - retries - hedges
    if offered < retry_storm_min or retries <= 0:
        return
    ratio = retries / offered
    if ratio < retry_storm_ratio:
        return
    severity = 'critical' if ratio >= 2 * retry_storm_ratio else 'warning'
    yield _diag(
        'retry_storm', severity,
        f"{retries} failover retries on {offered} offered request(s) = "
        f"{100 * ratio:.0f}% amplification — the fleet is re-dispatching "
        "a large share of its load onto the surviving replicas",
        "find WHY requests fail over (serving.router.failover events and "
        "the circuit log name the replica) and fix that replica; then "
        "bound the blast radius — lower RouterPolicy.max_retries, keep "
        "hedging for tail latency only (hedge_after_ms near p95, not "
        "p50), and check the shed ladder thresholds engage before "
        "retries do, so overload sheds instead of amplifying",
        dispatched=dispatched, retries=retries, hedges=hedges,
        offered=offered, ratio=round(ratio, 3))


def detect_lint_debt(events=None, snapshot=None, cluster=None,
                     lint_debt_threshold=None, repo_root=None, **_):
    """The repo's justified-waiver count outgrew the budget recorded in
    ``graftlint.toml`` (``lint_debt_threshold``). Every waiver is a rule
    firing that somebody argued around; past the budget the arguing is
    the norm and the linter has stopped steering. Info-only: the gate
    (tier-1 lint) still passes — this names the creeping debt before a
    waiver-heavy PR normalizes it. Quiet when no budget is recorded or
    the tree is not checked out (installed package without sources)."""
    import os
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    root = repo_root
    if root is None:
        root = os.path.dirname(os.path.dirname(here))
    toml = os.path.join(root, 'graftlint.toml')
    if not os.path.isfile(toml):
        return
    try:
        with open(toml, 'r', encoding='utf-8') as f:
            cfg_text = f.read()
    except OSError:
        return
    if lint_debt_threshold is None:
        m = re.search(r'^\s*lint_debt_threshold\s*=\s*(\d+)', cfg_text,
                      re.MULTILINE)
        if m is None:
            return
        lint_debt_threshold = int(m.group(1))
    file_waivers = len(re.findall(r'\[\[graftlint\.waiver\]\]', cfg_text))
    inline = 0
    # this package's own sources (the reference scans paddle_tpu/)
    pkg = os.path.join(root, os.path.basename(os.path.dirname(here)))
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != '__pycache__']
        for fn in filenames:
            if not fn.endswith('.py'):
                continue
            try:
                with open(os.path.join(dirpath, fn), 'r',
                          encoding='utf-8') as f:
                    inline += len(re.findall(r'#\s*graftlint:\s*disable',
                                             f.read()))
            except OSError:
                continue
    total = file_waivers + inline
    if total <= int(lint_debt_threshold):
        return
    yield _diag(
        'lint_debt', 'info',
        f"{total} graftlint waiver(s) in the tree ({inline} inline, "
        f"{file_waivers} file-level) exceed the lint_debt_threshold="
        f"{lint_debt_threshold} budget recorded in graftlint.toml",
        "burn down the debt before adding to it: re-read the oldest "
        "waivers (git log -S 'graftlint: disable'), fix the ones whose "
        "justification no longer holds, and only then raise "
        "lint_debt_threshold for the remainder that is genuinely "
        "by-design",
        waivers=total, inline=inline, file_level=file_waivers,
        threshold=int(lint_debt_threshold))


# -- trend detectors (ring-sampler timelines) -------------------------------

def _series(snapshot=None, cluster=None):
    """Per-series timelines (``aggregate.merged_timeseries`` shape) from
    the cluster snapshot, falling back to any ``timeseries`` block on the
    plain snapshot. Empty dict when the run has no sampler output — every
    trend detector is quiet then."""
    for doc in (cluster, snapshot):
        ts = (doc or {}).get('timeseries')
        if isinstance(ts, dict) and isinstance(ts.get('series'), dict):
            return ts['series']
    return {}


def _timelines(entry):
    """``(rank, [(ts, value), ...])`` per rank from one series entry —
    ranks come back as strings after a JSON round trip, values must be
    numeric pairs."""
    for rank, tl in sorted((entry or {}).items(), key=lambda kv: str(kv[0])):
        try:
            rank = int(rank)
        except (TypeError, ValueError):
            pass
        pts = [(p[0], p[1]) for p in (tl or [])
               if isinstance(p, (list, tuple)) and len(p) == 2
               and isinstance(p[1], (int, float))]
        if pts:
            yield rank, pts


def detect_page_leak(events=None, snapshot=None, cluster=None,
                     page_leak_min_samples=PAGE_LEAK_MIN_SAMPLES,
                     page_leak_growth=PAGE_LEAK_GROWTH,
                     page_leak_occupancy_range=PAGE_LEAK_OCCUPANCY_RANGE,
                     **_):
    """KV page utilization climbing monotonically while occupancy stays
    flat: pages are allocated and never freed. A point snapshot only says
    "utilization is high" — the timeline shows it never comes back down
    even though the engine is serving the same number of sequences."""
    series = _series(snapshot, cluster)
    util = series.get('gauge:serving.kv.page_utilization') or {}
    slots = dict(_timelines(series.get('gauge:serving.active_slots') or {}))
    for rank, tl in _timelines(util):
        vals = [v for _ts, v in tl]
        if len(vals) < page_leak_min_samples:
            continue
        growth = vals[-1] - vals[0]
        if growth < page_leak_growth:
            continue
        # a leak never gives pages back: any real dip means churn, not leak
        if any(b < a - 1e-6 for a, b in zip(vals, vals[1:])):
            continue
        # stable occupancy separates a leak from genuine load growth
        occ = [v for _ts, v in slots.get(rank, [])]
        if occ:
            lo, hi = min(occ), max(occ)
            if hi > 0 and (hi - lo) / hi > page_leak_occupancy_range:
                continue
        severity = ('critical' if vals[-1] >= PAGE_LEAK_CRITICAL_UTIL
                    else 'warning')
        yield _diag(
            'page_leak', severity,
            f"rank {rank}: KV page utilization grew "
            f"{vals[0]:.2f} -> {vals[-1]:.2f} monotonically over "
            f"{len(vals)} sample(s) with stable occupancy — pages are "
            "allocated and never freed",
            "audit the page release paths: every PageAllocator.alloc() "
            "needs a matching decref() on sequence finish AND on "
            "preemption/cancel; utilization should fall whenever "
            "active_slots does. The /timeseries endpoint "
            "--series page_utilization shows the climb",
            rank=rank, first_util=round(vals[0], 4),
            last_util=round(vals[-1], 4), growth=round(growth, 4),
            n_samples=len(vals))


def detect_latency_creep(events=None, snapshot=None, cluster=None,
                         latency_creep_min_samples=LATENCY_CREEP_MIN_SAMPLES,
                         latency_creep_ratio=LATENCY_CREEP_RATIO,
                         latency_series='hist:serving.latency_ms:p99', **_):
    """Request p99 rising steadily over the run: last-third mean vs
    first-third mean, and the timeline mostly rising — degradation too
    slow for any single snapshot (or the SLO burn-rate window) to flag."""
    series = _series(snapshot, cluster)
    for rank, tl in _timelines(series.get(latency_series) or {}):
        vals = [v for _ts, v in tl]
        if len(vals) < latency_creep_min_samples:
            continue
        third = max(len(vals) // 3, 1)
        head = sum(vals[:third]) / third
        tail = sum(vals[-third:]) / third
        if head <= 0 or tail < latency_creep_ratio * head:
            continue
        rising = sum(1 for a, b in zip(vals, vals[1:]) if b >= a - 1e-9)
        if rising < 0.6 * (len(vals) - 1):
            continue
        ratio = tail / head
        severity = ('critical' if ratio >= 2 * latency_creep_ratio
                    else 'warning')
        yield _diag(
            'latency_creep', severity,
            f"rank {rank}: {latency_series.split(':', 1)[1]} crept "
            f"{head:.1f} -> {tail:.1f} ({ratio:.1f}x) over "
            f"{len(vals)} sample(s)",
            "slow accumulation, not a spike: look for resource growth in "
            "the same window (page_leak, queue_depth, compile_creep) — "
            "the /timeseries endpoint lines the series up; if "
            "nothing grows, suspect host-side interference on that rank",
            rank=rank, first_third_mean=round(head, 3),
            last_third_mean=round(tail, 3), ratio=round(ratio, 3),
            n_samples=len(vals), series=latency_series)


def detect_qps_collapse(events=None, snapshot=None, cluster=None,
                        qps_collapse_min_samples=QPS_COLLAPSE_MIN_SAMPLES,
                        qps_collapse_ratio=QPS_COLLAPSE_RATIO,
                        qps_collapse_window=QPS_COLLAPSE_WINDOW, **_):
    """Throughput cliff: the trailing window's per-sample request rate
    collapsed vs the run median. The cumulative counter timelines are
    dense (a sample with no delta still contributes a flat point), so a
    stall shows up as exactly this — flat tail, healthy median."""
    series = _series(snapshot, cluster)
    entry = None
    for name in ('counter:serving.requests', 'counter:hapi.steps'):
        entry = series.get(name)
        if entry:
            break
    if not entry:
        return
    for rank, tl in _timelines(entry):
        if len(tl) < qps_collapse_min_samples:
            continue
        deltas = [b[1] - a[1] for a, b in zip(tl, tl[1:])]
        busy = sorted(d for d in deltas if d > 0)
        if len(busy) < qps_collapse_window:
            continue
        run_med = busy[len(busy) // 2]
        tail = sorted(deltas[-qps_collapse_window:])
        tail_med = tail[len(tail) // 2]
        if run_med <= 0 or tail_med > qps_collapse_ratio * run_med:
            continue
        yield _diag(
            'qps_collapse', 'critical',
            f"rank {rank}: {name.split(':', 1)[1]} rate collapsed to "
            f"{tail_med:.1f}/sample in the last {qps_collapse_window} "
            f"sample(s) vs run median {run_med:.1f}/sample",
            "the engine is alive (samples keep landing) but work stopped "
            "flowing: check admission (queue_depth / shed counters), the "
            "paged-KV pool (kv_page_exhaustion / page_leak), and upstream "
            "feed; merged_trace.json shows which stage went quiet",
            rank=rank, tail_rate=round(tail_med, 3),
            median_rate=round(run_med, 3),
            ratio=round(tail_med / run_med, 3), series=name,
            n_samples=len(tl))


def detect_compile_creep(events=None, snapshot=None, cluster=None,
                         compile_creep_plateau=COMPILE_CREEP_PLATEAU,
                         compile_creep_grace=COMPILE_CREEP_GRACE, **_):
    """``kernels.builds`` growing again AFTER the warmup plateau — the
    time-resolved upgrade of ``retrace_storm``: that one needs the
    aggregate compiles/steps ratio to already look bad; this fires on the
    inflection, while the cumulative total still looks innocent."""
    series = _series(snapshot, cluster)
    for rank, tl in _timelines(series.get('counter:kernels.builds') or {}):
        vals = [v for _ts, v in tl]
        if len(vals) < compile_creep_plateau + 2:
            continue
        # the warmup plateau: the first run of >= plateau consecutive
        # zero-delta samples (steady state reuses the cached program)
        plateau_end, flat = None, 0
        for i in range(1, len(vals)):
            if vals[i] == vals[i - 1]:
                flat += 1
                if flat >= compile_creep_plateau and plateau_end is None:
                    plateau_end = i
            else:
                flat = 0
        if plateau_end is None:
            continue
        post = vals[-1] - vals[plateau_end]
        if post < compile_creep_grace:
            continue
        yield _diag(
            'compile_creep', 'warning',
            f"rank {rank}: {post:.0f} new kernel build(s) after the warmup "
            f"plateau ({vals[plateau_end]:.0f} builds held flat for "
            f"{compile_creep_plateau}+ samples, now {vals[-1]:.0f})",
            "something started rebuilding the kernel library mid-run: its "
            "sources or build flags changed after warmup, or its build "
            "directory was cleared — keep paddle_tpu_torch/kernels/csrc "
            "and kernels/build/ fixed while the run lasts",
            rank=rank, plateau_compiles=vals[plateau_end],
            final_compiles=vals[-1], post_plateau=post,
            n_samples=len(vals))


def _load_baseline():
    """The cross-run baseline module, package-relative or by path (this
    module may be loaded standalone, by path)."""
    if __package__:
        from . import baseline
        return baseline
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'baseline.py')
    try:
        spec = importlib.util.spec_from_file_location(
            'paddle_tpu_torch_baseline_standalone', path)
        if spec is None or spec.loader is None:
            return None
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except (OSError, ImportError):
        return None


def detect_perf_regression(events=None, snapshot=None, cluster=None,
                           runs_path=None, perf_min_samples=None, **_):
    """The latest run in the cross-run registry regressed vs the rolling
    median + MAD of prior runs (``baseline.detect_regressions`` — robust,
    direction-aware). Points at the registry via ``runs_path`` or
    ``PADDLE_TPU_RUNS_REGISTRY``; quiet without one."""
    import os
    path = runs_path or os.environ.get('PADDLE_TPU_RUNS_REGISTRY')
    if not path or not os.path.isfile(path):
        return
    baseline = _load_baseline()
    if baseline is None:
        return
    kw = {} if perf_min_samples is None else \
        {'min_samples': int(perf_min_samples)}
    runs = baseline.load_runs(path)
    for reg in baseline.detect_regressions(runs, **kw):
        severity = ('critical' if abs(reg.get('rel_change', 0)) >= 0.5
                    else 'warning')
        yield _diag(
            'perf_regression', severity,
            f"{reg['metric']}: last run {reg['value']:g} vs rolling median "
            f"{reg['median']:g} of {reg['n_baseline']} prior run(s) "
            f"({reg['direction']} {100 * abs(reg['rel_change']):.0f}%, "
            f"bad direction: {reg['bad_direction']})",
            "baseline.history(runs, <metric>) shows the trend; "
            "bisect the runs between the last healthy record and this one "
            "(each record carries its config fingerprint) — if the change "
            "is intentional, land a new baseline by letting healthy runs "
            "accumulate past the window",
            metric=reg['metric'], value=reg['value'],
            median=reg['median'], mad=reg.get('mad', 0),
            rel_change=reg['rel_change'], direction=reg['direction'],
            n_baseline=reg['n_baseline'])


def detect_cold_compile_storm(events=None, snapshot=None, cluster=None,
                              cold_storm_compiles=COLD_STORM_COMPILES,
                              cold_storm_hit_rate=COLD_STORM_HIT_RATE,
                              cold_storm_incompat=COLD_STORM_INCOMPAT,
                              **_):
    """A persistent compile cache is bound and consulted, yet the process
    is paying the boot compile storm anyway — the zero-compile-boot
    contract is broken. Two firing shapes:

    - ``compilecache.incompat`` >= ``cold_storm_incompat``: entries are
      being REJECTED (CRC mismatch from torn/corrupted files, backend
      version skew, topology drift) — every rejection is a paid compile
      that a healthy cache would have served (critical when rejections
      dominate the lookups: the cache is effectively poisoned).
    - hit rate below ``cold_storm_hit_rate`` while ``kernels.builds`` >=
      ``cold_storm_compiles``: lookups mostly miss, i.e. the dir the
      process was pointed at was populated by a different program set /
      key anatomy (wrong dir, changed labels, changed shapes).

    Quiet when no cache is bound (no ``compilecache.*`` lookups — a first
    boot against an EMPTY dir is also quiet: misses with near-zero prior
    inventory are the populate pass, not a storm)."""
    if snapshot is None:
        return
    hits = int(_ctr(snapshot, 'compilecache.hits'))
    misses = int(_ctr(snapshot, 'compilecache.misses'))
    incompat = int(_ctr(snapshot, 'compilecache.incompat'))
    lookups = hits + misses + incompat
    if lookups <= 0:
        return                      # no persistent tier in play: quiet
    compiles = int(_ctr(snapshot, 'kernels.builds'))
    entries = int((snapshot.get('gauges') or {})
                  .get('compilecache.entries', 0))
    fix = ("verify the cache dir (CRC + version skew per entry), gc "
           "stale entries, and check the process is pointed at "
           "the dir the fleet populates (PADDLE_TPU_COMPILE_CACHE, or "
           "artifact_dir= on register/fit/FleetSupervisor) — a first "
           "boot populates, every later boot must hit")
    if incompat >= int(cold_storm_incompat):
        poisoned = incompat >= max(1, lookups // 2)
        yield _diag(
            'cold_compile_storm', 'critical' if poisoned else 'warning',
            f"{incompat} cached executable(s) rejected at load "
            f"(of {lookups} lookup(s)) — corrupt bytes, CRC mismatch, or "
            "backend version skew; each rejection re-paid a compile "
            "the persistent cache exists to skip",
            fix, incompat=incompat, hits=hits, misses=misses,
            kernel_builds=compiles, cache_entries=entries)
        return
    hit_rate = hits / lookups
    # misses against a near-empty inventory are the populate pass; the
    # storm is missing against a POPULATED dir
    populated = entries > misses
    if populated and hit_rate < float(cold_storm_hit_rate) and \
            compiles >= int(cold_storm_compiles):
        yield _diag(
            'cold_compile_storm', 'warning',
            f"boot compiled {compiles} program(s) with a populated "
            f"persistent cache bound ({entries} entries): hit rate "
            f"{hit_rate:.0%} over {lookups} lookup(s) — the cached set "
            "does not match what this process compiles",
            fix, hit_rate=round(hit_rate, 4), hits=hits, misses=misses,
            kernel_builds=compiles, cache_entries=entries)


def detect_noisy_neighbor(events=None, snapshot=None, cluster=None,
                          noisy_share=NOISY_SHARE,
                          noisy_min_pressure=NOISY_MIN_PRESSURE, **_):
    """One tenant dominates the serving pressure on a shared fleet.

    Pressure = that tenant's sheds (every reason — quota, queue_full,
    page_exhaustion) + SLO violations. Sources, snapshot first (labeled
    ``serving.tenant.shed{tenant=}`` / ``serving.tenant.violations``
    counters), tenant-stamped ``serving.shed`` / ``serving.request``
    events filling what the snapshot lacks — max of the two per tenant,
    never the sum. Needs >= 2 tenants with traffic (a single-tenant
    engine owning 100% of its own sheds is ``serving_overload``'s
    business, not a neighbor problem). Victim evidence (the worst other
    tenant's violations / event-path p99) rides along when present."""
    sheds, violations, requests = {}, {}, {}
    if snapshot is not None:
        ctr = snapshot.get('counters')
        sheds.update(_labeled(ctr, 'serving.tenant.shed', key='tenant'))
        violations.update(_labeled(ctr, 'serving.tenant.violations',
                                   key='tenant'))
        requests.update(_labeled(ctr, 'serving.tenant.requests',
                                 key='tenant'))
    ev_sheds, ev_viol, ev_reqs, ev_lat = {}, {}, {}, {}
    for e in (events or []):
        ten = e.get('tenant')
        if ten is None:
            continue
        ten = str(ten)
        if e.get('ev') == 'serving.shed':
            ev_sheds[ten] = ev_sheds.get(ten, 0) + 1
        elif e.get('ev') == 'serving.request':
            ev_reqs[ten] = ev_reqs.get(ten, 0) + 1
            if e.get('status') not in (None, 'ok'):
                ev_viol[ten] = ev_viol.get(ten, 0) + 1
            if isinstance(e.get('latency_ms'), (int, float)):
                ev_lat.setdefault(ten, []).append(float(e['latency_ms']))
    for src, dst in ((ev_sheds, sheds), (ev_viol, violations),
                     (ev_reqs, requests)):
        for ten, n in src.items():
            dst[ten] = max(dst.get(ten, 0), n)
    tenants = set(requests) | set(sheds) | set(violations)
    if len(tenants) < 2:
        return
    pressure = {t: sheds.get(t, 0) + violations.get(t, 0) for t in tenants}
    total = sum(pressure.values())
    if total < noisy_min_pressure:
        return
    noisy, p = max(pressure.items(), key=lambda kv: (kv[1], kv[0]))
    share = p / total
    if share < noisy_share:
        return
    victims = {t: v for t, v in pressure.items() if t != noisy}
    victim = max(victims, key=lambda t: (victims[t],
                                         len(ev_lat.get(t, [])))) \
        if victims else None
    evidence = {'tenant': noisy, 'share': round(share, 3),
                'sheds': int(sheds.get(noisy, 0)),
                'violations': int(violations.get(noisy, 0)),
                'pressure_total': int(total),
                'per_tenant_pressure': {t: int(v) for t, v
                                        in sorted(pressure.items())}}
    detail = (f"tenant {noisy!r} accounts for {share:.0%} of the serving "
              f"pressure ({int(p)} of {int(total)} sheds+violations) on a "
              f"fleet shared by {len(tenants)} tenants")
    if victim is not None and ev_lat.get(victim):
        lat = sorted(ev_lat[victim])
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        detail += (f"; tenant {victim!r} is collateral "
                   f"(p99 {p99:.1f}ms over {len(lat)} request(s))")
        evidence['victim'] = victim
        evidence['victim_p99_ms'] = round(p99, 3)
    severity = 'critical' if share >= (1 + noisy_share) / 2 else 'warning'
    yield _diag(
        'noisy_neighbor', severity, detail,
        f"cap tenant {noisy!r}: register a TenantPolicy with a tighter "
        "token bucket (rate=/burst=) so its overflow sheds as 'quota' at "
        "the front door instead of consuming shared queue/page capacity, "
        "and drop its weight= so weighted-fair admission stops favoring "
        "it; if the tenant is legitimately hot, scale the fleet "
        "(FleetAutoscaler) instead of letting it starve its neighbors",
        **evidence)


def detect_autoscale_flap(events=None, snapshot=None, cluster=None,
                          flap_reversals=FLAP_REVERSALS,
                          flap_window_cooldowns=FLAP_WINDOW_COOLDOWNS,
                          **_):
    """The replica count is oscillating: ``fleet.autoscale`` grow/shrink
    actions keep reversing direction within a few cooldown windows. A
    correctly configured autoscaler cannot do this — the hysteresis band
    means one signal value never justifies both directions, and the
    cooldown + fresh-sustain window spaces opposing actions out — so
    firing means the band is degenerate (burn_low ~ burn_high), cooldown
    is ~0, the pressure signal itself whipsaws across both thresholds
    slower than the window (undersized sustain_ticks), or two
    controllers are fighting (e.g. an autoscaler shrinking replicas a
    supervisor keeps resurrecting). Counter fallback: both
    ``fleet.autoscale.grows`` and ``.shrinks`` high with no event
    timeline still warns."""
    acts = []
    for e in (events or []):
        if e.get('ev') == 'fleet.autoscale' and \
                e.get('action') in ('grow', 'shrink'):
            acts.append((e['action'], int(e.get('tick', 0)),
                         int(e.get('cooldown_ticks', 0))))
    reversals = 0
    pairs = []
    for (a1, t1, _c1), (a2, t2, c2) in zip(acts, acts[1:]):
        window = max(1, c2) * flap_window_cooldowns
        if a1 != a2 and (t2 - t1) <= window:
            reversals += 1
            pairs.append({'from': a1, 'to': a2, 'tick_gap': t2 - t1,
                          'window': window})
    if reversals >= flap_reversals:
        severity = 'critical' if reversals >= 2 * flap_reversals \
            else 'warning'
        yield _diag(
            'autoscale_flap', severity,
            f"the fleet reversed scaling direction {reversals} time(s) "
            f"within {flap_window_cooldowns} cooldown window(s) "
            f"({len(acts)} grow/shrink action(s) total) — capacity is "
            "oscillating, every cycle paying replica boot + drain for "
            "nothing",
            "widen the autoscaler's hysteresis band (burn_low well below "
            "burn_high), raise cooldown_ticks and sustain_ticks so one "
            "noisy burst cannot justify an action, and check nothing "
            "else is mutating the same fleet (a FleetSupervisor "
            "resurrecting replicas the autoscaler drains, or two "
            "autoscalers on one router)",
            reversals=reversals, actions=len(acts),
            recent_reversals=pairs[-3:])
        return
    if not acts and snapshot is not None:
        grows = _ctr(snapshot, 'fleet.autoscale.grows')
        shrinks = _ctr(snapshot, 'fleet.autoscale.shrinks')
        if min(grows, shrinks) >= flap_reversals:
            yield _diag(
                'autoscale_flap', 'warning',
                f"{int(grows)} grow(s) and {int(shrinks)} shrink(s) in "
                "one window with no event timeline to order them — the "
                "fleet is likely oscillating",
                "enable the event log for the timeline, then widen the "
                "autoscaler's hysteresis band / raise cooldown_ticks "
                "(see the fleet.autoscale events for which signal "
                "crossings drove each action)",
                grows=int(grows), shrinks=int(shrinks))


DETECTORS = {
    'straggler': detect_straggler,
    'retrace_storm': detect_retrace_storm,
    'input_bound': detect_input_bound,
    'serving_overload': detect_serving_overload,
    'kv_page_exhaustion': detect_kv_page_exhaustion,
    'rank_flatline': detect_rank_flatline,
    'memory_pressure': detect_memory_pressure,
    'slo_burn': detect_slo_burn,
    'checkpoint_stall': detect_checkpoint_stall,
    'elastic_downsize': detect_elastic_downsize,
    'replica_flapping': detect_replica_flapping,
    'retry_storm': detect_retry_storm,
    'noisy_neighbor': detect_noisy_neighbor,
    'autoscale_flap': detect_autoscale_flap,
    'cold_compile_storm': detect_cold_compile_storm,
    'lint_debt': detect_lint_debt,
    'page_leak': detect_page_leak,
    'latency_creep': detect_latency_creep,
    'qps_collapse': detect_qps_collapse,
    'compile_creep': detect_compile_creep,
    'perf_regression': detect_perf_regression,
}


def diagnose(events=None, snapshot=None, cluster=None, **cfg):
    """Run every detector; return diagnoses ranked most-severe first."""
    out = []
    for name, det in DETECTORS.items():
        try:
            out.extend(det(events=events, snapshot=snapshot,
                           cluster=cluster, **cfg) or [])
        except Exception as e:   # one broken detector must not mute the rest
            out.append(_diag('doctor_error', 'info',
                             f"detector {name} failed: {e!r}",
                             'report this as a paddle_tpu_torch bug',
                             detector=name))
    out.sort(key=lambda d: (SEVERITY_ORDER.get(d['severity'], 9),
                            d['cause']))
    return out


def run_doctor(events=None, snapshot=None, cluster=None, emit=False, **cfg):
    """``diagnose`` + (optionally) land each diagnosis as a structured
    ``diagnosis`` event on the step-event log (requires the package;
    ``emit=True`` from a path-loaded standalone module is a no-op)."""
    diagnoses = diagnose(events=events, snapshot=snapshot, cluster=cluster,
                         **cfg)
    if emit and diagnoses and __package__:
        from . import events as _events
        for d in diagnoses:
            _events.emit('diagnosis', cause=d['cause'],
                         severity=d['severity'], detail=d['detail'],
                         fix=d['fix'], **{
                             k: v for k, v in d['evidence'].items()
                             if isinstance(v, (int, float, str))})
    return diagnoses


def render_report(diagnoses):
    """Operator-facing ranked text report."""
    if not diagnoses:
        return 'doctor: no anomalies detected'
    lines = [f"doctor: {len(diagnoses)} finding(s), most severe first"]
    for i, d in enumerate(diagnoses, 1):
        lines.append(f"{i}. [{d['severity'].upper():8s}] {d['cause']}: "
                     f"{d['detail']}")
        lines.append(f"   fix: {d['fix']}")
    return '\n'.join(lines)
