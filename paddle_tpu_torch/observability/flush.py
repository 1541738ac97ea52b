"""Per-rank telemetry flusher: the rank side of mission control. The port's
own copy of ``paddle_tpu/observability/flush.py``.

Each process with ``PADDLE_TPU_TELEMETRY_RUN_DIR`` set (or a
``start_rank_flusher(run_dir)`` call; the spawn workers of the
reference's ``distributed.launch`` come with ``distributed/``) runs one
``RankFlusher``: a daemon thread that every ``flush_every`` seconds writes
the process's telemetry — metrics snapshot + interposed-counter summary,
the step-event buffer, and the span buffer — to per-rank files in the
supervisor's run dir:

- ``telemetry_rank<R>.json``   {rank, pid, host, ts, metrics, counters,
                               costs}
- ``events_rank<R>.jsonl``     the JSONL event log (rank-stamped)
- ``trace_rank<R>.json``       Chrome trace events for this rank
- ``timeseries_rank<R>.json``  the ring sampler's delta-encoded time
                               series (written only once samples exist)

The supervisor-side ``aggregate`` module merges these into one cluster
snapshot and a single Perfetto trace with one lane per rank. Files are
staged-then-renamed so a reader (the aggregator polls while ranks run)
never sees a torn JSON document; events are appended-rewritten from the
bounded in-memory buffer, so a crashed rank leaves its last flush behind —
that tail is exactly what the doctor needs.

Stdlib-only.
"""
import json
import os
import socket
import threading

from . import costs, events, interpose, registry, spans, state, timeseries
from .state import rank_id

__all__ = ['RankFlusher', 'start_rank_flusher', 'stop_rank_flusher',
           'active_flusher', 'rank_id']

_lock = threading.Lock()
_active = [None]


class RankFlusher:
    """Periodically export this process's telemetry to per-rank files.

    ``flush_now()`` is safe to call from any thread at any time (the last
    writer wins — each file is a complete document, committed by rename).
    """

    def __init__(self, run_dir, rank=None, interval=None):
        self.run_dir = os.fspath(run_dir)
        self.rank = rank_id() if rank is None else int(rank)
        self.interval = (state.flush_every() if interval is None
                         else float(interval))
        self.host = socket.gethostname()
        self._stop = threading.Event()
        self._thread = None
        # flush_now() is public and the flusher thread calls it too: the
        # lock serializes whole flushes (two writers in one process would
        # collide on the same pid-suffixed staging file) and guards the
        # flushes counter
        self._flush_lock = threading.Lock()
        self.flushes = 0

    # -- file layout (shared with aggregate.py) -------------------------
    @property
    def metrics_path(self):
        return os.path.join(self.run_dir, f'telemetry_rank{self.rank}.json')

    @property
    def events_path(self):
        return os.path.join(self.run_dir, f'events_rank{self.rank}.jsonl')

    @property
    def trace_path(self):
        return os.path.join(self.run_dir, f'trace_rank{self.rank}.json')

    @property
    def timeseries_path(self):
        return os.path.join(self.run_dir,
                            f'timeseries_rank{self.rank}.json')

    def _commit(self, path, text):
        """Whole-document write, committed by rename so the aggregator's
        concurrent read never sees a torn file."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, 'w', encoding='utf-8') as f:   # atomic-ok: staged
            f.write(text)                             # then os.replace'd
        os.replace(tmp, path)

    def flush_now(self):
        """Write all three per-rank files from the current buffers."""
        with self._flush_lock:
            os.makedirs(self.run_dir, exist_ok=True)
            head = {
                'rank': self.rank,
                'pid': os.getpid(),
                'host': self.host,
                'ts': round(events.wall_ts(), 6),
                'metrics': registry.snapshot(),
                'counters': interpose.summary(),
                'costs': costs.summary(),
            }
            try:
                self._commit(self.metrics_path,
                             json.dumps(head, sort_keys=True, default=repr))
                evs = events.events()
                self._commit(self.events_path, ''.join(
                    json.dumps(dict(rec, rank=self.rank), sort_keys=True,
                               default=repr) + '\n' for rec in evs))
                self._commit(self.trace_path,
                             json.dumps(spans.trace_events()))
                ts_doc = timeseries.export_active()
                if ts_doc is not None:
                    ts_doc['rank'] = self.rank
                    self._commit(self.timeseries_path,
                                 json.dumps(ts_doc, sort_keys=True))
            except OSError:
                return False  # run dir vanished (supervisor cleanup): benign
            self.flushes += 1
            return True

    def _run(self):
        while not self._stop.wait(self.interval):
            if state.enabled():
                self.flush_now()

    def start(self):
        if self._thread is None:
            if state.enabled():
                self.flush_now()
            self._thread = threading.Thread(
                target=self._run, name='paddle-tpu-torch-telemetry-flush',
                daemon=True)
            self._thread.start()
        return self

    def stop(self, final_flush=True):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(max(self.interval * 4, 2.0))
            self._thread = None
        if final_flush and state.enabled():
            self.flush_now()


def start_rank_flusher(run_dir=None, rank=None):
    """Start (or return) the process-wide flusher. ``run_dir`` defaults to
    the cluster run dir from the environment
    (``PADDLE_TPU_TELEMETRY_RUN_DIR``); returns None when there is none
    (not a cluster run) or telemetry is disabled."""
    if not state.enabled():
        return None
    run_dir = run_dir or state.run_dir()
    if not run_dir:
        return None
    with _lock:
        fl = _active[0]
        if fl is not None and fl.run_dir == os.fspath(run_dir):
            return fl
        if fl is not None:
            fl.stop(final_flush=False)
        fl = RankFlusher(run_dir, rank=rank).start()
        _active[0] = fl
    # the time-series ring rides the flusher: every supervised rank samples
    # at cadence so the aggregator gets timelines, not just the last frame
    timeseries.start_sampler()
    return fl


def stop_rank_flusher(final_flush=True):
    with _lock:
        fl, _active[0] = _active[0], None
    if fl is not None:
        # take one last sample so the final flush carries the run's tail,
        # then park the cadence thread (the ring keeps its samples)
        sm = timeseries.active_sampler()
        if sm is not None and final_flush:
            sm.sample_now()
        timeseries.stop_sampler()
        fl.stop(final_flush=final_flush)


def active_flusher():
    return _active[0]
