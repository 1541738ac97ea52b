"""Launching ranks. Counterpart of ``paddle_tpu/distributed/launch.py``
(``spawn``, ``launch``, ``RankFailedError``, the ``_Supervisor``).

The reference drives every local chip from one process, so its
multi-process mode is a CPU model of the one-process-a-GPU launcher. The
port IS that model: a rank is a process.

- ``spawn(func, args, nprocs)`` starts ``nprocs`` fresh interpreters, each
  with the trainer environment (``PADDLE_TRAINER_ID`` /
  ``PADDLE_TRAINERS_NUM`` / ``PADDLE_CURRENT_ENDPOINT``), runs
  ``func(*args)`` in each and returns their results in rank order.
  ``func`` joins the process group with ``init_parallel_env()``, which
  rendezvouses through a ``file://`` store in the spawn's run dir (no TCP
  port: parallel jobs on one machine never race for one), on ``spawn``'s
  ``backend`` (None: NCCL for CUDA tensors and gloo for CPU ones;
  ``'gloo'``; ``'cpu'`` is gloo). A child finds the kernels the parent
  built (the library named by its sources' digest) and never runs nvcc
  again. ``nprocs`` of 1 (or -1, 0) without a backend runs ``func`` in
  this process, after joining a group of one, as the reference's
  in-process path does.
- ``launch`` (``python -m paddle_tpu_torch.distributed.launch
  --nproc_per_node N script.py ...``) runs a script once a rank under the
  same environment; its ranks rendezvous through ``MASTER_ADDR`` /
  ``MASTER_PORT`` when set, else a ``file://`` store in the run dir.

Both run under a SUPERVISOR: children heartbeat into the run dir, the
parent polls them, the first non-zero exit kills the surviving siblings
(``_kill_tree``: SIGTERM, then SIGKILL; one dead rank must not deadlock
the rest, whose next collective would wait for it forever), and the
failure surfaces as ``RankFailedError`` with the rank, the exit code or
signal, the heartbeat's age and the tail of the rank's stderr log. A rank
that dies before its started marker (before any collective could have
run) is restarted, up to ``max_restarts``. With ``elastic=True`` a started
rank's death re-forms the world with the survivors (one rank smaller, or
the same size when a ``rejoin_<rank>`` marker claims the slot) and
relaunches every rank, which resumes from the latest committed checkpoint
(``engine.fit(resume_from=)``). ``join(timeout=)`` bounds the whole wait
and kills the tree on expiry.

With telemetry on (``PADDLE_TPU_TELEMETRY=1``) each supervised rank
streams its telemetry into the run dir (its ``RankFlusher``), and the
supervisor merges the files at join (``finish_telemetry``:
``observability.aggregate``) and runs the anomaly doctor over them, its
``straggler`` detector included (``diagnoses.json``).
"""
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time

from . import env

__all__ = ['spawn', 'launch', 'get_cluster_and_pod', 'RankFailedError']

# the directory that holds the package: spawned workers import it from
# there whatever their working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_HB_INTERVAL = 0.25     # worker heartbeat period (seconds)
_POLL_TICK = 0.1        # supervisor poll period (seconds)
_KILL_GRACE = 1.5       # SIGTERM → SIGKILL escalation window (seconds)
_LOG_TAIL_BYTES = 2048


class RankFailedError(RuntimeError):
    """One rank of a supervised multi-process job failed; its siblings were
    terminated (fail-fast). Attributes: ``rank``, ``exitcode``,
    ``signal_name`` (when killed by a signal), ``heartbeat_age`` (seconds,
    or None), ``log_tail`` (rank stderr tail, possibly ''), ``statuses``
    (per-rank exit code map at the time of failure)."""

    def __init__(self, rank, exitcode, signal_name=None, heartbeat_age=None,
                 log_tail='', statuses=None, detail=None):
        self.rank = rank
        self.exitcode = exitcode
        self.signal_name = signal_name
        self.heartbeat_age = heartbeat_age
        self.log_tail = log_tail or ''
        self.statuses = dict(statuses or {})
        died = (f"killed by {signal_name}" if signal_name
                else f"exit code {exitcode}")
        hb = ("no heartbeat ever written" if heartbeat_age is None
              else f"last heartbeat {heartbeat_age:.1f}s before death")
        msg = (f"spawn: rank {rank} failed ({died}; {hb}); "
               "surviving ranks were terminated (fail-fast)")
        if detail:
            msg += f": {detail}"
        if self.statuses:
            msg += f"; per-rank exit codes: {self.statuses}"
        if self.log_tail:
            msg += f"\n--- rank {rank} log tail ---\n{self.log_tail}"
        super().__init__(msg)


def _signal_name(exitcode):
    """'SIGKILL' for exitcode -9, None for normal exits."""
    if exitcode is None or exitcode >= 0:
        return None
    try:
        return signal.Signals(-exitcode).name
    except ValueError:
        return f"signal {-exitcode}"


def _log_tail(path, nbytes=_LOG_TAIL_BYTES):
    try:
        with open(path, 'rb') as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - nbytes, 0))
            return f.read().decode('utf-8', 'replace').strip()
    except OSError:
        return ''


def _rank_env(rank, nprocs):
    """The reference trainer env for one rank (shared by _worker, spawn's
    parent loop, and launch)."""
    return {'PADDLE_TRAINER_ID': str(rank),
            'PADDLE_TRAINERS_NUM': str(nprocs),
            'PADDLE_CURRENT_ENDPOINT': f"127.0.0.1:{6170 + rank}"}


def _maybe_inject_boot_failure(rank, result_dir):
    """Chaos hook (resilience.faultinject.boot_fail): die with exit 43
    BEFORE the started marker, at most ``times`` times per run dir — models
    the transient bootstrap crash (port clash, half-ready filesystem) that
    bounded restart exists for."""
    arm = os.environ.get('PADDLE_TPU_FI_BOOT_FAIL', '')
    if not arm:
        return
    try:
        want_rank, times = (int(x) for x in arm.split(':'))
    except ValueError:
        return
    if rank != want_rank:
        return
    counter = os.path.join(result_dir, f'bootfail_{rank}')
    fired = 0
    if os.path.exists(counter):
        with open(counter) as f:
            fired = len(f.read().splitlines())
    if fired < times:
        with open(counter, 'a') as f:   # atomic-ok: chaos counter, append
            f.write('x\n')
        os._exit(43)


def _worker(rank, nprocs, func, args, result_dir, backend=None):
    # an elastic relaunch respawns with a SMALLER world than the payload
    # recorded: the supervisor's env (set per generation) wins
    nprocs = int(os.environ.get('PADDLE_TRAINERS_NUM') or nprocs)
    os.environ.update(_rank_env(rank, nprocs))
    os.environ['FLAGS_selected_gpus'] = str(rank)
    env._global['backend'] = backend
    path = os.path.join(result_dir, f"result_{rank}.pkl")
    _maybe_inject_boot_failure(rank, result_dir)
    # liveness + phase markers for the supervisor: heartbeats let it tell a
    # busy rank from a wedged one; the started marker bounds restart
    # eligibility (a rank that reached func may have joined collectives —
    # restarting it alone would wedge its peers)
    from ..resilience.watchdog import Heartbeat
    hb = Heartbeat(os.path.join(result_dir, f'hb_{rank}'),
                   interval=_HB_INTERVAL).start()
    with open(os.path.join(result_dir, f'started_{rank}'), 'w'):
        pass   # atomic-ok: zero-byte phase marker, existence is the datum
    # mission control: stream this rank's telemetry into the run dir so the
    # supervisor can aggregate it (no-op unless PADDLE_TPU_TELEMETRY=1).
    # The flight recorder's crash hooks are ALWAYS on: a SIGTERM'd or
    # crashing rank leaves flight_rank<R>.json in the run dir either way.
    from .. import observability as _obs
    _obs.flight.install_crash_hooks()
    if _obs.enabled():
        _obs.start_rank_flusher(rank=rank)
    # results travel via files (atomic commit), not an mp.Queue — queue FDs
    # are unreliable under sandboxed/spawn-restricted environments; the
    # parent trusts these bytes, so they go through atomic_io (graftlint
    # GL010), which adds the fsync the old hand-rolled tmp+replace lacked
    from ..resilience.atomic_io import atomic_pickle_dump
    try:
        result = func(*args)
        payload = ('ok', result)
    except BaseException as e:  # surface the failure to the parent
        atomic_pickle_dump(('error', repr(e)), path)
        # black box: dump the ring next to the heartbeat files so the
        # supervisor-side post-mortem has this rank's last seconds
        _obs.flight.dump('worker_exception', exc=e,
                         extra={'rank': rank}, run_dir=result_dir)
        raise
    finally:
        hb.stop()
        if _obs.enabled():
            # final flush: the aggregator must see the whole run, and a
            # crashed rank's last periodic flush is its black box
            _obs.stop_rank_flusher()
    atomic_pickle_dump(payload, path)


class _Proc:
    """Popen with the slice of the multiprocessing.Process API _Context
    uses (join/is_alive/exitcode/terminate)."""

    def __init__(self, popen):
        self._p = popen
        self.pid = popen.pid

    def join(self, timeout=None):
        from ..resilience.watchdog import wait_proc
        wait_proc(self._p, timeout)

    def is_alive(self):
        return self._p.poll() is None

    @property
    def exitcode(self):
        return self._p.poll()

    def terminate(self):
        self._p.terminate()

    def kill(self):
        self._p.kill()


def _worker_main(payload_path, rank):
    """Entry point of one spawned worker interpreter (`python -m
    paddle_tpu_torch.distributed._spawn_entry <payload_path> <rank>`)."""
    with open(payload_path, 'rb') as f:
        payload = pickle.load(f)
    # the parent's import roots (pytest test dirs, script dirs) must be
    # visible before the function is unpickled by module+qualname — and in
    # the parent's ORDER, so a local dir that shadows an installed package
    # in the parent shadows it here too
    sys.path[:0] = [p for p in payload['sys_path'] if p not in sys.path]
    if payload['main_path']:
        # the parent's __main__ was a plain script: load that file into this
        # process's __main__ namespace so pickle-by-name resolves func AND
        # any classes the script defined (the contract multiprocessing's
        # spawn start method implements). run_name keeps the script's
        # `if __name__ == '__main__'` guard false; registering the module
        # under the run_name makes objects the script's classes produce
        # picklable back to the parent.
        import runpy
        import types
        ns = runpy.run_path(payload['main_path'], run_name='__spawn_main__')
        mod = types.ModuleType('__spawn_main__')
        mod.__dict__.update(ns)
        sys.modules['__spawn_main__'] = mod
        sys.modules['__main__'].__dict__.update(
            {k: v for k, v in ns.items() if not k.startswith('__')})
    elif payload.get('main_name'):
        # parent ran as `python -m <mod>`: import the module by name and
        # project its namespace into __main__ for pickle-by-name
        import importlib
        mod = importlib.import_module(payload['main_name'])
        sys.modules['__main__'].__dict__.update(
            {k: v for k, v in mod.__dict__.items()
             if not k.startswith('__')})
    func, args = pickle.loads(payload['func_bytes'])
    try:
        _worker(rank, payload['nprocs'], func, args, payload['result_dir'],
                payload.get('backend'))
    finally:
        # a rank leaves its process group before the interpreter exits
        env.shutdown()


_daemon_procs = set()


def _kill_daemon_procs():
    for proc in list(_daemon_procs):
        if proc.is_alive():
            proc.terminate()


import atexit as _atexit  # noqa: E402
_atexit.register(_kill_daemon_procs)


class _SpawnMainUnpickler(pickle.Unpickler):
    """Resolve worker-side '__spawn_main__' classes (defined by the parent's
    entry script, re-executed in the worker under that run name) back to the
    parent's own __main__ when results return."""

    def find_class(self, module, name):
        if module == '__spawn_main__' and '__spawn_main__' not in sys.modules:
            module = '__main__'
        return super().find_class(module, name)


def _kill_tree(procs, grace=_KILL_GRACE):
    """Fail-fast teardown: SIGTERM every live proc, escalate to SIGKILL
    after ``grace`` seconds."""
    live = [p for p in procs if p.is_alive()]
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.monotonic() + grace
    while any(p.is_alive() for p in live) and time.monotonic() < deadline:
        time.sleep(_POLL_TICK / 2)
    for p in live:
        if p.is_alive():
            try:
                p.kill()
            except OSError:
                pass


class _Supervisor:
    """Concurrent monitor over one multi-process run.

    Polls every rank, restarts boot-phase failures up to ``max_restarts``
    (total across ranks), and on any other non-zero exit kills the
    surviving siblings and raises ``RankFailedError`` with per-rank
    diagnostics. Used by both spawn's ``_Context.join`` and the
    ``launch()`` CLI.

    With ``elastic=True`` (``spawn(elastic=True)`` / ``--elastic`` /
    ``PADDLE_TPU_ELASTIC=1``) a
    STARTED rank's death no longer fail-fasts the job: the supervisor
    kills the stragglers (their collectives would wedge on the dead
    peer), waits ``rejoin_grace_s`` for a replacement to volunteer for
    the dead slot (a ``rejoin_<rank>`` file in the run dir), re-forms the
    world with the survivors (same size on rejoin, one smaller on
    downsize), and relaunches every rank of the new generation — whose
    training function is expected to resume from the latest committed
    sharded checkpoint (``engine.fit(resume_from=...)``). Bounded by the
    same ``max_restarts`` budget (default 3 when elastic); every
    transition lands as telemetry events + counters + a flight-recorder
    dump, and death→all-ranks-restarted is recorded on the
    ``elastic.recovery_ms`` histogram."""

    def __init__(self, procs, run_dir, respawn=None, max_restarts=0,
                 elastic=False, rejoin_grace_s=None):
        self.procs = list(procs)            # rank -> _Proc-like
        self.run_dir = run_dir
        self.respawn = respawn              # (rank, world, gen) -> new proc
        self.elastic = bool(elastic)
        if rejoin_grace_s is None:
            rejoin_grace_s = float(os.environ.get(
                'PADDLE_TPU_ELASTIC_REJOIN_GRACE', '0') or 0)
        self.rejoin_grace_s = float(rejoin_grace_s)
        if self.elastic and not max_restarts:
            max_restarts = 3
        self.max_restarts = int(max_restarts)
        self.restarts_used = 0
        self.generation = 0
        self.downsizes = 0
        self.dead_ranks = []                # (generation, rank, exitcode)

    def _rank_started(self, rank):
        return os.path.exists(
            os.path.join(self.run_dir, f'started_{rank}'))

    def _statuses(self):
        return {r: p.exitcode for r, p in enumerate(self.procs)}

    def _diagnose(self, rank, killed_by_us=()):
        p = self.procs[rank]
        from ..resilience.watchdog import heartbeat_age
        detail = None
        result_path = os.path.join(self.run_dir, f"result_{rank}.pkl")
        if os.path.exists(result_path):
            try:
                with open(result_path, 'rb') as f:
                    status, payload = _SpawnMainUnpickler(f).load()
                if status == 'error':
                    detail = payload
            except Exception:
                pass
        statuses = {r: c for r, c in self._statuses().items()
                    if r not in killed_by_us}
        return RankFailedError(
            rank, p.exitcode,
            signal_name=_signal_name(p.exitcode),
            heartbeat_age=heartbeat_age(
                os.path.join(self.run_dir, f'hb_{rank}')),
            log_tail=_log_tail(os.path.join(self.run_dir,
                                            f'rank_{rank}.log')),
            statuses=statuses, detail=detail)

    def _try_restart(self, rank):
        """Restart a boot-phase failure. True when a replacement is
        running."""
        if (self.respawn is None or self.restarts_used >= self.max_restarts
                or self._rank_started(rank)):
            return False
        self.restarts_used += 1
        stale = os.path.join(self.run_dir, f"result_{rank}.pkl")
        if os.path.exists(stale):
            os.unlink(stale)
        old = self.procs[rank]
        _daemon_procs.discard(old)
        # respawn into the CURRENT generation's world: after an elastic
        # downsize the replacement must not come up believing the old
        # (larger) world size or the dead generation's tag
        self.procs[rank] = self.respawn(rank, world=len(self.procs),
                                        generation=self.generation)
        from .. import observability as _obs
        if _obs.enabled():
            _obs.counter('distributed.rank_restarts').inc()
            _obs.event('rank_restart', rank=rank,
                       restarts_used=self.restarts_used)
        return True

    def _clear_rank_state(self, world):
        """Remove the dead generation's per-rank run-dir artifacts so the
        relaunch starts clean: stale results must not satisfy join(),
        stale started markers must not disable boot-restart, and stale
        heartbeats must not read as live ranks."""
        for r in range(world):
            for name in (f'result_{r}.pkl', f'started_{r}', f'hb_{r}'):
                try:
                    os.unlink(os.path.join(self.run_dir, name))
                except OSError:
                    pass

    def _wait_rejoin(self, dead_ranks, grace=None):
        """Grace window for replacements: a ``rejoin_<rank>`` (or
        ``rejoin_any``) file dropped into the run dir within
        ``rejoin_grace_s`` seconds re-claims a dead slot, so the new
        generation keeps the old world size instead of downsizing."""
        if not dead_ranks:
            return []
        if grace is None:
            grace = self.rejoin_grace_s
        deadline = time.monotonic() + max(float(grace), 0.0)
        rejoined = []
        pending = list(dead_ranks)
        while True:
            # at least one scan even with a zero budget: an offer armed
            # BEFORE the death (a standby replacement) is always honored
            for r in list(pending):
                for name in (f'rejoin_{r}', 'rejoin_any'):
                    p = os.path.join(self.run_dir, name)
                    if os.path.exists(p):
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
                        pending.remove(r)
                        rejoined.append(r)
                        break
            if not pending or time.monotonic() >= deadline:
                return rejoined
            time.sleep(_POLL_TICK)

    def _elastic_restart(self, rank, code, deadline=None):
        """Survive a started rank's death: downsize (or rejoin) + relaunch.
        True when a new generation is running; False when the budget is
        exhausted / the world cannot shrink further (caller fail-fasts).
        ``deadline`` (monotonic, from ``join(timeout=)``) caps both the
        rejoin grace and the started-marker wait — a bounded join must
        not sit out a minutes-long recovery."""
        from .. import observability as _obs
        if (not self.elastic or self.respawn is None
                or self.restarts_used >= self.max_restarts):
            return False

        def budget(want):
            if deadline is None:
                return want
            return max(min(want, deadline - time.monotonic()), 0.0)
        world = len(self.procs)
        err = self._diagnose(rank, killed_by_us=[r for r in range(world)
                                                 if r != rank])
        sw_recovery = time.monotonic()
        self.dead_ranks.append((self.generation, rank, code))
        if _obs.enabled():
            _obs.counter('distributed.rank_failures').inc()
            _obs.event('elastic.rank_death', rank=rank, exitcode=code,
                       signal=err.signal_name, generation=self.generation,
                       world=world)
        # stragglers first: their next collective would wedge on the dead
        # peer, and a half-dead generation must never overlap the next one
        _kill_tree(self.procs)
        rejoined = self._wait_rejoin([rank],
                                     grace=budget(self.rejoin_grace_s))
        new_world = world if rejoined else world - 1
        if new_world < 1:
            return False
        self.restarts_used += 1
        self.generation += 1
        self._clear_rank_state(world)
        ev = 'elastic.rejoin' if rejoined else 'elastic.downsize'
        if not rejoined:
            self.downsizes += 1
        if _obs.enabled():
            _obs.counter('distributed.elastic_restarts').inc()
            if not rejoined:
                _obs.counter('distributed.elastic_downsizes').inc()
            _obs.event(ev, dead_rank=rank, old_world=world,
                       new_world=new_world, generation=self.generation,
                       exitcode=code, signal=err.signal_name,
                       restarts_used=self.restarts_used)
        # always-on black box: what the supervisor saw at the transition
        _obs.flight.dump(
            ev.replace('.', '_'), exc=err,
            extra={'dead_rank': rank, 'old_world': world,
                   'new_world': new_world, 'generation': self.generation},
            filename='flight_supervisor.json', run_dir=self.telemetry_dir())
        self.procs = [self.respawn(r, world=new_world,
                                   generation=self.generation)
                      for r in range(new_world)]
        # recovery ends when every rank of the new generation reaches its
        # started marker (mesh re-formed, checkpoint restored) — bounded
        # (and capped by the caller's join deadline): a generation that
        # cannot even boot shows up as its own failure
        boot_deadline = time.monotonic() + budget(60.0)
        while time.monotonic() < boot_deadline:
            if all(self._rank_started(r) for r in range(new_world)):
                break
            if any(p.exitcode not in (None, 0) for p in self.procs):
                break
            time.sleep(_POLL_TICK)
        recovery_ms = (time.monotonic() - sw_recovery) * 1000.0
        if _obs.enabled():
            _obs.histogram('elastic.recovery_ms').observe(recovery_ms)
            _obs.event('elastic.relaunch', generation=self.generation,
                       world=new_world,
                       recovery_ms=round(recovery_ms, 3))
        return True

    def telemetry_dir(self):
        """Where this run's per-rank telemetry files live (the explicit
        override, else the run dir the ranks heartbeat into)."""
        return (os.environ.get('PADDLE_TPU_TELEMETRY_RUN_DIR')
                or self.run_dir)

    def finish_telemetry(self):
        """Mission control at join: merge the per-rank telemetry files into
        cluster_snapshot.json / merged_events.jsonl / merged_trace.json
        (one Perfetto lane per rank), run the anomaly doctor over the
        merged stream, land each finding as a ``diagnosis`` event in the
        supervisor's event log, and write the ranked ``diagnoses.json``.
        Best-effort by contract: telemetry must never fail a run."""
        from .. import observability as _obs
        if not _obs.enabled():
            return None
        tdir = self.telemetry_dir()
        try:
            paths = _obs.aggregate.write_merged(tdir)
            if paths is None:
                return None
            snap = _obs.aggregate.cluster_snapshot(tdir)
            diagnoses = _obs.run_doctor(
                events=_obs.aggregate.merged_events(tdir),
                cluster=snap, emit=True)
            report = os.path.join(tdir, 'diagnoses.json')
            tmp = f"{report}.tmp.{os.getpid()}"
            with open(tmp, 'w', encoding='utf-8') as f:
                json.dump(diagnoses, f, sort_keys=True, indent=1,
                          default=repr)
            os.replace(tmp, report)
            paths['diagnoses'] = report
            return paths
        except Exception:
            return None

    def wait(self, timeout=None):
        """Supervise until every rank exits 0 (returns), one fails
        (``RankFailedError``), or ``timeout`` expires (stragglers are
        terminated and a RuntimeError reports per-rank exit codes). With
        telemetry on, per-rank files are merged + diagnosed at exit (every
        path: the post-mortem matters most when a rank just died), and a
        live /metrics endpoint is exported while ranks run when
        ``PADDLE_TPU_TELEMETRY_HTTP`` is set."""
        from .. import observability as _obs
        if _obs.enabled():
            _obs.endpoint.maybe_start_from_env(run_dir=self.telemetry_dir())
        try:
            self._wait(timeout)
        finally:
            self.finish_telemetry()

    def _wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            running = False
            restarted = False
            for rank, p in enumerate(self.procs):
                code = p.exitcode
                if code is None:
                    running = True
                elif code != 0:
                    if self._try_restart(rank):
                        running = True
                        continue
                    if self._elastic_restart(rank, code,
                                             deadline=deadline):
                        # a new (possibly smaller) generation is running;
                        # self.procs changed under us — restart the scan
                        running = True
                        restarted = True
                        break
                    survivors = [r for r, q in enumerate(self.procs)
                                 if q.is_alive()]
                    err = self._diagnose(rank, killed_by_us=survivors)
                    _kill_tree(self.procs)
                    from .. import observability as _obs
                    if _obs.enabled():
                        _obs.counter('distributed.rank_failures').inc()
                        _obs.event('rank_failed', rank=rank, exitcode=code,
                                   signal=err.signal_name)
                    # supervisor-side black box (always-on): the failed
                    # rank's own dump lives in the run dir; this one
                    # records what the supervisor saw — under its OWN
                    # name (the supervisor has no PADDLE_TRAINER_ID, so
                    # the default flight_rank0.json would masquerade as,
                    # and could clobber, rank 0's real dump)
                    # run_dir explicitly: the run-dir env vars are only
                    # set for the CHILDREN, so the default would land
                    # this in the global telemetry dir instead of next
                    # to the ranks' own dumps
                    _obs.flight.dump('rank_failed', exc=err,
                                     extra={'failed_rank': rank,
                                            'exitcode': code},
                                     filename='flight_supervisor.json',
                                     run_dir=self.telemetry_dir())
                    raise err
            if restarted:
                continue
            if not running:
                return
            if deadline is not None and time.monotonic() >= deadline:
                statuses = self._statuses()
                stragglers = [r for r, c in statuses.items() if c is None]
                _kill_tree(self.procs)
                raise RuntimeError(
                    f"spawn: ranks {stragglers} still running after "
                    f"join(timeout={timeout}); they were terminated. "
                    f"Per-rank exit codes before termination: {statuses} "
                    "(None = still running)")
            time.sleep(_POLL_TICK)


class _Context:
    def __init__(self, procs, result_dir, result=None, respawn=None,
                 max_restarts=0, elastic=False, rejoin_grace_s=None):
        self.processes = procs
        self._result_dir = result_dir
        self._result = result
        self._joined = None
        self._supervisor = None if not procs else _Supervisor(
            procs, result_dir, respawn=respawn, max_restarts=max_restarts,
            elastic=elastic, rejoin_grace_s=rejoin_grace_s)

    def join(self, timeout=None):
        if not self.processes:
            return self._result
        if self._joined is not None:
            # spawn(join=True) already joined internally; the caller's own
            # join() must see the same results (the files are consumed and
            # the tempdir removed on the first pass)
            return self._joined
        try:
            self._supervisor.wait(timeout=timeout)
        finally:
            # supervision may have replaced restarted ranks' proc objects
            self.processes = self._supervisor.procs
        for p in self.processes:
            _daemon_procs.discard(p)
        results = {}
        err = None
        for rank in range(len(self.processes)):
            path = os.path.join(self._result_dir, f"result_{rank}.pkl")
            if not os.path.exists(path):
                continue
            with open(path, 'rb') as f:
                status, payload = _SpawnMainUnpickler(f).load()
            if status == 'error' and err is None:
                err = f"spawn: rank {rank} failed: {payload}"
            results[rank] = payload if status == 'ok' else None
        import shutil
        shutil.rmtree(self._result_dir, ignore_errors=True)
        if err:
            raise RuntimeError(err)
        bad = [p.exitcode for p in self.processes if p.exitcode]
        if bad:
            raise RuntimeError(f"spawn: worker exit codes {bad}")
        self._joined = [results.get(r) for r in range(len(self.processes))]
        return self._joined


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, backend=None,
          max_restarts=0, elastic=None, rejoin_grace_s=None, **options):
    """Run func on nprocs workers (spawn.py parity; see the module
    docstring for the process model and the supervisor).

    ``max_restarts``: total replacement budget for ranks that die before
    writing their started marker (i.e. before ``func`` — and therefore any
    collective — began). Default 0; ``PADDLE_TPU_MAX_RESTARTS`` overrides
    the default.

    ``elastic``: survive a STARTED rank's death by re-forming the world
    with the survivors and relaunching ``func`` (which is expected to
    resume from its latest committed sharded checkpoint) instead of
    fail-fasting; ``PADDLE_TPU_ELASTIC=1`` sets the default, the restart
    budget rides ``max_restarts`` (default 3 when elastic), and
    ``rejoin_grace_s`` (``PADDLE_TPU_ELASTIC_REJOIN_GRACE``) bounds the
    window in which a ``rejoin_<rank>`` marker re-claims the dead slot at
    full world size."""
    if os.environ.get('PADDLE_TPU_SPAWN_WORKER') == '1':
        # a worker re-executing the parent's entry script reached an
        # unguarded spawn() call (any nprocs — the in-process fast path
        # must not silently re-run either): the same bootstrapping error
        # multiprocessing raises, or workers would recurse indefinitely
        raise RuntimeError(
            "spawn() called inside a spawn worker. Put the spawn() call "
            "under `if __name__ == '__main__':` in your entry script.")
    if nprocs in (-1, 0, 1) and backend is None:
        if not env.is_initialized():
            env.init_parallel_env()
        result = func(*args)
        return _Context([], None, result)

    n = max(int(nprocs), 1)
    if not max_restarts:
        max_restarts = int(os.environ.get('PADDLE_TPU_MAX_RESTARTS', '0')
                           or 0)
    if elastic is None:
        elastic = os.environ.get('PADDLE_TPU_ELASTIC', '') in ('1', 'true')
    result_dir = tempfile.mkdtemp(prefix='paddle_tpu_torch_spawn_')
    # Workers are fresh interpreters (subprocess with posix_spawn
    # semantics: no preexec_fn, close_fds=False), not forks: a forked
    # child of a parent that holds CUDA contexts and threads can inherit a
    # held lock, and CUDA cannot be used in a forked child at all.
    main = sys.modules.get('__main__')
    main_path = getattr(main, '__file__', None)
    main_spec = getattr(main, '__spec__', None)
    # Preload the parent's entry module in every worker: func or its args
    # may reference classes __main__ defined, not just when func itself
    # lives in __main__. Plain `python script.py` → re-run the file
    # (guarded by run_name); `python -m pkg.mod` → import by module name
    # (multiprocessing's init_main_from_name contract).
    preload_path = (os.path.abspath(main_path)
                    if main_path and main_spec is None else None)
    preload_name = (main_spec.name
                    if main_spec is not None
                    and main_spec.name not in ('__main__', '__mp_main__')
                    else None)
    payload = {
        'sys_path': list(sys.path),
        'main_path': preload_path,
        'main_name': preload_name,
        'func_bytes': pickle.dumps((func, tuple(args))),
        'nprocs': n,
        'result_dir': result_dir,
        'backend': backend,
    }
    # every spawned worker trusts this file; a bare write could hand a
    # half-pickled payload to a fast-starting child (graftlint GL010)
    payload_path = os.path.join(result_dir, 'payload.pkl')
    from ..resilience.atomic_io import atomic_pickle_dump
    atomic_pickle_dump(payload, payload_path)

    def make_proc(rank, world=None, generation=0):
        child_env = dict(os.environ)
        child_env.update(_rank_env(rank, world if world is not None else n))
        child_env['PADDLE_TPU_ELASTIC_GENERATION'] = str(generation)
        child_env['FLAGS_selected_gpus'] = str(rank)
        child_env['PADDLE_TPU_SPAWN_WORKER'] = '1'
        # supervisor contract: heartbeats + started markers live here,
        # DistributedTimeoutError reads them to name missing ranks, and
        # the ranks' file:// rendezvous store lives here too
        child_env['PADDLE_TPU_HEARTBEAT_DIR'] = result_dir
        child_env['PYTHONPATH'] = os.pathsep.join(
            [_PACKAGE_ROOT] + [p for p in child_env.get(
                'PYTHONPATH', '').split(os.pathsep) if p])
        # stderr (tracebacks, native crash reports) is captured per rank so
        # RankFailedError can quote the tail; stdout stays on the console
        # atomic-ok: append-only diagnostics stream, never a trusted load
        log = open(os.path.join(result_dir, f'rank_{rank}.log'), 'ab')
        try:
            p = subprocess.Popen(
                [sys.executable, '-m',
                 'paddle_tpu_torch.distributed._spawn_entry',
                 payload_path, str(rank)],
                env=child_env, close_fds=False, stderr=log)
        finally:
            log.close()   # the child holds its own fd now
        proc = _Proc(p)
        if daemon:
            # multiprocessing's daemon contract: the child must not outlive
            # the parent. Popen has no such mode, so re-establish it with
            # ONE atexit handler over a live-process set (joined/exited
            # workers are discarded — see _Context.join).
            _daemon_procs.add(proc)
        return proc

    procs = [make_proc(rank) for rank in range(n)]
    context = _Context(procs, result_dir, respawn=make_proc,
                       max_restarts=max_restarts, elastic=elastic,
                       rejoin_grace_s=rejoin_grace_s)
    if join:
        context.join()
    return context


def launch():
    """`python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
    [--max_restarts R] [--elastic] [--log_dir D] script.py args...` — run a
    training script once per rank under the spawn env (launch.py parity),
    SUPERVISED: the first rank to exit non-zero terminates its siblings and
    the launcher exits with that rank's diagnostics; boot-phase failures
    are restarted up to --max_restarts. With --elastic (or
    PADDLE_TPU_ELASTIC=1) a started rank's death instead re-forms the
    world with the survivors and relaunches the script, which is expected
    to resume from its latest committed checkpoint."""
    import argparse
    import runpy

    parser = argparse.ArgumentParser('paddle_tpu_torch.distributed.launch')
    parser.add_argument('--nproc_per_node', type=int, default=1)
    parser.add_argument('--max_restarts', type=int, default=0)
    parser.add_argument('--elastic', action='store_true',
                        default=os.environ.get('PADDLE_TPU_ELASTIC', '')
                        in ('1', 'true'),
                        help='survive rank death: downsize the world and '
                             'relaunch from the latest checkpoint instead '
                             'of fail-fasting')
    parser.add_argument('--rejoin_grace', type=float, default=None,
                        help='seconds to wait for a rejoin_<rank> marker '
                             'before downsizing (default: '
                             'PADDLE_TPU_ELASTIC_REJOIN_GRACE or 0)')
    parser.add_argument('--log_dir', default=None,
                        help='per-rank stderr logs (default: a temp run '
                             'dir, quoted in failure diagnostics)')
    parser.add_argument('script')
    parser.add_argument('script_args', nargs=argparse.REMAINDER)
    ns = parser.parse_args()

    if ns.nproc_per_node <= 1:
        sys.argv = [ns.script] + ns.script_args
        runpy.run_path(ns.script, run_name='__main__')
        return

    run_dir = ns.log_dir or tempfile.mkdtemp(
        prefix='paddle_tpu_torch_launch_')
    os.makedirs(run_dir, exist_ok=True)

    def make_proc(rank, world=None, generation=0):
        child = dict(os.environ)
        child.update(_rank_env(rank, world if world is not None
                               else ns.nproc_per_node))
        child['PADDLE_TPU_ELASTIC_GENERATION'] = str(generation)
        # scripts that call init_parallel_env() heartbeat, mark started
        # and (without MASTER_ADDR/MASTER_PORT) rendezvous through these
        # (distributed.env); scripts that never do are supervised on
        # process liveness alone
        child['PADDLE_TPU_HEARTBEAT_DIR'] = run_dir
        child['PADDLE_TPU_STARTED_FILE'] = os.path.join(
            run_dir, f'started_{rank}')
        child['PYTHONPATH'] = os.pathsep.join(
            [_PACKAGE_ROOT] + [p for p in child.get(
                'PYTHONPATH', '').split(os.pathsep) if p])
        # atomic-ok: append-only stderr stream for diagnostics
        log = open(os.path.join(run_dir, f'rank_{rank}.log'), 'ab')
        try:
            p = subprocess.Popen(
                [sys.executable, ns.script] + ns.script_args, env=child,
                stderr=log)
        finally:
            log.close()
        return _Proc(p)

    procs = [make_proc(rank) for rank in range(ns.nproc_per_node)]
    sup = _Supervisor(procs, run_dir, respawn=make_proc,
                      max_restarts=ns.max_restarts, elastic=ns.elastic,
                      rejoin_grace_s=ns.rejoin_grace)
    try:
        sup.wait()
    except RankFailedError as e:
        raise SystemExit(f"launch: {e}")


def get_cluster_and_pod(*a, **k):
    return None, None


if __name__ == '__main__':
    launch()
