"""FleetSupervisor: relaunch dead serving replicas behind the router.
Counterpart of ``paddle_tpu/serving/fleet_supervisor.py``.

The serving sibling of the elastic training supervisor: where that one
watches rank *processes* and re-forms the world, this one watches replica
*engines* behind a ``FleetRouter`` and restores the fleet's capacity:

- a replica whose engine died (``kill()``-ed, or its worker thread
  crashed) is detected on the next sweep; the corpse is **reaped**
  (``stop()`` completes its stranded queued/resident requests as shaped
  errors, so clients fail over in one tick instead of waiting out their
  watchdogs);
- a fresh engine from ``replica_factory(name)`` takes its slot, bounded
  by ``max_restarts`` per replica (exhaustion leaves the replica out of
  rotation and emits ``fleet.restarts_exhausted`` — capacity loss is a
  fact, not a retry loop);
- the relaunched replica **rejoins through the router's half-open gate**
  (``router.readmit(..., warm=False)``): its compile warmup meets
  bounded probe traffic, never the full request stream;
- death→rejoin wall time lands on the ``fleet.recovery_ms`` histogram,
  and every transition is a ``fleet.*`` event + flight-recorder entry.

Drive it manually with ``check_once()`` (deterministic tests) or as a
background thread via ``start()``/``stop()``.

``artifact_dir=`` (the reference's relaunch against a persistent compile
cache) is not ported yet: it raises ``NotImplementedError`` naming
ROADMAP.md, Queue 1 item 7 (``compilecache/``); with ``artifact_dir=None``
the factory runs directly.
"""
import threading

from .. import observability as _obs
from ..observability.timing import Stopwatch
from ..resilience.retry import backoff_delay
from ..resilience.watchdog import join_thread

__all__ = ['FleetSupervisor']


def refuse_artifact_dir(what, artifact_dir):
    """Raise unless ``artifact_dir`` is None: the warm relaunch from a
    persistent compile cache comes with ``compilecache/``."""
    if artifact_dir is not None:
        raise NotImplementedError(
            f"{what}: artifact_dir= is not ported to paddle_tpu_torch yet: "
            "compilecache/ artifacts (ROADMAP.md, Queue 1 item 7); pass "
            "artifact_dir=None to run the replica factory directly")


def build_replica(factory, name, warmup):
    """``factory(name)``, warmed up when ``warmup`` and the engine has a
    ``warmup()``: the new replica's first requests pay no first call."""
    engine = factory(name)
    if warmup and hasattr(engine, 'warmup'):
        engine.warmup()
    return engine


class FleetSupervisor:
    """Watch a ``FleetRouter``'s replicas; reap + relaunch the dead.

    ``replica_factory(name)`` must return a ready ``ServingEngine`` —
    models registered, and ``start()``-ed if the fleet runs background
    workers (the factory owns that choice; manual-drive fleets return
    un-started engines). ``warmup=True`` runs the new engine's buckets
    once before it rejoins, so even the half-open probes pay no first
    call. ``artifact_dir=`` is not ported (module docstring).
    ``relaunch_backoff_s`` paces repeated restarts of the same replica on
    the shared retry curve (0 keeps chaos tests fast)."""

    def __init__(self, router, replica_factory, max_restarts=3,
                 check_interval_s=0.2, warmup=True, relaunch_backoff_s=0.0,
                 reap_timeout_s=5.0, artifact_dir=None):
        refuse_artifact_dir('FleetSupervisor', artifact_dir)
        self.router = router
        self.replica_factory = replica_factory
        self.artifact_dir = artifact_dir
        self.max_restarts = int(max_restarts)
        self.check_interval_s = float(check_interval_s)
        self.warmup = bool(warmup)
        self.relaunch_backoff_s = float(relaunch_backoff_s)
        self.reap_timeout_s = float(reap_timeout_s)
        # the budget lock makes claim-and-increment atomic: a manual
        # check_once() racing the background sweep must not both observe
        # the same count and double-relaunch one replica
        self._budget_lock = threading.Lock()
        self._restarts = {}            # replica -> relaunch count
        self._exhausted = set()        # emitted fleet.restarts_exhausted
        self._thread = None
        self._stop = threading.Event()

    # -- one sweep (manual drive) ---------------------------------------
    def check_once(self):
        """One supervision sweep over the fleet. Returns the list of
        replica names relaunched this sweep."""
        relaunched = []
        for h in self.router.replicas():
            if h.draining or h.engine.dispatchable():
                continue
            name = h.name
            with self._budget_lock:
                used = self._restarts.get(name, 0)
                exhausted = used >= self.max_restarts
                first_exhaustion = exhausted and name not in self._exhausted
                if first_exhaustion:
                    self._exhausted.add(name)
                if not exhausted:
                    # claim the relaunch slot before doing the (slow,
                    # unlocked) reap+rebuild so no concurrent sweep
                    # relaunches the same replica on the same budget
                    self._restarts[name] = used + 1
            if exhausted:
                if first_exhaustion:
                    if _obs.enabled():
                        _obs.counter('fleet.restarts_exhausted').inc()
                        _obs.event('fleet.restarts_exhausted', replica=name,
                                   restarts=used)
                    _obs.flight.record('fleet.restarts_exhausted',
                                       replica=name, restarts=used)
                continue
            sw = Stopwatch()
            self._reap(h)
            if self.relaunch_backoff_s:
                self._stop.wait(backoff_delay(
                    used + 1, backoff=self.relaunch_backoff_s, jitter=0.0))
            if _obs.enabled():
                _obs.counter('fleet.relaunches').inc()
                _obs.event('fleet.replica_relaunch', replica=name,
                           attempt=used + 1)
            _obs.flight.record('fleet.replica_relaunch', replica=name,
                               attempt=used + 1)
            engine = build_replica(self.replica_factory, name, self.warmup)
            self.router.readmit(name, engine=engine, warm=False)
            recovery_ms = sw.elapsed_ms()
            if _obs.enabled():
                _obs.histogram('fleet.recovery_ms').observe(recovery_ms)
                _obs.event('fleet.replica_rejoin', replica=name,
                           restarts=used + 1,
                           recovery_ms=round(recovery_ms, 3))
            _obs.flight.record('fleet.replica_rejoin', replica=name,
                               recovery_ms=round(recovery_ms, 3))
            relaunched.append(name)
        return relaunched

    def _reap(self, handle):
        """Complete the corpse's stranded requests as shaped errors —
        ``stop()`` on a killed engine drains queues and evicts residents,
        turning every client's would-be watchdog timeout into an
        immediate, classifiable replica fault."""
        try:
            handle.engine.stop(timeout=self.reap_timeout_s)
        except Exception as e:
            # a corpse that will not even join its worker: clients fall
            # back to their bounded waits; record it and move on
            if _obs.enabled():
                _obs.event('fleet.reap_failed', replica=handle.name,
                           error=repr(e))
            _obs.flight.record('fleet.reap_failed', replica=handle.name,
                               error=repr(e))

    def restarts(self):
        """{replica: relaunch count} so far."""
        with self._budget_lock:
            return dict(self._restarts)

    # -- background mode ------------------------------------------------
    def start(self):
        """Start the background sweep thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name='paddle-tpu-torch-fleet-supervisor',
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            join_thread(t, timeout=timeout)
        self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception as e:
                # supervision must outlive a bad sweep (a replica factory
                # raising, a race with drain) — but never silently
                if _obs.enabled():
                    _obs.counter('fleet.supervisor_errors').inc()
                    _obs.event('fleet.supervisor_error', error=repr(e))
                _obs.flight.record('fleet.supervisor_error', error=repr(e))
            self._stop.wait(self.check_interval_s)
