"""FleetAutoscaler: SLO-driven elastic replica count behind the router.
Counterpart of ``paddle_tpu/serving/autoscaler.py``.

The ``FleetSupervisor`` restores capacity the fleet *lost* (replica
death); this control loop changes how much capacity the fleet *has*,
driven by the same signals mission control watches:

- **grow** when pressure is *sustained* — the peak per-model
  ``slo.burn_rate`` holds at/above ``burn_high`` (or page-exhaustion
  sheds keep arriving) for ``sustain_ticks`` consecutive observations —
  and the fleet is below ``max_replicas``. The new replica comes from
  ``replica_factory`` exactly like a supervisor relaunch: built and
  warmed, and it rejoins through the router's half-open probe gate, so
  even a cold replica meets bounded traffic first. (``artifact_dir=``,
  the reference's warm scale-up from a compile cache, raises
  ``NotImplementedError`` naming ROADMAP.md, Queue 1 item 7.)
- **shrink** when the fleet is *calm* — burn at/below ``burn_low`` and
  no page sheds for ``sustain_ticks`` observations — and above
  ``min_replicas``. The least-loaded replica is taken out through
  ``router.drain()`` (queued + resident requests finish; zero aborted
  in-flight is the drain contract), then removed and stopped.

Flap-proofing is structural, not tuned: ``burn_low < burn_high`` is an
enforced hysteresis band (a signal value cannot demand both directions),
pressure/calm must hold for ``sustain_ticks`` *consecutive* observations
(the window resets on every action), every action starts a
``cooldown_ticks`` dead time, and the replica count is clamped to the
``[min_replicas, max_replicas]`` envelope. An oscillating signal that
alternates inside the window can therefore never sustain either
condition, and even a pathological signal moves the fleet at most once
per ``cooldown_ticks + sustain_ticks`` ticks.

Every transition lands as ``fleet.autoscale`` events +
``fleet.autoscale.*`` counters/histograms, a flight-recorder record, and
(when the ring sampler is active) a stamped time-series sample, so the
timeline shows the replica-count step exactly where the burn trend
crossed the band. Drive it manually with
``tick()`` (deterministic tests/benches) or as a background thread via
``start()``/``stop()``.
"""
import collections
import itertools
import threading

from .. import observability as _obs
from ..observability import slo as _slo
from ..observability.timing import Stopwatch
from ..resilience.watchdog import join_thread
from .fleet_supervisor import build_replica, refuse_artifact_dir

__all__ = ['FleetAutoscaler']


class FleetAutoscaler:
    """Grow/shrink a ``FleetRouter``'s replica set on sustained SLO burn.

    ``replica_factory(name)`` must return a ready ``ServingEngine``
    (models registered; ``start()``-ed iff the fleet runs background
    workers) — pass ``supervisor=`` to reuse a ``FleetSupervisor``'s
    factory and ``warmup`` setting instead of repeating them
    (``artifact_dir=`` is not ported: module docstring). ``signal=``
    overrides the default pressure signal with any zero-arg callable
    returning a burn-like float (chaos tests feed
    ``faultinject.burn_ramp``-shaped sequences through it).
    """

    def __init__(self, router, replica_factory=None, supervisor=None,
                 min_replicas=1, max_replicas=4, burn_high=1.0,
                 burn_low=0.25, shed_high=1, sustain_ticks=3,
                 cooldown_ticks=5, warmup=None, artifact_dir=None,
                 drain_timeout_s=10.0, check_interval_s=0.25, signal=None,
                 name_prefix='scale'):
        if replica_factory is None and supervisor is not None:
            replica_factory = supervisor.replica_factory
        if replica_factory is None:
            raise ValueError(
                "autoscaler: needs replica_factory= (or supervisor= to "
                "borrow one from)")
        if supervisor is not None:
            if artifact_dir is None:
                artifact_dir = supervisor.artifact_dir
            if warmup is None:
                warmup = supervisor.warmup
        refuse_artifact_dir('FleetAutoscaler', artifact_dir)
        self.router = router
        self.replica_factory = replica_factory
        self.supervisor = supervisor
        self.artifact_dir = artifact_dir
        self.warmup = True if warmup is None else bool(warmup)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscaler: min_replicas must be >= 1, got "
                f"{min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscaler: max_replicas ({max_replicas}) < "
                f"min_replicas ({min_replicas})")
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        if not self.burn_low < self.burn_high:
            raise ValueError(
                f"autoscaler: hysteresis band requires burn_low < "
                f"burn_high, got [{burn_low}, {burn_high}] — a degenerate "
                "band lets one signal value demand both directions (flap)")
        self.shed_high = int(shed_high)
        self.sustain_ticks = max(1, int(sustain_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.drain_timeout_s = float(drain_timeout_s)
        self.check_interval_s = float(check_interval_s)
        self.signal = signal
        self.name_prefix = name_prefix
        self._history = collections.deque(maxlen=self.sustain_ticks)
        self._cooldown = 0
        self._tick = 0
        self._last_page_sheds = None
        self._names = itertools.count(1)
        self._decisions = collections.deque(maxlen=256)
        self._last_detail = None   # grow/shrink evidence for the decision
        # one actor at a time: a manual tick() racing the background loop
        # must not both act on the same observation window (reentrant:
        # tick() calls observe(), which takes it for the shed delta too)
        self._act_lock = threading.RLock()
        self._thread = None
        self._stop = threading.Event()

    # -- signal ----------------------------------------------------------
    def _page_sheds_now(self):
        """Cumulative page-exhaustion sheds across the fleet (always-on
        engine tallies — no telemetry dependency)."""
        total = 0
        for h in self.router.replicas():
            total += getattr(h.engine, '_shed_page_exhaustion', 0)
        return total

    def observe(self):
        """One observation: ``{'burn': float, 'page_sheds': int}`` —
        peak per-model SLO burn (or the injected ``signal``) plus the
        page-exhaustion-shed delta since the previous observation."""
        if self.signal is not None:
            burn = float(self.signal())
        else:
            burns = _slo.burn_rates()
            burn = max(burns.values()) if burns else 0.0
        now = self._page_sheds_now()
        with self._act_lock:
            delta = 0 if self._last_page_sheds is None \
                else max(0, now - self._last_page_sheds)
            self._last_page_sheds = now
        return {'burn': burn, 'page_sheds': delta}

    def decisions(self):
        """The bounded decision log (newest last) — every tick's verdict
        with its evidence, for tests and benches."""
        return list(self._decisions)

    # -- one control iteration (manual drive) ----------------------------
    def tick(self):
        """One observe→decide→act iteration. Returns ``'grow'``,
        ``'shrink'``, ``'cooldown'`` or ``None`` (held steady)."""
        with self._act_lock:
            obs = self.observe()
            self._tick += 1
            pressured = (obs['burn'] >= self.burn_high or
                         obs['page_sheds'] >= max(1, self.shed_high))
            calm = (obs['burn'] <= self.burn_low and
                    obs['page_sheds'] == 0)
            self._history.append((pressured, calm))
            if _obs.enabled():
                _obs.gauge('fleet.autoscale.pressure').set(
                    round(obs['burn'], 4))
            if self._cooldown > 0:
                self._cooldown -= 1
                self._decisions.append(
                    {'tick': self._tick, 'action': 'cooldown',
                     'remaining': self._cooldown, **obs})
                return 'cooldown'
            n = len(self.router.replicas())
            sustained = len(self._history) == self.sustain_ticks
            action = None
            self._last_detail = None
            if sustained and all(p for p, _ in self._history) \
                    and n < self.max_replicas:
                action = self._grow(obs, n)
            elif sustained and all(c for _, c in self._history) \
                    and n > self.min_replicas:
                action = self._shrink(obs, n)
            self._decisions.append(
                {'tick': self._tick, 'action': action or 'steady',
                 'replicas': len(self.router.replicas()), **obs,
                 **(self._last_detail or {})})
            return action

    def _post_action(self):
        """Every action arms the cooldown and resets the observation
        window: the next action needs ``sustain_ticks`` FRESH consecutive
        observations of the post-action fleet, not the window that
        justified this one."""
        self._cooldown = self.cooldown_ticks
        self._history.clear()
        sm = _obs.timeseries.active_sampler()
        if sm is not None:
            # stamp the transition into the ring so the replica-
            # count step lands on the timeline at the crossing, not at
            # the next scheduled sample
            sm.sample_now()

    def _grow(self, obs, n):
        existing = {h.name for h in self.router.replicas()}
        name = f'{self.name_prefix}{next(self._names)}'
        while name in existing:
            name = f'{self.name_prefix}{next(self._names)}'
        sw = Stopwatch()
        engine = build_replica(self.replica_factory, name, self.warmup)
        h = self.router.add_replica(name, engine)
        # the half-open gate is the rejoin contract for ANY cold replica,
        # scale-up included: bounded probes first, full rotation after
        h.breaker.force_half_open(reason='scale_up')
        ms = sw.elapsed_ms()
        if _obs.enabled():
            _obs.counter('fleet.autoscale.grows').inc()
            _obs.histogram('fleet.autoscale.scale_up_ms').observe(ms)
            _obs.gauge('fleet.autoscale.replicas').set(n + 1)
            _obs.event('fleet.autoscale', action='grow', replica=name,
                       replicas=n + 1, burn=round(obs['burn'], 4),
                       page_sheds=obs['page_sheds'], ms=round(ms, 3),
                       cooldown_ticks=self.cooldown_ticks, tick=self._tick)
        _obs.flight.record('fleet.autoscale', action='grow', replica=name,
                           replicas=n + 1, burn=round(obs['burn'], 4))
        self._last_detail = {'replica': name, 'ms': round(ms, 3)}
        self._post_action()
        return 'grow'

    def _shrink(self, obs, n):
        victim = self._least_loaded()
        if victim is None:
            return None
        sw = Stopwatch()
        try:
            engine = self.router.drain(victim,
                                       timeout=self.drain_timeout_s)
        except Exception as e:
            # a drain that times out / dies mid-drain leaves the replica
            # out of rotation but NOT removed — the supervisor (or the
            # next shrink attempt after cooldown) deals with the corpse
            if _obs.enabled():
                _obs.counter('fleet.autoscale.shrink_failed').inc()
                _obs.event('fleet.autoscale', action='shrink_failed',
                           replica=victim, error=repr(e), tick=self._tick)
            _obs.flight.record('fleet.autoscale', action='shrink_failed',
                               replica=victim, error=repr(e))
            self._last_detail = {'replica': victim, 'error': repr(e)}
            self._post_action()
            return None
        # the drain contract: nothing in flight survives un-answered
        aborted = engine.queued_count() + engine.resident_count()
        self.router.remove_replica(victim)
        try:
            engine.stop(timeout=self.drain_timeout_s)
        except Exception:
            pass                       # already drained; a stuck worker
        ms = sw.elapsed_ms()           # joins on its own or not at all
        if _obs.enabled():
            _obs.counter('fleet.autoscale.shrinks').inc()
            _obs.histogram('fleet.autoscale.scale_down_ms').observe(ms)
            _obs.gauge('fleet.autoscale.replicas').set(n - 1)
            _obs.event('fleet.autoscale', action='shrink', replica=victim,
                       replicas=n - 1, burn=round(obs['burn'], 4),
                       aborted=aborted, ms=round(ms, 3),
                       cooldown_ticks=self.cooldown_ticks, tick=self._tick)
        _obs.flight.record('fleet.autoscale', action='shrink',
                           replica=victim, replicas=n - 1, aborted=aborted)
        self._last_detail = {'replica': victim, 'aborted': aborted,
                             'ms': round(ms, 3)}
        self._post_action()
        return 'shrink'

    def _least_loaded(self):
        """The shrink victim: least queued+resident among replicas that
        are actually in rotation (not draining, dispatchable)."""
        cands = [h for h in self.router.replicas()
                 if not h.draining and h.engine.dispatchable()]
        if len(cands) <= self.min_replicas:
            return None
        return min(cands, key=lambda h: (h.engine.queued_count()
                                         + h.engine.resident_count(),
                                         h.name)).name

    # -- background mode ------------------------------------------------
    def start(self):
        """Start the background control loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name='paddle-tpu-torch-fleet-autoscaler',
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
                self.tick()
            except Exception as e:
                # the control loop must outlive a bad iteration (factory
                # raising, a race with the supervisor) — but never silently
                if _obs.enabled():
                    _obs.counter('fleet.autoscale.errors').inc()
                    _obs.event('fleet.autoscale', action='error',
                               error=repr(e))
                _obs.flight.record('fleet.autoscale', action='error',
                                   error=repr(e))
            self._stop.wait(self.check_interval_s)
