"""Telemetry isolation for the tests that drive both packages' spines.

Both ``paddle_tpu.observability`` and ``paddle_tpu_torch.observability``
keep process-wide state (registry, events, spans, cost ledger, flight
ring, time-series sampler, rank flusher, endpoint, crash hooks), and both
read the same ``PADDLE_TPU_TELEMETRY*`` names. ``reset_spines()`` turns
both off and empties them; ``clean_spines``, an autouse fixture in every
module that imports it, does so around each test and fails a test that
left a thread running.
"""
import re
import threading

import pytest

import paddle_tpu.observability as r_obs
import paddle_tpu_torch.observability as t_obs
from paddle_tpu.serving import admission as r_adm
from paddle_tpu_torch.serving import admission as t_adm

SIDES = (r_obs, t_obs)


def reset_spines():
    for obs in SIDES:
        obs.disable()
        obs.flush.stop_rank_flusher(final_flush=False)
        obs.timeseries.stop_sampler()
        obs.endpoint.stop_active_server()
        obs.timeseries.clear()
        obs.flight.uninstall_crash_hooks()
        obs.reset()
        obs.state._STATE.sync_every = 16
    r_adm.reset_tenant_stats()
    t_adm.reset_tenant_stats()


@pytest.fixture(autouse=True)
def clean_spines():
    reset_spines()
    before = set(threading.enumerate())
    yield
    reset_spines()
    leaked = [t for t in threading.enumerate() if t not in before]
    for t in leaked:
        t.join(5.0)
    assert not [t.name for t in leaked if t.is_alive()]


_PROGRAM = re.compile(r'engine\.train_step\d+')


def names(snapshot):
    """``{kind: sorted metric names}`` without the reference's ``jax.*``
    counters (its ``enable()`` counts every XLA compile in the process),
    each step's cost label (numbered in build order in the process) as
    ``engine.train_step#``."""
    return {kind: sorted(_PROGRAM.sub('engine.train_step#', k)
                         for k in d if not k.startswith('jax.'))
            for kind, d in snapshot.items()}


def tallies(snapshot):
    """The counters (without ``jax.*``) and each histogram's count."""
    return ({k: v for k, v in snapshot['counters'].items()
             if not k.startswith('jax.')},
            {k: v['count'] for k, v in snapshot['histograms'].items()
             if not k.startswith('jax.')})
