"""Telemetry runtime state: the process-wide on/off switch and knobs.
The port's own copy of ``paddle_tpu/observability/state.py``.

Stdlib-only and import-cycle-free on purpose: instrumented modules import
the observability package at module load, so nothing here imports torch
or any other ``paddle_tpu_torch`` module at import time.

Env vars (read once at import; ``enable()``/``disable()`` override):

- ``PADDLE_TPU_TELEMETRY=1``       turn telemetry on for the process
- ``PADDLE_TPU_TELEMETRY_DIR``     where exporters and crash dumps write
                                   (default ``paddle_tpu_telemetry`` in
                                   the temporary directory)
- ``PADDLE_TPU_TELEMETRY_SYNC_EVERY``
                                   sampled device-wait cadence for spans
                                   carrying device values: sample the 1st
                                   and every Nth occurrence of a span name
                                   (default 16; 0 disables the wait)

Endpoint and sampler knobs (read live):

- ``PADDLE_TPU_TELEMETRY_HTTP``    port for the live ``/metrics`` +
                                   ``/healthz`` endpoint (0 = pick a free
                                   port; unset/empty = no endpoint)
- ``PADDLE_TPU_TELEMETRY_HTTP_HOST``
                                   bind address (default 127.0.0.1: the
                                   endpoint is diagnostics, not a public
                                   service)
- ``PADDLE_TPU_TELEMETRY_SAMPLE_EVERY``
                                   ring-sampler cadence in seconds
                                   (default 1.0; 0 disables the sampler)
- ``PADDLE_TPU_TELEMETRY_TIMESERIES_CAP``
                                   ring capacity in samples (default 512)
- ``PADDLE_TPU_TELEMETRY_FLUSH_EVERY``
                                   per-rank flush cadence in seconds for
                                   the run dir's files (default 1.0)
- ``PADDLE_TPU_TELEMETRY_RUN_DIR`` run dir for the per-rank telemetry
                                   files (``flush``); with it set, a
                                   telemetry-on ``hapi.Model.fit`` starts
                                   the flusher
- ``PADDLE_TPU_RUNS_REGISTRY``     cross-run baseline registry path
                                   (``runs.jsonl``, ``baseline.py``)

Owned by ``costs.py`` / ``slo.py`` / ``flight.py`` and catalogued here:

- ``PADDLE_TPU_DEVICE_PEAK_FLOPS`` / ``PADDLE_TPU_DEVICE_PEAK_BPS``
                                   roofline device peaks (``costs.py``)
- ``PADDLE_TPU_HBM_BUDGET``        device memory budget in bytes for the
                                   doctor's memory_pressure detector

- ``PADDLE_TPU_SLO_MS`` / ``PADDLE_TPU_SLO_OBJECTIVE``
                                   default per-model latency SLO
- ``PADDLE_TPU_FLIGHT=0``          disable the always-on flight recorder
- ``PADDLE_TPU_FLIGHT_EVENTS``     flight ring capacity (default 512)
- ``PADDLE_TPU_FLIGHT_DIR``        where crash dumps land
"""
import os
import tempfile
import threading

_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), 'paddle_tpu_telemetry')


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


class _State:
    def __init__(self):
        self.enabled = os.environ.get('PADDLE_TPU_TELEMETRY', '') == '1'
        self.log_dir = os.environ.get('PADDLE_TPU_TELEMETRY_DIR',
                                      _DEFAULT_DIR)
        self.sync_every = _env_int('PADDLE_TPU_TELEMETRY_SYNC_EVERY', 16)
        self.lock = threading.Lock()


_STATE = _State()


def enabled():
    """Cheap hot-path guard; every instrumentation site checks this first."""
    return _STATE.enabled


def enable(log_dir=None, sync_every=None):
    """Turn telemetry on (also installs the kernel-build hook)."""
    if log_dir is not None:
        _STATE.log_dir = log_dir
    if sync_every is not None:
        _STATE.sync_every = int(sync_every)
    _STATE.enabled = True
    from . import interpose
    interpose.install_build_hooks()


def disable():
    """Turn telemetry off. The build hook stays registered (a no-op while
    disabled)."""
    _STATE.enabled = False


def log_dir():
    return _STATE.log_dir


def sync_every():
    return _STATE.sync_every


def http_port():
    """Requested endpoint port, or None when no endpoint was asked for.
    0 means "pick a free port" (the server reports the bound one)."""
    raw = os.environ.get('PADDLE_TPU_TELEMETRY_HTTP', '')
    if raw == '':
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def http_host():
    return os.environ.get('PADDLE_TPU_TELEMETRY_HTTP_HOST', '127.0.0.1')


def sample_every():
    """Time-series sampler cadence in seconds (0 disables the sampler)."""
    return _env_float('PADDLE_TPU_TELEMETRY_SAMPLE_EVERY', 1.0)


def flush_every():
    return _env_float('PADDLE_TPU_TELEMETRY_FLUSH_EVERY', 1.0)


def timeseries_cap():
    """Ring capacity (samples) for the in-run time series."""
    return max(2, _env_int('PADDLE_TPU_TELEMETRY_TIMESERIES_CAP', 512))


def run_dir():
    """Cluster run dir for per-rank telemetry files: the explicit override,
    else the supervisor's heartbeat dir, else None (not part of a cluster
    run)."""
    return (os.environ.get('PADDLE_TPU_TELEMETRY_RUN_DIR')
            or os.environ.get('PADDLE_TPU_HEARTBEAT_DIR') or None)


def rank_id():
    """This process's rank in the cluster (0 in a single-process run): the
    one per-rank file-naming identity, shared by the flusher
    (``telemetry_rank<R>.json``) and the flight recorder
    (``flight_rank<R>.json``)."""
    try:
        return int(os.environ.get('PADDLE_TRAINER_ID', '0') or 0)
    except ValueError:
        return 0
