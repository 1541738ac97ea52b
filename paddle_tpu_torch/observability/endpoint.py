"""Live telemetry endpoint: a stdlib HTTP server for this process.
The port's counterpart of ``paddle_tpu/observability/endpoint.py``.

A small ``ThreadingHTTPServer`` a ``ServingEngine``, a telemetry-on
``Model.fit`` or any runtime attaches, serving the process's (and, given
a run dir, the cluster's) telemetry live:

- ``GET /metrics``    Prometheus text exposition of the process registry;
                      with a run dir attached, also per-rank
                      ``cluster.step_ms`` / ``cluster.kernel_builds`` /
                      ``cluster.heartbeat_age_s`` series labeled
                      ``rank=/host=``;
- ``GET /healthz``    JSON: process liveness and uptime, plus what the
                      ``extra_health`` callable adds (a ServingEngine's
                      queue depths, worker state and SLO burn), and with a
                      run dir the per-rank heartbeat ages; HTTP 503 when
                      any rank's heartbeat is stale;
- ``GET /events``     JSON tail of the event log (``?n=100&ev=kind``);
- ``GET /diagnosis``  the anomaly doctor's ranked findings as JSON;
- ``GET /costs``      the cost explorer's ledger: per-program FLOPs,
                      bytes, peak memory and roofline, the summary and the
                      SLO burn rates;
- ``GET /timeseries`` the ring sampler's export and its timelines, plus
                      the cluster merge with a run dir
                      (``?series=page_util`` substring-filters them).

Security posture: binds 127.0.0.1 unless ``PADDLE_TPU_TELEMETRY_HTTP_HOST``
or ``host=`` says otherwise: a diagnostics port, not a public service; no
auth, read-only GETs. Off by default: nothing listens unless telemetry is
enabled and ``PADDLE_TPU_TELEMETRY_HTTP`` names a port, or a
``MetricsServer`` is started explicitly.
"""
import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import events, registry, state, timing

__all__ = ['MetricsServer', 'maybe_start_from_env', 'active_server',
           'detach_health', 'stop_active_server', 'STALE_HEARTBEAT_S']

STALE_HEARTBEAT_S = 10.0

_lock = threading.Lock()
_active = [None]


class _Handler(BaseHTTPRequestHandler):
    server_version = 'paddle-tpu-torch-telemetry/1'

    # the endpoint must never chat on the serving process's stderr
    def log_message(self, format, *args):   # noqa: A002 (stdlib signature)
        pass

    def _send(self, code, body, content_type='application/json'):
        data = body if isinstance(body, bytes) else body.encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):   # noqa: N802 (stdlib casing)
        try:
            url = urlparse(self.path)
            route = url.path.rstrip('/') or '/'
            owner = self.server.owner
            if route == '/metrics':
                self._send(200, owner.render_metrics(),
                           content_type='text/plain; version=0.0.4; '
                                        'charset=utf-8')
            elif route == '/healthz':
                code, payload = owner.health()
                self._send(code, json.dumps(payload, sort_keys=True))
            elif route == '/events':
                q = parse_qs(url.query)
                n = int(q.get('n', ['100'])[0])
                kind = q.get('ev', [None])[0]
                evs = events.events()
                if kind:
                    evs = [e for e in evs if e.get('ev') == kind]
                self._send(200, json.dumps(evs[-n:] if n > 0 else [],
                                           default=repr))
            elif route == '/diagnosis':
                self._send(200, json.dumps(owner.diagnosis(),
                                           sort_keys=True, default=repr))
            elif route == '/costs':
                self._send(200, json.dumps(owner.costs(), sort_keys=True,
                                           default=repr))
            elif route == '/timeseries':
                q = parse_qs(url.query)
                needle = q.get('series', [None])[0]
                self._send(200, json.dumps(owner.timeseries(series=needle),
                                           sort_keys=True, default=repr))
            else:
                self._send(404, json.dumps(
                    {'error': f'no route {route!r}',
                     'routes': ['/metrics', '/healthz', '/events',
                                '/diagnosis', '/costs', '/timeseries']}))
        except BrokenPipeError:
            pass
        except Exception as e:   # a scrape must never kill the server
            try:
                self._send(500, json.dumps({'error': repr(e)}))
            except OSError:
                pass


class MetricsServer:
    """One live telemetry endpoint for this process.

    ``run_dir``: a run dir whose per-rank files (``flush``) give the
    cluster view: per-rank series and heartbeat health. ``extra_health``:
    callable returning a dict merged into the ``/healthz`` body (e.g.
    ServingEngine queue depths).
    """

    def __init__(self, host=None, port=None, run_dir=None,
                 extra_health=None, stale_after_s=STALE_HEARTBEAT_S):
        self.host = state.http_host() if host is None else host
        self.port = (state.http_port() or 0) if port is None else int(port)
        self.run_dir = run_dir
        self.extra_health = extra_health
        self.stale_after_s = float(stale_after_s)
        self._httpd = None
        self._thread = None
        self._sw = None

    # -- payload builders (also used by tests, no HTTP needed) -----------
    def _cluster(self):
        if not self.run_dir:
            return None
        from . import aggregate
        return aggregate.cluster_snapshot(self.run_dir)

    def render_metrics(self):
        """Process exposition + per-rank cluster series when attached."""
        text = registry.to_prometheus()
        cluster = self._cluster()
        if not cluster or not cluster['n_ranks']:
            return text
        esc = registry.escape_label_value
        # one family at a time: exposition format requires every sample of
        # a family to be contiguous under its single # TYPE line
        lines = []
        ranks = sorted(cluster['per_rank'].items())
        lines.append('# TYPE paddle_tpu_cluster_step_ms summary')
        for rank, row in ranks:
            lbl = f'rank="{esc(rank)}",host="{esc(row.get("host") or "?")}"'
            st = row.get('step_ms') or {}
            lines.append(f'paddle_tpu_cluster_step_ms_count{{{lbl}}} '
                         f'{int(st.get("count") or 0)}')
            for q, key in (('0.5', 'p50'), ('0.99', 'p99')):
                lines.append(
                    f'paddle_tpu_cluster_step_ms{{{lbl},quantile="{q}"}} '
                    f'{st.get(key, 0.0)}')
        lines.append('# TYPE paddle_tpu_cluster_kernel_builds counter')
        for rank, row in ranks:
            lbl = f'rank="{esc(rank)}",host="{esc(row.get("host") or "?")}"'
            lines.append(f'paddle_tpu_cluster_kernel_builds{{{lbl}}} '
                         f'{int(row.get("kernel_builds") or 0)}')
        lines.append('# TYPE paddle_tpu_cluster_heartbeat_age_s gauge')
        for rank, age in sorted(cluster['heartbeat_age_s'].items()):
            if age is None:
                continue
            lines.append(
                f'paddle_tpu_cluster_heartbeat_age_s{{rank="{esc(rank)}"}} '
                f'{age}')
        return text + '\n'.join(lines) + ('\n' if lines else '')

    def health(self):
        """(http_code, payload): 200 while every known heartbeat is fresh,
        503 once any goes stale."""
        payload = {
            'status': 'ok',
            'telemetry_enabled': state.enabled(),
            'pid': os.getpid(),
            'host': socket.gethostname(),
            'uptime_s': round(self._sw.elapsed(), 3) if self._sw else 0.0,
        }
        if self.extra_health is not None:
            try:
                payload.update(self.extra_health() or {})
            except Exception as e:
                payload['extra_health_error'] = repr(e)
        cluster = self._cluster()
        if cluster is not None:
            ages = cluster.get('heartbeat_age_s') or {}
            payload['heartbeat_age_s'] = ages
            payload['n_ranks'] = cluster['n_ranks']
            stale = sorted(r for r, a in ages.items()
                           if a is not None and a >= self.stale_after_s)
            if stale:
                payload['status'] = 'stale'
                payload['stale_ranks'] = stale
        return (200 if payload['status'] == 'ok' else 503), payload

    def diagnosis(self):
        """The doctor's ranked findings over this process's events and
        snapshot (and the cluster view when a run dir is attached)."""
        from . import doctor
        return doctor.diagnose(events=events.events(),
                               snapshot=registry.snapshot(),
                               cluster=self._cluster())

    def costs(self):
        """The cost-explorer slice: ledger + aggregates + SLO burn."""
        from . import costs, slo
        return {'summary': costs.summary(), 'programs': costs.ledger(),
                'slo_burn': slo.burn_rates()}

    def timeseries(self, series=None):
        """The ring sampler's timelines: this process's live export plus
        the cluster merge when a run dir is attached. ``series``
        substring-filters the series maps."""
        from . import timeseries as ts
        live = ts.export_active()
        payload = {'live': live,
                   'series': ts.to_series(live) if live else {}}
        if self.run_dir:
            from . import aggregate
            merged = aggregate.merged_timeseries(self.run_dir)
            if merged.get('series'):
                payload['cluster'] = merged
        if series:
            payload['series'] = {k: v for k, v in payload['series'].items()
                                 if series in k}
            if 'cluster' in payload:
                payload['cluster'] = dict(
                    payload['cluster'],
                    series={k: v
                            for k, v in payload['cluster']['series'].items()
                            if series in k})
        return payload

    # -- lifecycle -------------------------------------------------------
    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.owner = self
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._sw = timing.Stopwatch()
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={'poll_interval': 0.25},
            name='paddle-tpu-torch-telemetry-http', daemon=True)
        self._thread.start()
        events.emit('endpoint_start', url=self.url)
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)


def maybe_start_from_env(run_dir=None, extra_health=None):
    """Start the process-wide endpoint when telemetry is enabled and
    ``PADDLE_TPU_TELEMETRY_HTTP`` names a port; idempotent (the first
    caller wins; later callers may attach a run dir or a health source to
    the running server). ``run_dir`` defaults to
    ``PADDLE_TPU_TELEMETRY_RUN_DIR``. Returns the server or None."""
    if not state.enabled() or state.http_port() is None:
        return None
    with _lock:
        srv = _active[0]
        if srv is None:
            srv = MetricsServer(run_dir=run_dir or state.run_dir(),
                                extra_health=extra_health)
            try:
                srv.start()
            except OSError:
                return None   # port taken: another process exports already
            _active[0] = srv
        else:
            if run_dir and not srv.run_dir:
                srv.run_dir = run_dir
            if extra_health is not None and srv.extra_health is None:
                srv.extra_health = extra_health
        return srv


def active_server():
    return _active[0]


def detach_health(fn):
    """Drop ``fn`` as the active server's health source (no-op when a
    different source is attached). ``==`` not ``is``: bound methods are a
    fresh object per attribute access. A stopped ServingEngine calls this
    so that its dead worker and queues stop standing for this process's
    health, and so that the next engine's start() can attach its own."""
    with _lock:
        srv = _active[0]
        if srv is not None and srv.extra_health == fn:
            srv.extra_health = None


def stop_active_server():
    with _lock:
        srv, _active[0] = _active[0], None
    if srv is not None:
        srv.stop()
