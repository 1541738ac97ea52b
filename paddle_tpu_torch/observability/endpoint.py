"""Live telemetry endpoint: a stdlib HTTP server for this process.
The port's counterpart of ``paddle_tpu/observability/endpoint.py``.

A small ``ThreadingHTTPServer`` a ``ServingEngine`` (or any runtime)
attaches, serving the process's telemetry live:

- ``GET /metrics``    Prometheus text exposition of the process registry;
- ``GET /healthz``    JSON: process liveness and uptime, plus what the
                      ``extra_health`` callable adds (a ServingEngine's
                      queue depths, worker state and SLO burn);
- ``GET /events``     JSON tail of the event log (``?n=100&ev=kind``);
- ``GET /timeseries`` the ring sampler's export and its timelines
                      (``?series=page_util`` substring-filters them).

``/diagnosis`` (the anomaly doctor) and ``/costs`` (the cost explorer)
answer **501**: those modules, and the cluster view a ``run_dir=`` would
attach (the per-rank aggregator), come with ROADMAP.md Queue 1 item 4b.

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
           'detach_health', 'stop_active_server', 'LATER']

# what the routes and options that wait answer with
LATER = ("not ported yet: the anomaly doctor, the cost explorer and the "
         "cluster aggregator come with ROADMAP.md, Queue 1 item 4b")

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
            elif route in ('/diagnosis', '/costs'):
                self._send(501, json.dumps({'error': f'{route}: {LATER}'}))
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

    ``extra_health``: callable returning a dict merged into the
    ``/healthz`` body (e.g. ServingEngine queue depths). ``run_dir=``
    (the reference's cluster view) raises ``NotImplementedError``.
    """

    def __init__(self, host=None, port=None, run_dir=None,
                 extra_health=None):
        if run_dir is not None:
            raise NotImplementedError(f"MetricsServer(run_dir=): {LATER}")
        self.host = state.http_host() if host is None else host
        self.port = (state.http_port() or 0) if port is None else int(port)
        self.extra_health = extra_health
        self._httpd = None
        self._thread = None
        self._sw = None

    # -- payload builders (also used by tests, no HTTP needed) -----------
    def render_metrics(self):
        """The process registry's Prometheus exposition."""
        return registry.to_prometheus()

    def health(self):
        """(http_code, payload): 200 while the process is up."""
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
        return (200 if payload['status'] == 'ok' else 503), payload

    def diagnosis(self):
        raise NotImplementedError(f"MetricsServer.diagnosis: {LATER}")

    def costs(self):
        raise NotImplementedError(f"MetricsServer.costs: {LATER}")

    def timeseries(self, series=None):
        """The ring sampler's export and its timelines; ``series``
        substring-filters the series map."""
        from . import timeseries as ts
        live = ts.export_active()
        payload = {'live': live,
                   'series': ts.to_series(live) if live else {}}
        if series:
            payload['series'] = {k: v for k, v in payload['series'].items()
                                 if series in k}
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


def maybe_start_from_env(extra_health=None, run_dir=None):
    """Start the process-wide endpoint when telemetry is enabled and
    ``PADDLE_TPU_TELEMETRY_HTTP`` names a port; idempotent (the first
    caller wins; a later caller may attach a health source to the running
    server). Returns the server or None."""
    if run_dir is not None:
        raise NotImplementedError(f"maybe_start_from_env(run_dir=): {LATER}")
    if not state.enabled() or state.http_port() is None:
        return None
    with _lock:
        srv = _active[0]
        if srv is None:
            srv = MetricsServer(extra_health=extra_health)
            try:
                srv.start()
            except OSError:
                return None   # port taken: another process exports already
            _active[0] = srv
        elif extra_health is not None and srv.extra_health is None:
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
