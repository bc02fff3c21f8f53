"""Exporters: Prometheus scrape endpoint + file dumps (stdlib only).

:func:`start_metrics_server` runs a ``ThreadingHTTPServer`` on a daemon
thread serving the registry's text exposition at ``/metrics`` (and its
JSON dump at ``/metrics.json``) — wire it to ``--metrics-port``.  The
registry is read under its own lock per scrape, so the serve loop never
blocks on an exporter.

:func:`dump_metrics` / :func:`dump_trace` write the one-shot file forms
(``--metrics-dump`` / ``--trace-out``): Prometheus text and
Perfetto/Chrome ``trace_event`` JSON respectively.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def start_metrics_server(registry, port: int, host: str = "127.0.0.1"):
    """Serve ``registry`` at ``http://host:port/metrics`` from a daemon
    thread.  Returns the server; call ``.shutdown()`` to stop it.  The
    bound port is ``server.server_address[1]`` (pass ``port=0`` to let
    the OS pick — handy in tests)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] == "/metrics":
                body = registry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/metrics.json":
                body = registry.dump_json().encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # keep the serve loop's stdout clean
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever,
                         name="metrics-exporter", daemon=True)
    t.start()
    return server


def dump_metrics(registry, path: str) -> str:
    """Write the registry's Prometheus text exposition to ``path``."""
    text = registry.prometheus_text()
    with open(path, "w") as f:
        f.write(text)
    return text


def dump_trace(tracer, path: str) -> str:
    """Write the tracer's ring buffer as Perfetto JSON to ``path``."""
    text = tracer.perfetto()
    with open(path, "w") as f:
        f.write(text)
    return text
