"""Opt-in stdlib-only HTTP endpoint: ``GET /metrics`` (Prometheus text
exposition of the registry; ``?format=json`` for the JSON snapshot) +
``GET /healthz`` (JSON readiness). The counterpart of
``paddle_tpu.telemetry.http``.

One :class:`TelemetryServer` serves both a :class:`~paddle_tpu_torch.
telemetry.registry.MetricsRegistry` and a ``health_fn`` — the SAME
class backs ``Trainer.serve_metrics()`` and
``PredictorServer.serve_metrics()``, so a trainer worker and a serving
replica look identical to the scraper. ``/healthz`` returns 200 while
``health_fn()["live"]`` is truthy (or absent) and 503 otherwise — the
shape fleet load-balancer probes expect. No third-party dependency:
``http.server.ThreadingHTTPServer`` on a daemon thread, port 0 picks a
free port (``.port`` reports it).

``extra_routes`` adds endpoints beyond the two built-ins (the
telemetry collector serves ``/alerts``, ``/timeline``, and ``/query``
through it): ``{path: fn(query_string) -> (status, content_type,
body_bytes)}``. ``post_routes`` is the write-side analog — ``{path:
fn(query_string, body_bytes) -> ...}`` — used by the collector's
``POST /rules`` hot-reload door; POST bodies are bounded (1 MiB) so a
runaway client cannot balloon the daemon.

A scraper that disconnects mid-write (curl ^C, a Prometheus timeout)
raises ``BrokenPipeError``/``ConnectionResetError`` on the handler
thread; that is the CLIENT's problem, so it is swallowed and counted
(``paddle_tpu_telemetry_scrape_aborted_total``) instead of spewing a
traceback from the daemon thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from .registry import MetricsRegistry, get_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# an extra route: fn(query_string) -> (status, content_type, body)
RouteFn = Callable[[str], Tuple[int, str, bytes]]
# a POST route: fn(query_string, body) -> (status, content_type, body)
PostRouteFn = Callable[[str, bytes], Tuple[int, str, bytes]]

MAX_POST_BODY = 1 << 20


def _scrape_aborted() -> None:
    """Count one scrape whose client vanished mid-write. The counter
    lives in the PROCESS registry regardless of which registry/view
    the aborted endpoint was serving — it describes this process's
    endpoint threads, not the scraped data."""
    try:
        get_registry().counter(
            "paddle_tpu_telemetry_scrape_aborted_total",
            "Scrapes aborted by the client disconnecting mid-write").inc()
    except Exception:  # pragma: no cover - counting must never raise
        pass


class TelemetryServer:
    """``/metrics`` + ``/healthz`` (+ ``extra_routes``) over a registry
    (daemon thread)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 extra_routes: Optional[Dict[str, RouteFn]] = None,
                 post_routes: Optional[Dict[str, PostRouteFn]] = None):
        self.registry = registry if registry is not None else get_registry()
        self.health_fn = health_fn
        self.extra_routes = dict(extra_routes or {})
        self.post_routes = dict(post_routes or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def handle(self):  # noqa: A003 (stdlib handler name)
                # backstop for disconnect-shaped errors OUTSIDE _reply
                # (handle_one_request's final wfile.flush is unguarded
                # upstream): a vanished scraper must not traceback the
                # daemon thread
                try:
                    super().handle()
                except (BrokenPipeError, ConnectionResetError):
                    _scrape_aborted()

            def do_GET(self):  # noqa: N802 (stdlib handler name)
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    try:
                        # ?format=json serves the registry's JSON
                        # snapshot (the bench/flight-dump shape) from
                        # the same endpoint as the Prometheus text
                        if "format=json" in query.split("&"):
                            self._reply(200, "application/json",
                                        outer.registry.render_json().encode())
                        else:
                            body = outer.registry.render_prometheus().encode()
                            self._reply(200, PROMETHEUS_CONTENT_TYPE, body)
                    except Exception as e:
                        self._reply(500, "text/plain; charset=utf-8",
                                    f"scrape failed: {e}\n".encode())
                elif path == "/healthz":
                    try:
                        health = (outer.health_fn() if outer.health_fn
                                  else {"live": True})
                        code = 200 if health.get("live", True) else 503
                        self._reply(code, "application/json",
                                    json.dumps(health, sort_keys=True,
                                               default=repr).encode())
                    except Exception as e:
                        self._reply(503, "application/json",
                                    json.dumps({"live": False,
                                                "error": repr(e)}).encode())
                elif path in outer.extra_routes:
                    try:
                        code, ctype, body = outer.extra_routes[path](query)
                        self._reply(code, ctype, body)
                    except Exception as e:
                        self._reply(500, "text/plain; charset=utf-8",
                                    f"route {path} failed: {e}\n".encode())
                else:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"unknown path (have /metrics, /healthz"
                                + (b", " + ", ".join(
                                    sorted(outer.extra_routes)).encode()
                                   if outer.extra_routes else b"")
                                + b")\n")

            def do_POST(self):  # noqa: N802 (stdlib handler name)
                path, _, query = self.path.partition("?")
                fn = outer.post_routes.get(path)
                if fn is None:
                    self._reply(404, "text/plain; charset=utf-8",
                                b"unknown POST path (have "
                                + ", ".join(
                                    sorted(outer.post_routes)).encode()
                                + b")\n" if outer.post_routes else
                                b"no POST endpoints\n")
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    length = -1
                if not 0 <= length <= MAX_POST_BODY:
                    self._reply(413, "text/plain; charset=utf-8",
                                f"POST body must declare 0..{MAX_POST_BODY}"
                                " bytes\n".encode())
                    self.close_connection = True
                    return
                try:
                    body = self.rfile.read(length)
                    code, ctype, out = fn(query, body)
                    self._reply(code, ctype, out)
                except (BrokenPipeError, ConnectionResetError):
                    _scrape_aborted()
                    self.close_connection = True
                except Exception as e:
                    self._reply(500, "text/plain; charset=utf-8",
                                f"route {path} failed: {e}\n".encode())

            def _reply(self, code: int, ctype: str, body: bytes):
                # a scraper disconnecting mid-write is routine (curl
                # ^C, scrape timeout): swallow + count, never let it
                # escape the handler as a daemon-thread traceback.
                # Other OSErrors are swallowed too (no traceback) but
                # NOT counted as aborted scrapes — they may be
                # server-side socket problems worth not masking
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    _scrape_aborted()
                    self.close_connection = True
                except OSError:
                    self.close_connection = True

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="pdtpu-telemetry-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(registry: Optional[MetricsRegistry] = None,
                  health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                  port: int = 0, host: Optional[str] = None,
                  extra_routes: Optional[Dict[str, RouteFn]] = None,
                  post_routes: Optional[Dict[str, PostRouteFn]] = None
                  ) -> TelemetryServer:
    """Start a :class:`TelemetryServer`; port 0 picks a free port.
    ``host=None`` binds ``PDTPU_BIND_ADDR`` when set (the cross-host
    knob — a scrape endpoint other machines must reach), else
    loopback."""
    import os

    if host is None:
        host = os.environ.get("PDTPU_BIND_ADDR") or "127.0.0.1"
    return TelemetryServer(registry=registry, health_fn=health_fn,
                           port=port, host=host, extra_routes=extra_routes,
                           post_routes=post_routes)


__all__ = ["PROMETHEUS_CONTENT_TYPE", "TelemetryServer", "serve_metrics"]
