"""Read-only observability HTTP endpoints for the chain server.

Counterpart of ``gibbs_student_t_tpu/obs/http.py`` (standard library
only). :class:`ObsHttpServer` serves the server's pull surface over HTTP,
mounted with ``ChainServer(http_port=...)`` on a daemon thread of its own:

- ``GET /healthz``: liveness and the supervisor's and workers' state (200
  when healthy, 503 when the pool failed, a worker error is latched or
  the watchdog tripped);
- ``GET /status``: the schema-pinned ``status()`` snapshot;
- ``GET /metrics``: the Prometheus text exposition (obs/export.py);
- ``GET /trace``: the Chrome trace-event JSON of the span ring (what
  ``export_trace`` writes, rendered in memory);
- ``GET /tenants/<id-or-name>/progress``: one tenant's
  ``TenantHandle.progress()``, its cost included;
- ``GET /postmortem``: the flight recorder's bundle rendered in memory
  (what ``ChainServer.dump_postmortem()`` writes).

Rules: read-only (every response is a snapshot taken under the owning
object's own locks, so a request never tears a quantum); it never crashes
a run (a handler's exception answers 500 with a JSON body and warns once
a server; a bind failure at mount time warns and the server runs without
the endpoints); chains are bitwise the same with it on or off.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class ObsHttpServer:
    """Serve read-only observability callbacks over HTTP.

    Every ``*_fn`` is optional; a missing callback (or one returning
    None) turns its route into a 404, so the same class fronts a full
    ``ChainServer`` or a bare stub. ``port=0`` binds an ephemeral port
    (read it back from :attr:`port` / :attr:`url`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 status_fn: Optional[Callable] = None,
                 healthz_fn: Optional[Callable] = None,
                 metrics_fn: Optional[Callable] = None,
                 trace_fn: Optional[Callable] = None,
                 progress_fn: Optional[Callable] = None,
                 postmortem_fn: Optional[Callable] = None):
        self._status_fn = status_fn
        self._healthz_fn = healthz_fn
        self._metrics_fn = metrics_fn
        self._trace_fn = trace_fn
        self._progress_fn = progress_fn
        self._postmortem_fn = postmortem_fn
        self._warned = False
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "gst-obs/1"
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # no stderr chatter per request
                pass

            def do_GET(self):
                outer._route(self)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gst-obs-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------

    @staticmethod
    def _reply(req, code: int, body, ctype: str = "application/json"):
        if isinstance(body, (dict, list)):
            from gibbs_student_t_tpu_torch.obs.metrics import _jsonable

            body = json.dumps(_jsonable(body))
        data = body.encode() if isinstance(body, str) else body
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _route(self, req) -> None:
        """Dispatch one GET. Never raises into the socket loop: a
        callback exception becomes a 500 body plus one warning per
        server (the warn-and-continue contract)."""
        try:
            path = urllib.parse.urlparse(req.path).path
            parts = [p for p in path.split("/") if p]
            if not parts:
                self._reply(req, 200, {"endpoints": [
                    "/healthz", "/status", "/metrics", "/trace",
                    "/postmortem", "/tenants/<id>/progress"]})
                return
            if parts == ["healthz"] and self._healthz_fn is not None:
                h = self._healthz_fn()
                self._reply(req, 200 if h.get("ok") else 503, h)
                return
            if parts == ["status"] and self._status_fn is not None:
                st = self._status_fn()
                if st is not None:
                    self._reply(req, 200, st)
                    return
            if parts == ["metrics"] and self._metrics_fn is not None:
                text = self._metrics_fn()
                if text is not None:
                    self._reply(
                        req, 200, text,
                        ctype="text/plain; version=0.0.4; charset=utf-8")
                    return
            if parts == ["trace"] and self._trace_fn is not None:
                doc = self._trace_fn()
                if doc is not None:
                    self._reply(req, 200, doc)
                    return
            if parts == ["postmortem"] and self._postmortem_fn is not None:
                doc = self._postmortem_fn()
                if doc is not None:
                    self._reply(req, 200, doc)
                    return
            if (len(parts) == 3 and parts[0] == "tenants"
                    and parts[2] == "progress"
                    and self._progress_fn is not None):
                p = self._progress_fn(urllib.parse.unquote(parts[1]))
                if p is not None:
                    self._reply(req, 200, p)
                    return
                self._reply(req, 404,
                            {"error": f"unknown tenant {parts[1]!r}"})
                return
            self._reply(req, 404, {"error": f"no such endpoint {path!r}"})
        except Exception as e:  # noqa: BLE001 - the wire never crashes a run
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"observability endpoint {getattr(req, 'path', '?')!r} "
                    f"failed ({type(e).__name__}: {e}); serving "
                    "continues", RuntimeWarning)
            try:
                self._reply(req, 500,
                            {"error": f"{type(e).__name__}: {e}"})
            except Exception:  # noqa: BLE001 - client hung up mid-reply
                pass

    def close(self) -> None:
        """Stop accepting requests and join the acceptor thread.
        Idempotent."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
