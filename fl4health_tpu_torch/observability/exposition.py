"""Live scrape endpoint (counterpart of
``fl4health_tpu/observability/exposition.py``): pull-based exposition of the
metrics registry over a stdlib-only HTTP server, so a live ``fit()`` can be
scraped mid-run:

- ``GET /metrics``  — ``MetricsRegistry.to_prometheus()``, text
  exposition format 0.0.4;
- ``GET /manifest`` — the run manifest JSON (``observability/manifest.py``):
  versions, torch/CUDA and the device, execution mode + reason, config hash;
- ``GET /healthz``  — 200 ``ok``, 200 ``degraded: <reason>`` while the
  handle marks the run degraded, and **503** once the run is marked
  unhealthy (a watchdog halt or a postmortem bundle dump —
  ``Observability.mark_unhealthy``);
- ``GET /fleet``    — fleet-ledger summary JSON (``observability/fleet.py``);
- ``GET /clients/<id>`` — one client's lifetime record by REGISTRY id,
  404 for a client the ledger has never seen;
- ``GET /admin/slo`` — the SLO standing (policy, per-objective burn rates,
  KPIs) while an SLO engine is armed;
- ``POST /admin/scalars`` — the admin plane (``observability/
  adminplane.py``): live retunes of the hoisted scalars, armed only by
  ``Observability(admin_token=...)`` and guarded by that shared secret in
  the ``X-Admin-Token`` header; the handler thread only validates and
  enqueues, the round loop applies at the next boundary. Rejections
  answer JAX's status and JSON body (401, 400, 409).

Both admin routes are absent (404) while the plane is unarmed. Every GET
route answers ``HEAD`` too; other methods on known routes answer 405 with
an ``Allow`` header (``POST`` on ``/admin/scalars``); disconnecting
scrapers are swallowed. A
scrape reads host-side floats under the registry lock and never touches
the device. ``port=0`` binds an OS-assigned port; the server runs on daemon
threads and ``close()`` shuts it down and joins it.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from fl4health_tpu_torch.observability.registry import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_DISCONNECTS = (BrokenPipeError, ConnectionResetError)


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Swallows client-disconnect errors instead of printing tracebacks."""

    daemon_threads = True

    def handle_error(self, request, client_address):  # noqa: D102
        exc = sys.exc_info()[1]
        if isinstance(exc, _DISCONNECTS):
            return
        super().handle_error(request, client_address)


class ScrapeServer:
    """Threaded HTTP server over one registry + manifest provider.

    ``manifest_provider`` is called per ``/manifest`` request so the
    served document tracks live updates (e.g. the execution mode chosen
    by the current ``fit()``), not a bind-time snapshot.
    ``health_provider`` is called per ``/healthz`` request and returns
    None while healthy, or a verdict-summary string once the run halted —
    the endpoint then answers 503 with that summary as the body.
    ``degraded_provider`` returns the name of a breaching SLO (or None);
    it only matters while ``health_provider`` says alive — dead beats
    limping. ``fleet_provider``/``client_provider`` back ``/fleet`` and
    ``/clients/<id>``; without them those routes answer 404 like any
    unknown path (a server without a ledger has no fleet to serve).
    ``slo_provider`` backs ``GET /admin/slo``; ``admin_plane`` (an
    ``adminplane.AdminPlane``) backs ``POST /admin/scalars`` — both 404
    when unarmed, so the default surface is exactly the read-only one.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        manifest_provider: Callable[[], dict[str, Any]] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        health_provider: Callable[[], str | None] | None = None,
        fleet_provider: Callable[[], dict[str, Any]] | None = None,
        client_provider: "Callable[[int], dict[str, Any] | None] | None" = None,
        degraded_provider: Callable[[], str | None] | None = None,
        slo_provider: Callable[[], dict[str, Any]] | None = None,
        admin_plane=None,
    ):
        registry_ref = registry
        provider = manifest_provider
        health = health_provider
        degraded = degraded_provider
        fleet = fleet_provider
        client_lookup = client_provider
        slo = slo_provider
        admin = admin_plane

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str,
                      include_body: bool = True,
                      extra_headers: dict[str, str] | None = None) -> None:
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (extra_headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    if include_body:
                        self.wfile.write(body)
                except _DISCONNECTS:
                    pass  # scraper hung up mid-response; nothing to salvage

            def _send_json(self, code: int, doc: Any,
                           include_body: bool = True) -> None:
                self._send(code, json.dumps(doc, default=str).encode(),
                           "application/json", include_body)

            # -------------------------------------------------- GET routing
            def _get_response(self, path: str):
                """(code, body, ctype) for a GET-able path, else None."""
                if path in ("/metrics", "/"):
                    body = registry_ref.to_prometheus().encode("utf-8")
                    return 200, body, PROM_CONTENT_TYPE
                if path == "/manifest":
                    mani = provider() if provider is not None else {}
                    return (200, json.dumps(mani, default=str).encode(),
                            "application/json")
                if path == "/healthz":
                    verdict = health() if health is not None else None
                    if verdict is not None:
                        return (503, f"unhealthy: {verdict}\n".encode(),
                                "text/plain; charset=utf-8")
                    limping = degraded() if degraded is not None else None
                    if limping is not None:
                        return (200, f"degraded: {limping}\n".encode(),
                                "text/plain; charset=utf-8")
                    return 200, b"ok\n", "text/plain; charset=utf-8"
                if path == "/fleet" and fleet is not None:
                    return (200, json.dumps(fleet(), default=str).encode(),
                            "application/json")
                if path.startswith("/clients/") and client_lookup is not None:
                    raw = path[len("/clients/"):]
                    try:
                        cid = int(raw)
                    except ValueError:
                        return (400, b"client id must be an integer\n",
                                "text/plain; charset=utf-8")
                    doc = client_lookup(cid)
                    if doc is None:
                        return (404, b"unknown client\n",
                                "text/plain; charset=utf-8")
                    return (200, json.dumps(doc, default=str).encode(),
                            "application/json")
                if path == "/admin/slo" and slo is not None:
                    return (200, json.dumps(slo(), default=str).encode(),
                            "application/json")
                return None

            def _is_known(self, path: str) -> bool:
                return (self._get_response(path) is not None
                        or (path == "/admin/scalars" and admin is not None))

            def do_GET(self):  # noqa: N802 (http.server API)
                self._answer_read(include_body=True)

            def do_HEAD(self):  # noqa: N802
                self._answer_read(include_body=False)

            def _answer_read(self, include_body: bool) -> None:
                path = self.path.split("?", 1)[0]
                resp = self._get_response(path)
                if resp is not None:
                    code, body, ctype = resp
                    self._send(code, body, ctype, include_body)
                elif path == "/admin/scalars" and admin is not None:
                    self._send(405, b"method not allowed\n",
                               "text/plain; charset=utf-8", include_body,
                               {"Allow": "POST"})
                else:
                    self._send(404, b"not found\n",
                               "text/plain; charset=utf-8", include_body)

            # ------------------------------------------------------- admin
            def do_POST(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path != "/admin/scalars" or admin is None:
                    self._reject_method()
                    return
                from fl4health_tpu_torch.observability.adminplane import AdminRejection

                try:
                    admin.authorize(self.headers.get(admin.AUTH_HEADER))
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length > 0 else b""
                    try:
                        scalars = json.loads(raw.decode("utf-8") or "null")
                    except (ValueError, UnicodeDecodeError):
                        raise AdminRejection(
                            400, "bad_request", "body must be valid JSON") from None
                    self._send_json(200, admin.submit(scalars))
                except AdminRejection as rej:
                    self._send_json(rej.status, rej.doc())

            # ------------------------------------------- other verbs -> 405
            def _reject_method(self):
                path = self.path.split("?", 1)[0]
                if self._is_known(path):
                    allow = "POST" if path == "/admin/scalars" else "GET, HEAD"
                    self._send(405, b"method not allowed\n",
                               "text/plain; charset=utf-8",
                               extra_headers={"Allow": allow})
                else:
                    self._send(404, b"not found\n",
                               "text/plain; charset=utf-8")

            do_PUT = _reject_method    # noqa: N815
            do_DELETE = _reject_method  # noqa: N815
            do_PATCH = _reject_method  # noqa: N815

            def log_message(self, *args):  # no stderr spam per scrape
                pass

        self._httpd = _QuietThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        # close() waits for the serve loop's next poll: at the stdlib's 0.5 s
        # that wait was most of an armed fit()'s fixed cost on the card
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="fl4h-scrape", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
