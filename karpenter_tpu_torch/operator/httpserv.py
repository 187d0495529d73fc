"""Observability over HTTP: /metrics, /healthz, /readyz,
/debug/profile, /debug/traces, /debug/slo, /debug/explain.

Copy of `karpenter_tpu/operator/httpserv.py`.

Counterpart of the ports the reference mounts on its manager
(pkg/operator/operator.go:183-222: metrics server, healthz/readyz
probes, pprof handlers behind --enable-profiling). One threaded stdlib
server carries all routes — the split metrics/health ports of the
reference collapse onto one listener per process here, with the port
taken from Options.metrics_port (0 picks an ephemeral port, exposed as
`.port` for tests).

/debug/traces serves the flight recorder's tick-trace ring
(karpenter_tpu/tracing): plain JSON by default, Chrome-trace/Perfetto
with ?format=perfetto (load into ui.perfetto.dev), one trace's
segments with ?trace_id=<id> — the id a NodeClaim's
karpenter.sh/provenance annotation carries.

/debug/explain serves the decision explainability ring
(karpenter_tpu/explain): ?pod=<ns/name> the pod's elimination funnel
and verdict, ?node=<name> the node's disruption verdict,
?tick=<trace_id> one tick's whole record — the same id the flight
recorder keys on, so "why" joins "when".
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

log = logging.getLogger("karpenter.operator.http")


class ObservabilityServer:
    """Serves Prometheus text metrics and health probes for an
    operator. Probe callables return {"ok": bool, "checks": {...}};
    not-ok maps to HTTP 503 the way controller-runtime's checkers do."""

    def __init__(
        self,
        healthz: Callable[[], dict],
        readyz: Callable[[], dict],
        port: int = 8080,
        host: str = "127.0.0.1",
        profile_report: Optional[Callable[[], dict]] = None,
        slo_report: Optional[Callable[[], dict]] = None,
    ):
        self._healthz = healthz
        self._readyz = readyz
        self._profile_report = profile_report
        self._slo_report = slo_report
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                try:
                    outer._route(self)
                except BrokenPipeError:  # client went away mid-write
                    pass

            def log_message(self, fmt: str, *args) -> None:
                log.debug("http: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="observability-http",
            daemon=True,
        )
        self._thread.start()
        log.info("observability server on :%d (/metrics /healthz /readyz)",
                 self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _query(handler: BaseHTTPRequestHandler) -> dict:
        from urllib.parse import parse_qsl

        _, _, query = handler.path.partition("?")
        return dict(parse_qsl(query))

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        path = handler.path.split("?", 1)[0]
        if path == "/metrics":
            from karpenter_tpu_torch.metrics.exposition import render

            body = render().encode()
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path in ("/healthz", "/readyz"):
            probe = self._healthz if path == "/healthz" else self._readyz
            try:
                result = probe()
            except Exception as err:  # a probe must never crash the server
                result = {"ok": False, "checks": {"error": str(err)}}
            body = json.dumps(result).encode()
            handler.send_response(200 if result.get("ok") else 503)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path == "/debug/profile" and self._profile_report is not None:
            body = json.dumps(self._profile_report()).encode()
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path == "/debug/slo" and self._slo_report is not None:
            # the SLO engine's full report (metrics/slo.py): per-SLI
            # burn windows, verdicts, alert counts, objectives. A
            # report crash must not take the server down — same
            # contract as the probes.
            try:
                body = json.dumps(self._slo_report()).encode()
                status = 200
            except Exception as err:
                body = json.dumps({"error": str(err)}).encode()
                status = 500
            handler.send_response(status)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path == "/debug/explain":
            # the decision explainability plane (karpenter_tpu/explain):
            # one pod's elimination funnel, one node's disruption
            # verdict, or one tick's whole record. Unknown keys 404;
            # a crash inside the plane 500s — it must never hang or
            # kill the server (the /debug/slo contract).
            from karpenter_tpu_torch import explain

            params = self._query(handler)
            try:
                status, text = explain.render_json(
                    pod=params.get("pod", ""),
                    node=params.get("node", ""),
                    trace_id=params.get("tick", ""),
                )
                body = text.encode()
            except Exception as err:
                status = 500
                body = json.dumps({"error": str(err)}).encode()
            handler.send_response(status)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif path == "/debug/traces":
            from karpenter_tpu_torch import tracing

            params = self._query(handler)
            trace_id = params.get("trace_id", "")
            if params.get("format") in ("perfetto", "chrome"):
                selected = (
                    tracing.find(trace_id) if trace_id
                    else tracing.traces()
                )
                body = json.dumps(tracing.to_chrome(selected)).encode()
            else:
                # one source of truth for the response shape
                body = tracing.render_json(trace_id).encode()
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        else:
            handler.send_response(404)
            handler.send_header("Content-Length", "0")
            handler.end_headers()
