"""Serve an InMemoryApiServer over a real HTTP listener.

Copy of `karpenter_tpu/kube/httpapi.py`.

The envtest analogue with the wire actually on a socket
(pkg/test/environment.go:138-197 boots a real apiserver binary for the
same reason): HTTPTransport's urllib request path, bearer-token auth +
refresh, 409/429 mapping, and the `watch=true` chunked streams execute
for real in tests instead of being short-circuited by the in-process
Transport protocol.

Wire behavior mirrors kube-apiserver where RealKubeClient depends on
it:
- JSON bodies, Content-Length framed; errors as {"message": ...} with
  the HTTP status carrying the semantics (404/409/422/429).
- GET with `watch=true` streams line-delimited watch events
  ({"type": ..., "object": ...}) until `timeoutSeconds` elapses, then
  closes cleanly (the client reconnects from its last rv).
- A watch from a compacted resourceVersion emits one
  {"type": "ERROR", "object": {"kind": "Status", "code": 410}} line —
  the informer's cue to re-list.
- Optional bearer auth: requests without the CURRENT token get 401
  (bound service-account tokens rotate; the transport re-reads its
  token file per request, which this exercises).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from karpenter_tpu_torch.kube.real import ApiError, InMemoryApiServer

WATCH_POLL_SECONDS = 0.02  # server-side event-log poll for streams


class HttpApiServer:
    """Owns the listener; `base_url` plugs straight into HTTPTransport."""

    def __init__(self, api: InMemoryApiServer, token: str = "",
                 host: str = "127.0.0.1", port: int = 0):
        self.api = api
        self.token = token
        self.stopping = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.0: close-delimited responses let watch streams end
            # by connection close; urllib opens one connection per
            # request anyway, so keep-alive buys nothing here
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):  # quiet test output
                pass

            def _reject_unauthenticated(self) -> bool:
                if not outer.token:
                    return False
                got = self.headers.get("Authorization", "")
                if got == f"Bearer {outer.token}":
                    return False
                self._respond(401, {"message": "Unauthorized"})
                return True

            def _respond(self, status: int, body: dict) -> None:
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _body(self) -> Optional[dict]:
                length = int(self.headers.get("Content-Length", "0") or 0)
                if not length:
                    return None
                return json.loads(self.rfile.read(length))

            def _dispatch(self, method: str) -> None:
                if self._reject_unauthenticated():
                    return
                parsed = urlparse(self.path)
                params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                if method == "GET" and params.get("watch") == "true":
                    self._watch(parsed.path, params)
                    return
                status, body = outer.api.request(
                    method, parsed.path, self._body(), params or None
                )
                self._respond(status, body)

            def _watch(self, path: str, params: dict) -> None:
                kind, name, namespace, sub = outer.api._parse(path)
                if kind is None or name or sub:
                    self._respond(404, {"message": f"unknown watch {path}"})
                    return
                rv = int(params.get("resourceVersion", "0") or 0)
                timeout = float(params.get("timeoutSeconds", "60") or 60)
                if timeout <= 0:  # 0/absent = server default, not "expire now"
                    timeout = 60.0
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                import time as _time

                deadline = _time.monotonic() + timeout
                try:
                    self._stream(kind, namespace, rv, deadline)
                except (BrokenPipeError, ConnectionError, OSError):
                    pass  # client went away; the stream just ends

            def _stream(self, kind: str, namespace: str, rv: int,
                        deadline: float) -> None:
                import time as _time

                while (not outer.stopping.is_set()
                       and _time.monotonic() < deadline):
                    try:
                        events = outer.api.watch_events(kind, rv)
                    except ApiError as err:
                        self._line({"type": "ERROR", "object": {
                            "kind": "Status", "code": err.status,
                            "message": str(err),
                        }})
                        return
                    for ev, cr, ev_rv in events:
                        if namespace and cr.get("metadata", {}).get(
                            "namespace", ""
                        ) != namespace:
                            rv = max(rv, ev_rv)
                            continue
                        self._line({"type": ev, "object": cr})
                        rv = max(rv, ev_rv)
                    outer.stopping.wait(WATCH_POLL_SECONDS)

            def _line(self, event: dict) -> None:
                self.wfile.write(json.dumps(event).encode() + b"\n")
                self.wfile.flush()

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.base_url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="httpapi", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self.stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
