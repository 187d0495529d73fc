"""Real-API-server client: the KubeClient surface over HTTP CRs.

Copy of `karpenter_tpu/kube/real.py`.

Counterpart of the controller-runtime client+cache stack the reference
builds in pkg/operator/operator.go:117-249. The in-memory
`kube.client.KubeClient` IS this framework's API server for
simulation; this module is the adapter that lets the same controllers
run against a real cluster:

- `RealKubeClient` implements the KubeClient surface (create / get /
  list / update / delete / touch / remove_finalizer / watch / deliver
  / typed sugar) on top of a `Transport` speaking Kubernetes REST:
  GET/POST/PUT/DELETE on resource paths, `409` mapped to
  ConflictError (optimistic concurrency on metadata.resourceVersion),
  and incremental WATCH streams.
- Reads are INFORMER-CACHE reads: a local mirror of typed objects fed
  by watch events, pumped by `deliver()` once per operator tick —
  identical staleness semantics to the in-memory client's
  async-delivery mode, which is why `Cluster.synced()` just works.
- Writes push the typed object as a CR dict (kube/serialize.py) and
  stamp the server-assigned resourceVersion back onto the SAME typed
  instance, preserving the in-place-mutation controller pattern.
- Self-originated watch events (resourceVersion <= mirror's) are
  deduped, so a controller never has its canonical object replaced by
  the echo of its own write.
- Every transport request funnels through `_request` and the
  kube/retry.py RetryPolicy: 429s honor Retry-After under full-jitter
  backoff, 5xx retries within a per-call budget, and PUT 409s resolve
  through targeted re-GET + read-modify-write re-apply (`update`
  takes an optional mutation fn); 410 Gone on a watch triggers a
  bounded relist. Fault sites (solver/faults.py kube_* kinds) hook
  both transports so chaos specs replay deterministically over HTTP
  or in memory.

Transports:
- `HTTPTransport`: stdlib urllib against an API server URL with a
  bearer token / client CA (kubeconfig-lite); used on a live cluster.
- `InMemoryApiServer`: a faithful server-side implementation (CR dict
  store, resourceVersion counters, finalizer-aware deletes, watch
  event log, admission validation) used by tests and sims — the
  recorded-fixture stand-in for etcd+apiserver, mirroring what
  pkg/test/environment.go:138-197 does with envtest.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.kube.client import (
    ADDED,
    DELETED,
    MODIFIED,
    ConflictError,
    EvictionBlockedError,
    InvalidError,
    NotFoundError,
    WatchHandler,
)
from karpenter_tpu_torch.kube.objects import LabelSelector
from karpenter_tpu_torch.kube.retry import RetryPolicy
from karpenter_tpu_torch.kube.serialize import FROM_CR, from_cr, to_cr
from karpenter_tpu_torch.metrics.store import (
    KUBE_RELIST,
    STATE_SHARD_RELIST,
    STATE_SHARDS,
)
from karpenter_tpu_torch.state.shards import route_key, shard_count, shard_of, SHARDED_KINDS
from karpenter_tpu_torch.solver import faults as _faults

# kind -> (api prefix, plural, namespaced)
RESOURCES = {
    "NodePool": ("/apis/karpenter.sh/v1", "nodepools", False),
    "NodeClaim": ("/apis/karpenter.sh/v1", "nodeclaims", False),
    "NodeOverlay": ("/apis/karpenter.sh/v1alpha1", "nodeoverlays", False),
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "DaemonSet": ("/apis/apps/v1", "daemonsets", True),
    "PodDisruptionBudget": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
    "Event": ("/api/v1", "events", True),
}

# kinds the client writes but neither LISTs on boot nor watches —
# Events flow one way (recorder -> apiserver), and LISTing every Event
# cluster-wide would be pure load (the reference's EventRecorder never
# reads them back either)
WRITE_ONLY_KINDS = ("Event",)

# kinds the simulation store carries that have no real-cluster codec
# yet; list() returns empty for them rather than failing the operator
UNMAPPED_KINDS = ("StorageClass", "PersistentVolume", "CSINode")


def _path(kind: str, name: str = "", namespace: str = "") -> str:
    prefix, plural, namespaced = RESOURCES[kind]
    parts = [prefix]
    if namespaced and namespace:
        parts += ["namespaces", namespace]
    parts.append(plural)
    if name:
        parts.append(name)
    return "/".join(parts)


def _refresh_in_place(dst, src) -> None:
    """Copy `src`'s data onto `dst` preserving `dst`'s identity (the
    informer-cache replace minus the identity break, shared by _apply
    and the 409-recovery _graft so the two can't drift). Not every
    kind is spec/status shaped (Lease carries holder/renew fields), so
    copy whatever data attributes the fresh object has."""
    dst.metadata = src.metadata
    for attr in ("spec", "status", "status_conditions",
                 "holder", "renew_time", "lease_duration"):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))


class ApiError(Exception):
    def __init__(self, status: int, message: str = ""):
        self.status = status
        super().__init__(f"HTTP {status}: {message}")


# -- kube fault sites (solver/faults.py kinds kube_* / operator_crash) --------
#
# Both transports route every request/watch drain through these hooks,
# so a KARPENTER_FAULTS spec drives the SAME deterministic sequence
# counters whether the stack runs over HTTP or in memory. The raised
# fault is consumed here and mapped to the HTTP status a real API
# server would answer — clients exercise their genuine status-code
# paths, never a foreign exception type.

_PLURALS = frozenset(plural for _, plural, _ in RESOURCES.values())


def _fault_site(method: str, path: str) -> str:
    if method != "GET":
        return "kube_write"
    last = path.rstrip("/").rsplit("/", 1)[-1]
    return "kube_list" if last in _PLURALS else "kube_read"


def _fire_request_fault(method: str, path: str):
    """Fire the request's fault site. Returns None (no fault), a
    ("respond", status, body) synthesized answer, ("stale",) to
    re-serve the previous LIST, or ("partial",) to land the write but
    lose the response."""
    try:
        _faults.fire(_fault_site(method, path))
    except _faults.KubeConflictError as err:
        return ("respond", 409, {"message": str(err), "reason": "Conflict"})
    except _faults.KubeThrottleError as err:
        return ("respond", 429, {
            "message": str(err), "reason": "TooManyRequests",
            "details": {"retryAfterSeconds": err.retry_after},
        })
    except _faults.StaleListError:
        return ("stale",)
    except _faults.WritePartialError:
        return ("partial",)
    return None


def _fire_watch_fault(kind: str) -> None:
    """Fire the kube_watch site; a drop surfaces as the 410 Gone a
    real apiserver answers when the stream's resourceVersion fell off
    its event horizon."""
    try:
        _faults.fire("kube_watch")
    except _faults.WatchDropError as err:
        raise ApiError(410, f"watch of {kind} dropped: {err}") from None


class _KindWatch:
    """One kind's long-lived watch stream: a daemon thread holds the
    chunked `watch=true` response open, parses line-delimited watch
    events, and queues (event, object-CR, rv) tuples for the pump.
    Reconnects from the last seen rv when the server closes the
    stream (timeoutSeconds); BOOKMARK events advance rv without
    queueing; an ERROR/410 marks the stream `gone` for re-list."""

    def __init__(self, transport: "HTTPTransport", kind: str, since_rv: int):
        self.transport = transport
        self.kind = kind
        self.rv = since_rv
        self._queue: list[tuple[str, dict, int]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.gone = False
        self.dead = False
        self._resp = None
        self._thread = threading.Thread(
            target=self._run, name=f"watch-{kind}", daemon=True
        )
        self._thread.start()

    def drain(self) -> list[tuple[str, dict, int]]:
        with self._lock:
            out, self._queue = self._queue, []
        return out

    def stop(self) -> None:
        self._stop.set()
        resp = self._resp
        if resp is not None:
            # close() alone does NOT interrupt a readline blocked in
            # recv(); shutting the socket down does, immediately
            try:
                import socket as _socket

                sock = getattr(getattr(resp, "fp", None), "raw", None)
                sock = getattr(sock, "_sock", None)
                if sock is not None:
                    sock.shutdown(_socket.SHUT_RDWR)
            except Exception:
                pass
            try:
                resp.close()
            except Exception:
                pass
        self._thread.join(timeout=2.0)

    # -- reader thread ---------------------------------------------------

    def _run(self) -> None:
        import urllib.error

        from karpenter_tpu_torch.utils.backoff import jitter

        # reconnect backoff is jittered ([0.5, 1.0) of the exponential
        # window): an API-server restart drops EVERY watcher at once,
        # and synchronized un-jittered reconnects would stampede it at
        # exactly 0.2s, 0.4s, ... after it comes back
        backoff = 0.2
        while not self._stop.is_set():
            try:
                self._read_stream()
                if self.gone:
                    break  # in-band ERROR/410: caller must re-list
                backoff = 0.2  # clean server-side timeout; reconnect
            except urllib.error.HTTPError as err:
                if err.code == 410:
                    self.gone = True
                    break
                self._stop.wait(backoff * jitter())
                backoff = min(10.0, backoff * 2)
            except Exception:
                if self._stop.is_set():
                    break
                self._stop.wait(backoff * jitter())
                backoff = min(10.0, backoff * 2)
        self.dead = True

    def _read_stream(self) -> None:
        import ssl
        import urllib.parse
        import urllib.request

        params = {
            "watch": "true",
            "resourceVersion": str(self.rv),
            "allowWatchBookmarks": "true",
            # never 0: sub-second configs would truncate to "expire
            # immediately" and tight-loop reconnects
            "timeoutSeconds": str(max(
                1, int(self.transport.watch_timeout_seconds)
            )),
        }
        url = (self.transport.base_url + _path(self.kind)
               + "?" + urllib.parse.urlencode(params))
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        token = self.transport._bearer()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        context = None
        if self.transport.ca_file:
            context = ssl.create_default_context(cafile=self.transport.ca_file)
        # read timeout must outlast server-side quiet periods between
        # bookmarks; a timeout just forces a clean reconnect
        with urllib.request.urlopen(
            req, timeout=self.transport.watch_timeout_seconds + 30.0,
            context=context,
        ) as resp:
            self._resp = resp
            try:
                for raw in resp:
                    if self._stop.is_set():
                        return
                    line = raw.strip()
                    if not line:
                        continue
                    self._handle(json.loads(line))
                    if self.gone:
                        return
            finally:
                self._resp = None

    def _handle(self, event: dict) -> None:
        etype = event.get("type", "")
        obj = event.get("object", {}) or {}
        if etype == "ERROR":
            if obj.get("code") == 410:
                self.gone = True
            return
        rv = int(obj.get("metadata", {}).get("resourceVersion", "0") or 0)
        if rv:
            self.rv = max(self.rv, rv)
        if etype == "BOOKMARK":
            return
        with self._lock:
            self._queue.append((etype, obj, rv))
        # reactive wake: tell the embedder an event is
        # queued so its live loop runs deliver() now instead of
        # sleeping the tick interval out. Fired outside the lock; the
        # hook must be cheap and thread-safe (threading.Event.set)
        hook = getattr(self.transport, "on_watch_event", None)
        if hook is not None:
            try:
                hook(self.kind)
            except Exception:
                pass


class HTTPTransport:
    """Kubernetes REST over stdlib urllib (kubeconfig-lite: host +
    bearer token). Watch is the real protocol: one background reader
    per kind holds a `watch=true&allowWatchBookmarks=true` chunked
    stream open (operator.go:157-201's informer machinery), queueing
    events that `watch_events()` drains on each deliver() pump; a
    410 Gone surfaces as ApiError(410) so the client re-lists. The
    old LIST-diff snapshot poll remains available as an explicit
    fallback (`snapshot_watch=True`) for API servers without watch."""

    def __init__(self, base_url: str, token: str = "",
                 ca_file: Optional[str] = None, timeout: float = 30.0,
                 token_file: Optional[str] = None,
                 snapshot_watch: bool = False,
                 watch_timeout_seconds: float = 290.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        # bound service-account tokens expire (~1h) and the kubelet
        # refreshes the projected file: re-read per request (mtime-
        # cached) instead of pinning the boot-time value
        self.token_file = token_file
        self._token_mtime = 0.0
        self.ca_file = ca_file
        self.timeout = timeout
        self.snapshot_watch = snapshot_watch
        self.watch_timeout_seconds = watch_timeout_seconds
        self._streams: dict[str, _KindWatch] = {}
        self._gone_pending: set[str] = set()  # kinds owing a 410
        self._streams_lock = threading.Lock()
        self._list_cache: dict[str, dict] = {}  # path -> last LIST body
        # queued-event hook: the watch reader threads call
        # this (with the kind) the moment an event lands, so an
        # event-driven embedder can wake its loop sub-tick
        self.on_watch_event = None

    def set_event_hook(self, hook) -> None:
        self.on_watch_event = hook

    def _bearer(self) -> str:
        if self.token_file:
            import os as _os

            try:
                mtime = _os.stat(self.token_file).st_mtime
                if mtime != self._token_mtime:
                    with open(self.token_file) as fh:
                        self.token = fh.read().strip()
                    self._token_mtime = mtime
            except OSError:
                pass
        return self.token

    def request(self, method: str, path: str, body: Optional[dict] = None,
                params: Optional[dict] = None) -> tuple[int, dict]:
        injected = _fire_request_fault(method, path)
        if injected is not None:
            if injected[0] == "respond":
                return injected[1], injected[2]
            if injected[0] == "stale" and path in self._list_cache:
                return 200, json.loads(json.dumps(self._list_cache[path]))
            # "partial": perform the request, then lose the response
        status, detail = self._request_raw(method, path, body, params)
        if injected is not None and injected[0] == "partial":
            return 500, {"message": "injected write-partial: response lost"}
        if (method == "GET" and status == 200 and "items" in detail
                and _faults.get() is not None):
            # remember the last good LIST so an injected stale read has
            # a genuinely old snapshot to serve; only while a fault
            # spec is live — the deep copy is O(cluster) per LIST and
            # the healthy path must not pay it
            self._list_cache[path] = json.loads(json.dumps(detail))
        return status, detail

    def _request_raw(self, method: str, path: str, body: Optional[dict],
                     params: Optional[dict]) -> tuple[int, dict]:
        import ssl
        import urllib.error
        import urllib.parse
        import urllib.request

        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        req.add_header("Accept", "application/json")
        token = self._bearer()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        context = None
        if self.ca_file:
            context = ssl.create_default_context(cafile=self.ca_file)
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout, context=context
            ) as resp:
                payload = resp.read()
                return resp.status, json.loads(payload) if payload else {}
        except urllib.error.HTTPError as err:
            payload = err.read()
            try:
                detail = json.loads(payload) if payload else {}
            except ValueError:
                detail = {"message": payload.decode(errors="replace")}
            retry_after = err.headers.get("Retry-After") if err.headers else None
            if retry_after is not None:
                # fold the header into the Status body where
                # kube/retry.py reads it (apiservers ship both)
                try:
                    detail.setdefault("details", {}).setdefault(
                        "retryAfterSeconds", float(retry_after)
                    )
                except (ValueError, AttributeError):
                    pass
            return err.code, detail

    # LIST-diff fallback (snapshot_watch=True): the client re-lists
    # every kind per pump and diffs against its mirror. O(cluster)
    # apiserver load, so RealKubeClient throttles these pumps
    # (snapshot_poll_seconds); streaming is the default.
    snapshot_poll_seconds = 5.0

    def watch_events(self, kind: str, since_rv: int) -> list:
        """Drain the kind's background stream (starting it on first
        use at `since_rv`). Raises ApiError(410) when the server
        declared the resourceVersion too old — the caller re-lists
        and the next call restarts the stream from the fresh rv."""
        try:
            _fire_watch_fault(kind)
        except ApiError:
            # injected drop: kill the live stream too, so the next
            # call restarts one from the post-relist rv
            with self._streams_lock:
                stream = self._streams.pop(kind, None)
            if stream is not None:
                stream.stop()
            raise
        with self._streams_lock:
            if kind in self._gone_pending:
                # consume the deferred 410 exactly once; the NEXT call
                # (post-re-list) starts a fresh stream
                self._gone_pending.discard(kind)
                raise ApiError(410, f"watch of {kind} too old")
            stream = self._streams.get(kind)
            if stream is None or stream.dead:
                if stream is not None and stream.gone:
                    self._streams.pop(kind, None)
                    stream.stop()
                    raise ApiError(410, f"watch of {kind} too old")
                stream = _KindWatch(self, kind, since_rv)
                self._streams[kind] = stream
        events = stream.drain()
        if stream.gone:
            with self._streams_lock:
                self._streams.pop(kind, None)
            stream.stop()
            if events:
                # deliver what arrived; the 410 stays PENDING so the
                # next pump re-lists instead of spinning up another
                # stream at a still-compacted rv
                with self._streams_lock:
                    self._gone_pending.add(kind)
                return events
            raise ApiError(410, f"watch of {kind} too old")
        return events

    def close(self) -> None:
        with self._streams_lock:
            streams, self._streams = dict(self._streams), {}
        for stream in streams.values():
            stream.stop()


class _ServerPdbView:
    """Just enough of the KubeClient read surface for PdbLimits to run
    INSIDE the API server (the server enforces PDBs on the eviction
    subresource; clients never see the math, only the 429)."""

    def __init__(self, server: "InMemoryApiServer"):
        self._server = server

    def pdbs(self):
        return [
            from_cr(cr)
            for cr in self._server._bucket("PodDisruptionBudget").values()
        ]

    def pods(self, namespace: Optional[str] = None, selector=None):
        out = []
        for cr in self._server._bucket("Pod").values():
            if namespace and cr["metadata"].get("namespace", "") != namespace:
                continue
            pod = from_cr(cr)
            if selector is not None and not selector.matches(
                pod.metadata.labels
            ):
                continue
            out.append(pod)
        return out


class InMemoryApiServer:
    """Server-side semantics of a real API server over CR dicts: RV
    counters, conflict checks, finalizer-aware deletion, a watch event
    log, and the same admission validation the CRDs carry as CEL."""

    snapshot_watch = False  # serves a true event log incl. DELETED

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._store: dict[str, dict[str, dict]] = {}
        self._rv = 0
        self._events: list[tuple[str, str, dict, int]] = []  # kind, ev, cr, rv
        # rv horizon: events at or below this were compacted away; a
        # watch resuming from below it gets 410 Gone (etcd compaction)
        self._compacted_rv = 0
        self._list_cache: dict[str, dict] = {}  # path -> last LIST body

    # -- request API (the Transport protocol) ---------------------------

    def request(self, method: str, path: str, body: Optional[dict] = None,
                params: Optional[dict] = None) -> tuple[int, dict]:
        injected = _fire_request_fault(method, path)
        if injected is not None:
            if injected[0] == "respond":
                return injected[1], injected[2]
            if injected[0] == "stale" and path in self._list_cache:
                return 200, json.loads(json.dumps(self._list_cache[path]))
        status, detail = self._handle(method, path, body)
        if injected is not None and injected[0] == "partial":
            # the write LANDED; the response is lost on the wire
            return 500, {"message": "injected write-partial: response lost"}
        if (method == "GET" and status == 200 and "items" in detail
                and _faults.get() is not None):
            # last-good-LIST snapshot for kube_stale_list; fault runs
            # only (the copy is O(cluster) per LIST)
            self._list_cache[path] = json.loads(json.dumps(detail))
        return status, detail

    def _handle(self, method: str, path: str,
                body: Optional[dict]) -> tuple[int, dict]:
        kind, name, namespace, subresource = self._parse(path)
        if kind is None:
            return 404, {"message": f"unknown path {path}"}
        with self._lock:
            if subresource == "binding" and method == "POST":
                return self._bind(kind, namespace, name, body or {})
            if subresource == "eviction" and method == "POST":
                return self._evict(kind, namespace, name)
            if method == "GET" and not name:
                items = list(self._bucket(kind).values())
                if namespace:
                    items = [
                        i for i in items
                        if i["metadata"].get("namespace") == namespace
                    ]
                return 200, {"items": [json.loads(json.dumps(i)) for i in items],
                             "metadata": {"resourceVersion": str(self._rv)}}
            if method == "GET":
                cr = self._bucket(kind).get(self._key(kind, namespace, name))
                if cr is None:
                    return 404, {"message": "not found"}
                return 200, json.loads(json.dumps(cr))
            if method == "POST":
                return self._create(kind, body or {})
            if method == "PUT":
                return self._update(kind, namespace, name, body or {})
            if method == "DELETE":
                return self._delete(kind, namespace, name)
        return 405, {"message": method}

    def watch_events(self, kind: str, since_rv: int) -> list[tuple[str, dict, int]]:
        _fire_watch_fault(kind)
        with self._lock:
            if since_rv < self._compacted_rv:
                raise ApiError(
                    410, f"resourceVersion {since_rv} is too old "
                         f"(compacted through {self._compacted_rv})"
                )
            return [
                (ev, json.loads(json.dumps(cr)), rv)
                for k, ev, cr, rv in self._events
                if k == kind and rv > since_rv
            ]

    def compact(self, keep: int = 0) -> None:
        """Discard the event log except the last `keep` entries (etcd
        compaction analogue — watchers resuming from before the new
        horizon get 410 Gone and must re-list)."""
        with self._lock:
            cut = len(self._events) - keep
            if cut > 0:
                self._compacted_rv = self._events[cut - 1][3]
                del self._events[:cut]

    # -- internals -------------------------------------------------------

    def _bucket(self, kind: str) -> dict[str, dict]:
        return self._store.setdefault(kind, {})

    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> str:
        _, _, namespaced = RESOURCES[kind]
        return f"{namespace}/{name}" if namespaced else name

    def _parse(self, path: str):
        for kind, (prefix, plural, namespaced) in RESOURCES.items():
            if not path.startswith(prefix + "/"):
                continue
            rest = path[len(prefix) + 1:].split("/")
            namespace = ""
            if rest and rest[0] == "namespaces" and len(rest) >= 2:
                namespace = rest[1]
                rest = rest[2:]
            if not rest or rest[0] != plural:
                continue
            name = rest[1] if len(rest) > 1 else ""
            subresource = rest[2] if len(rest) > 2 else ""
            return kind, name, namespace, subresource
        return None, "", "", ""

    def _admit(self, kind: str, cr: dict, old: Optional[dict]) -> Optional[str]:
        """CRD admission (apis/v1/validation.py — the CEL analogue)."""
        from karpenter_tpu_torch.apis.v1.validation import (
            ValidationError,
            validate_node_claim,
            validate_node_pool,
        )

        try:
            if kind == "NodePool":
                validate_node_pool(
                    from_cr(cr), old=from_cr(old) if old else None
                )
            elif kind == "NodeClaim":
                if old is None:
                    validate_node_claim(from_cr(cr))
                elif old.get("spec") != cr.get("spec"):
                    return "NodeClaim spec is immutable"
        except ValidationError as err:
            return str(err)
        return None

    def _emit(self, kind: str, event: str, cr: dict) -> None:
        self._events.append((kind, event, json.loads(json.dumps(cr)), self._rv))
        if len(self._events) > 100_000:
            self.compact(keep=50_000)

    def _create(self, kind: str, cr: dict) -> tuple[int, dict]:
        meta = cr.setdefault("metadata", {})
        key = self._key(kind, meta.get("namespace", ""), meta.get("name", ""))
        bucket = self._bucket(kind)
        if key in bucket:
            return 409, {"message": f"{kind} {key} already exists"}
        reason = self._admit(kind, cr, None)
        if reason is not None:
            return 422, {"message": reason}
        self._rv += 1
        meta["resourceVersion"] = str(self._rv)
        meta["generation"] = 1
        bucket[key] = json.loads(json.dumps(cr))
        self._emit(kind, ADDED, bucket[key])
        return 201, json.loads(json.dumps(bucket[key]))

    def _update(self, kind: str, namespace: str, name: str,
                cr: dict) -> tuple[int, dict]:
        key = self._key(kind, namespace, name)
        bucket = self._bucket(kind)
        existing = bucket.get(key)
        if existing is None:
            return 404, {"message": "not found"}
        sent_rv = int(cr.get("metadata", {}).get("resourceVersion", "0") or 0)
        have_rv = int(existing["metadata"].get("resourceVersion", "0"))
        if sent_rv and sent_rv != have_rv:
            # full optimistic concurrency, as a real apiserver enforces
            # it: ANY mismatch is a conflict, not just a stale-older
            # write — last-write-wins must never silently clobber a
            # concurrent actor (the conflict-retry wrapper in
            # RealKubeClient re-GETs and re-applies)
            return 409, {
                "message": "resourceVersion conflict: "
                           f"sent {sent_rv}, have {have_rv}",
                "reason": "Conflict",
            }
        reason = self._admit(kind, cr, existing)
        if reason is not None:
            return 422, {"message": reason}
        self._rv += 1
        cr = json.loads(json.dumps(cr))
        cr["metadata"]["resourceVersion"] = str(self._rv)
        # deletion progresses server-side: with a deletionTimestamp set
        # and the last finalizer gone, the write finalizes the delete
        if cr["metadata"].get("deletionTimestamp") and not cr["metadata"].get(
            "finalizers"
        ):
            del bucket[key]
            self._emit(kind, DELETED, cr)
            return 200, cr
        bucket[key] = cr
        self._emit(kind, MODIFIED, cr)
        return 200, json.loads(json.dumps(cr))

    def _delete(self, kind: str, namespace: str, name: str) -> tuple[int, dict]:
        key = self._key(kind, namespace, name)
        bucket = self._bucket(kind)
        cr = bucket.get(key)
        if cr is None:
            return 404, {"message": "not found"}
        meta = cr["metadata"]
        if meta.get("finalizers"):
            if not meta.get("deletionTimestamp"):
                from karpenter_tpu_torch.kube.serialize import ts_to_rfc3339
                import time as _time

                self._rv += 1
                meta["deletionTimestamp"] = ts_to_rfc3339(_time.time())
                meta["resourceVersion"] = str(self._rv)
                self._emit(kind, MODIFIED, cr)
            return 200, json.loads(json.dumps(cr))
        self._rv += 1
        # stamp the deletion rv (real apiservers do): watch clients
        # advance their cursor from the OBJECT's rv, so a stale
        # embedded rv would make them replay this DELETED forever
        meta["resourceVersion"] = str(self._rv)
        del bucket[key]
        self._emit(kind, DELETED, cr)
        return 200, json.loads(json.dumps(cr))

    def _evict(self, kind: str, namespace: str,
               name: str) -> tuple[int, dict]:
        """policy/v1 Eviction subresource: PDBs are consulted SERVER-
        side (what the real API server does; eviction.go:170-185 is
        the client reacting to this 429). Allowed evictions proceed as
        graceful deletes, finalizer semantics included."""
        if kind != "Pod":
            return 404, {"message": "eviction is a pod subresource"}
        key = self._key(kind, namespace, name)
        cr = self._bucket(kind).get(key)
        if cr is None:
            return 404, {"message": "not found"}
        from karpenter_tpu_torch.utils.pdb import PdbLimits

        blocking = PdbLimits(_ServerPdbView(self)).can_evict(
            from_cr(cr), server_side=True
        )
        if blocking is not None:
            # one source of truth for the denial text (the client's
            # exception renders it identically)
            return 429, {
                "message": str(EvictionBlockedError(blocking)),
                "reason": "TooManyRequests",
                "details": {"causes": [{"reason": "DisruptionBudget",
                                        "message": blocking}]},
            }
        return self._delete(kind, namespace, name)

    def _bind(self, kind: str, namespace: str, name: str,
              binding: dict) -> tuple[int, dict]:
        if kind != "Pod":
            return 404, {"message": "binding is a pod subresource"}
        key = self._key(kind, namespace, name)
        cr = self._bucket(kind).get(key)
        if cr is None:
            return 404, {"message": "not found"}
        self._rv += 1
        cr.setdefault("spec", {})["nodeName"] = (
            binding.get("target", {}).get("name", "")
        )
        cr["metadata"]["resourceVersion"] = str(self._rv)
        self._emit(kind, MODIFIED, cr)
        return 201, {}


class RealKubeClient:
    """KubeClient surface over a Transport (see module docstring)."""

    # A real cluster HAS workload controllers (ReplicaSets recreate
    # evicted replicas; kube-scheduler binds them): controllers must
    # never fabricate pods here — see EvictionQueue.
    simulates_workload_controllers = False

    def __init__(self, transport, kinds: Optional[Iterable[str]] = None):
        self.transport = transport
        self.kinds = (list(kinds) if kinds is not None
                      else [k for k in RESOURCES if k not in WRITE_ONLY_KINDS])
        self._lock = threading.RLock()
        self._mirror: dict[str, dict[str, object]] = {k: {} for k in self.kinds}
        self._last_rv: dict[str, int] = {k: 0 for k in self.kinds}
        self._watchers: dict[str, list[WatchHandler]] = {}
        self._pending_events: list[tuple[str, str, object]] = []
        self._pods_by_node: dict[str, set[str]] = {}
        self._pod_node: dict[str, str] = {}
        self.async_delivery = True  # cache semantics are inherent here
        self._last_pump = 0.0
        self._relist_at: dict[str, float] = {}  # kind -> last 410 relist
        # monotone per-kind relist counter: DirtyTracker.relisted reads
        # it so retained-state consumers can mark everything dirty once
        # per lost-continuity window (the relist's diff events alone
        # cannot prove nothing else changed while the watch was stale)
        self._relist_gen: dict[str, int] = {}
        # sharded logical streams (state/shards.py): per-shard watch
        # cursors + relist generations for the node-keyed kinds. The
        # pump groups shards by cursor value, so the steady state (all
        # cursors equal) is ONE watch scan with zero routing work;
        # cursors diverge only across a shard-scoped relist window.
        self._shards = shard_count()
        STATE_SHARDS.set(float(self._shards))
        self._shard_rv: dict[str, list[int]] = {
            k: [0] * self._shards for k in self.kinds if k in SHARDED_KINDS
        }
        self._shard_relist_gen: dict[str, list[int]] = {
            k: [0] * self._shards for k in self._shard_rv
        }
        # reactive wake seam: called whenever events are
        # known to be pending delivery — from the transport's watch
        # reader threads (async) and from self-originated writes'
        # _announce (sync) — so the operator's live loop can sleep on
        # an Event instead of polling deliver()
        self._event_pending_hook = None
        # deletion tombstones (kind -> key -> deletion rv), recorded
        # only while shard cursors are divergent: a behind shard's
        # replay of a pre-delete MODIFIED must not resurrect a key a
        # faster shard (or a scoped relist) already deleted. Cleared
        # when a kind's cursors reconverge to a single group.
        self._tombstones: dict[str, dict[str, int]] = {}
        self.sync()
        with self._lock:
            for kind in self._shard_rv:
                rv = self._last_rv.get(kind, 0)
                self._shard_rv[kind] = [rv] * self._shards

    # -- transport funnel --------------------------------------------------

    def _request(self, verb: str, method: str, path: str,
                 body: Optional[dict] = None, body_fn=None,
                 on_conflict=None) -> tuple[int, dict]:
        """EVERY transport request goes through here (statically
        enforced by tests/test_kube_write_sites.py): the env-tuned
        RetryPolicy (kube/retry.py) absorbs 429 storms and apiserver
        5xx hiccups under per-call budgets, and 409s re-enter through
        the caller's targeted re-GET + re-apply hook. `body_fn`
        re-renders the payload per attempt so a conflict hook's
        mutation lands in the retried write."""

        def attempt() -> tuple[int, dict]:
            return self.transport.request(
                method, path, body_fn() if body_fn is not None else body
            )

        return RetryPolicy.current().execute(
            verb, attempt, on_conflict=on_conflict
        )

    # -- informer machinery ----------------------------------------------

    def _from_item(self, kind: str, item: dict):
        """Parse one LIST/watch item. The kind comes from the REQUEST
        context: real API servers omit TypeMeta (kind/apiVersion) on
        the items inside a List response, so dispatching on
        item['kind'] would crash on the very first LIST against a live
        cluster."""
        return FROM_CR[kind](item)

    # kinds whose CRD may legitimately be absent (alpha, feature-gated);
    # a 404 for anything else is a misconfiguration and must fail boot
    OPTIONAL_KINDS = frozenset({"NodeOverlay"})

    def sync(self) -> None:
        """Initial LIST per kind (informer start). A 404 for an
        OPTIONAL kind means its CRD is not installed (e.g. the alpha
        NodeOverlay CRD behind a disabled feature gate): drop the kind
        and keep booting — steady-state _pump tolerates the same
        absence. A 404 for a core kind, or any other error, is a real
        connectivity/configuration problem and fails fast."""
        for kind in list(self.kinds):
            status, body = self._request("list", "GET", _path(kind))
            if status == 404 and kind in self.OPTIONAL_KINDS:
                self.kinds.remove(kind)
                self._mirror.pop(kind, None)
                continue
            if status != 200:
                raise ApiError(status, str(body))
            for item in body.get("items", []):
                obj = self._from_item(kind, item)
                with self._lock:
                    self._mirror[kind][obj.key] = obj
                    self._index_pod(obj)
                    self._last_rv[kind] = max(
                        self._last_rv[kind], obj.metadata.resource_version
                    )

    def _pump(self) -> None:
        """Pull new watch state from the server into the pending queue,
        applying it to the mirror. Two transport styles:

        - event-log (InMemoryApiServer): replay events newer than the
          per-kind high-water resourceVersion;
        - snapshot (HTTPTransport LIST-diff): diff the listed items
          against the mirror, synthesizing DELETED for keys that
          vanished — a real cluster's deletes by OTHER actors must
          reach the mirror even without a streaming watch. Snapshot
          pumps are throttled (snapshot_poll_seconds) because each one
          is an O(cluster) LIST.

        Per-object staleness guard: an item whose rv the mirror already
        reflects is skipped, so a controller's canonical object is
        never replaced by the echo of its own write."""
        if getattr(self.transport, "snapshot_watch", False):
            import time as _time

            interval = getattr(self.transport, "snapshot_poll_seconds", 5.0)
            now = _time.monotonic()
            if now - self._last_pump < interval:
                return
            self._last_pump = now
            for kind in self.kinds:
                # snapshot pump IS a relist per kind (already throttled
                # by snapshot_poll_seconds; not a 410 reaction)
                self._relist(kind, reason="snapshot")
            return
        for kind in self.kinds:
            shard_rv = self._shard_rv.get(kind)
            if shard_rv is None:
                # unsharded (fleet-wide) kind: single logical stream
                try:
                    events = self.transport.watch_events(
                        kind, self._last_rv[kind]
                    )
                except ApiError as err:
                    if err.status == 410:
                        # watch fell off the server's event horizon:
                        # re-LIST and diff (informer relist), then the
                        # next pump restarts the stream at the fresh rv
                        self._relist(kind)
                    continue
                for event, cr, rv in events:
                    with self._lock:
                        self._last_rv[kind] = max(self._last_rv[kind], rv)
                    self._ingest(kind, event, cr, rv)
                continue
            # sharded kind: ONE watch scan per DISTINCT cursor value.
            # Steady state — all shard cursors equal — is a single
            # group covering every shard, i.e. exactly the unsharded
            # scan with zero routing work. After a shard-scoped relist
            # the cursors diverge: each group's pass processes only the
            # events routed to its member shards (every event is owned
            # by exactly one group, so nothing is double-applied), and
            # the groups reconverge as soon as both reach stream head.
            groups: dict[int, list[int]] = {}
            for shard, cursor in enumerate(shard_rv):
                groups.setdefault(cursor, []).append(shard)
            if len(groups) == 1:
                self._tombstones.pop(kind, None)
            gone_shards: set[int] = set()
            for since_rv, members in sorted(groups.items()):
                try:
                    events = self.transport.watch_events(kind, since_rv)
                except ApiError as err:
                    if err.status == 410:
                        gone_shards.update(members)
                    continue
                member_set = (
                    None if len(members) == self._shards else set(members)
                )
                high = since_rv
                for event, cr, rv in events:
                    high = max(high, rv)
                    obj = self._from_item(kind, cr)
                    if member_set is not None and shard_of(
                        route_key(kind, obj), self._shards
                    ) not in member_set:
                        continue  # another group's pass owns this event
                    self._ingest(kind, event, cr, rv, obj=obj,
                                 tombstone=member_set is not None)
                with self._lock:
                    for shard in members:
                        shard_rv[shard] = max(shard_rv[shard], high)
                    self._last_rv[kind] = max(self._last_rv[kind], high)
            if gone_shards:
                # ONE LIST covers every lost shard; a 410 on a subset
                # of shards dirties only that subset's relist epochs
                self._relist(
                    kind,
                    shards=(sorted(gone_shards)
                            if len(gone_shards) < self._shards else None),
                )

    def _ingest(self, kind: str, event: str, cr: dict, rv: int,
                obj=None, tombstone: bool = False) -> None:
        """Apply one watch event to the mirror + pending queue.
        `tombstone` is set by divergent-cursor pump passes: the delete
        is recorded so a behind shard's replay of an older MODIFIED
        cannot resurrect the key (see _tombstones)."""
        if obj is None:
            obj = self._from_item(kind, cr)
        if event == DELETED:
            with self._lock:
                if tombstone:
                    self._tombstones.setdefault(kind, {})[obj.key] = rv
                gone = self._mirror[kind].pop(obj.key, None)
                if gone is not None:
                    # only announce deletes the mirror knew about: our
                    # own deletes were announced at write time, and
                    # never-seen objects have no consumers to notify
                    self._index_pod(gone, removed=True)
                    self._pending_events.append((kind, DELETED, gone))
            return
        self._apply(kind, obj, rv, event)

    def _relist(self, kind: str, reason: str = "watch_gone",
                shards: Optional[list[int]] = None) -> None:
        """Full LIST + mirror diff for one kind (the informer's
        reaction to 410 Gone), synthesizing DELETED for keys that
        vanished while the watch was stale. 410-driven relists are
        BOUNDED (KARPENTER_KUBE_RELIST_MIN_MS, default 500): a
        flapping watch degrades freshness by one bounded interval
        instead of hammering the apiserver with O(cluster) LISTs every
        pump — the 410 stays pending server-side, so a skipped relist
        is retried on the next pump.

        With `shards` given (and the kind sharded), the relist is
        SCOPED: one LIST still hits the server, but only items routed
        to those shards are applied, DELETED is synthesized only for
        mirror keys in those shards, and only those shards' relist
        epochs and cursors advance — every other shard's stream
        continuity (and therefore every other shard's retained rows
        downstream) stays intact."""
        scoped = shards is not None and kind in self._shard_rv
        if reason == "watch_gone":
            import os as _os
            import time as _time

            try:
                min_s = float(_os.environ.get(
                    "KARPENTER_KUBE_RELIST_MIN_MS", "500")) / 1000.0
            except ValueError:
                min_s = 0.5
            now = _time.monotonic()
            if now - self._relist_at.get(kind, float("-inf")) < min_s:
                return
            self._relist_at[kind] = now
            if scoped:
                for shard in shards:
                    STATE_SHARD_RELIST.inc(
                        {"kind": kind, "shard": str(shard)}
                    )
            else:
                KUBE_RELIST.inc({"kind": kind})
        status, body = self._request("list", "GET", _path(kind))
        if status != 200:
            return  # transient; the next pump retries
        if reason == "watch_gone":
            # only 410 relists lose event-stream continuity (snapshot
            # pumps re-LIST every cycle by design); retained-state
            # consumers key "mark everything dirty" off this — scoped
            # to the lost shards when the stream loss was scoped
            with self._lock:
                self._relist_gen[kind] = self._relist_gen.get(kind, 0) + 1
                gens = self._shard_relist_gen.get(kind)
                if gens is not None:
                    for shard in (shards if scoped
                                  else range(self._shards)):
                        gens[shard] += 1
        shard_set = set(shards) if scoped else None
        live_keys = set()
        for item in body.get("items", []):
            rv = int(item["metadata"].get("resourceVersion", "0") or 0)
            obj = self._from_item(kind, item)
            if shard_set is not None and shard_of(
                route_key(kind, obj), self._shards
            ) not in shard_set:
                continue  # other shards' mirror rows stay untouched
            live_keys.add(obj.key)
            self._apply(kind, obj, rv)
        with self._lock:
            list_rv = int(
                body.get("metadata", {}).get("resourceVersion", "0") or 0
            )
            stale = [
                key for key, cur in self._mirror[kind].items()
                if key not in live_keys and (
                    shard_set is None or shard_of(
                        route_key(kind, cur), self._shards
                    ) in shard_set
                )
            ]
            for key in stale:
                gone = self._mirror[kind].pop(key)
                self._index_pod(gone, removed=True)
                self._pending_events.append((kind, DELETED, gone))
                if shard_set is not None:
                    self._tombstones.setdefault(kind, {})[key] = list_rv
            self._last_rv[kind] = max(self._last_rv[kind], list_rv)
            cursors = self._shard_rv.get(kind)
            if cursors is not None:
                for shard in (shard_set if shard_set is not None
                              else range(self._shards)):
                    cursors[shard] = max(cursors[shard], list_rv)

    def close(self) -> None:
        """Tear down transport-side watch machinery (stream threads)."""
        close = getattr(self.transport, "close", None)
        if close is not None:
            close()

    def _apply(self, kind: str, obj, rv: int, event: str = MODIFIED) -> None:
        """Merge one fresh object into the mirror, preserving the
        identity of the canonical instance controllers hold."""
        with self._lock:
            tomb = self._tombstones.get(kind)
            if tomb is not None and rv <= tomb.get(obj.key, -1):
                # a behind shard replaying a pre-delete event must not
                # resurrect a key another shard already deleted
                return
            current = self._mirror[kind].get(obj.key)
            if current is not None and current.metadata.resource_version >= rv:
                return  # self-echo or stale replay
            if current is not None:
                # refresh the CANONICAL instance in place so controller
                # references stay valid (informer cache replace, minus
                # the identity break)
                _refresh_in_place(current, obj)
                obj = current
            else:
                self._mirror[kind][obj.key] = obj
                event = ADDED
            self._index_pod(obj)
            self._pending_events.append((kind, event, obj))

    def set_event_pending_hook(self, hook) -> None:
        """Register a cheap thread-safe callable fired whenever watch
        events are pending delivery (the operator's reactive wake)."""
        self._event_pending_hook = hook
        forward = getattr(self.transport, "set_event_hook", None)
        if forward is not None and hook is not None:
            forward(lambda _kind: hook())

    def watch(self, kind: str, handler: WatchHandler) -> None:
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            for obj in self._mirror.get(kind, {}).values():
                handler(ADDED, obj)

    def deliver(self, limit: Optional[int] = None) -> int:
        self._pump()
        with self._lock:
            n = len(self._pending_events) if limit is None else min(
                limit, len(self._pending_events)
            )
            batch = self._pending_events[:n]
            del self._pending_events[:n]
        for kind, event, obj in batch:
            for handler in self._watchers.get(kind, []):
                handler(event, obj)
        return n

    def pending_events(self, kinds: Optional[Iterable[str]] = None) -> int:
        with self._lock:
            if kinds is None:
                return len(self._pending_events)
            wanted = set(kinds)
            return sum(1 for k, _, _ in self._pending_events if k in wanted)

    # -- writes ----------------------------------------------------------

    def _graft(self, obj, fresh_cr: dict) -> None:
        """Adopt the server's fresh state onto the canonical instance
        in place (identity preserved — the same refresh the informer
        _apply does, just ahead of the pump)."""
        _refresh_in_place(obj, self._from_item(obj.kind, fresh_cr))

    @staticmethod
    def _sans_stamps(cr: dict) -> dict:
        """A CR with the server-stamped metadata fields removed, for
        did-my-write-land comparisons."""
        out = json.loads(json.dumps(cr))
        meta = out.get("metadata") or {}
        meta.pop("resourceVersion", None)
        meta.pop("generation", None)
        return out

    def _push(self, method: str, obj, path: str, mutate=None) -> None:
        """Write `obj`; conflict-aware (controller-runtime's
        RetryOnConflict shape). On a 409 the hook re-GETs the server
        copy and decides:

        - server rv == ours: spurious conflict (an injected fault or a
          proxy flake) — the state never moved, re-send as-is;
        - server content == ours modulo stamps AND a prior attempt of
          THIS call lost its response (5xx in the history): OUR write
          landed (write-partial) — adopt the server rv, done. The
          history gate matters: without it, a concurrent writer
          landing IDENTICAL content would be mistaken for our own
          write and a CAS caller would silently lose an update;
        - genuine divergence: re-apply the caller's `mutate` fn on the
          refreshed object and retry (read-modify-write); without a
          mutation fn the conflict is the CALLER's to resolve —
          ConflictError, exactly as before, never last-write-wins.
        """
        get_path = _path(obj.kind, obj.metadata.name, obj.metadata.namespace)
        resolved: dict = {}
        vanished: dict = {}

        def on_conflict(history=()) -> bool:
            st, fresh = self._request("get", "GET", get_path)
            if st == 404:
                # nothing there: a POST's injected conflict (re-send);
                # a PUT's target vanished — that is a NotFound, not a
                # Conflict (a real apiserver would answer the PUT 404),
                # so touch()'s gone-object-is-a-no-op contract holds
                if method == "PUT":
                    vanished["msg"] = fresh.get("message", obj.key)
                return method == "POST"
            if st != 200:
                return False
            fresh_rv = int(
                fresh.get("metadata", {}).get("resourceVersion", "0") or 0
            )
            ours = to_cr(obj)
            if method == "PUT" and fresh_rv == int(
                ours.get("metadata", {}).get("resourceVersion", "0") or 0
            ):
                return True  # spurious: state unmoved, re-send as-is
            if any(s >= 500 for s in history) and (
                self._sans_stamps(fresh) == self._sans_stamps(ours)
            ):
                resolved["rv"] = fresh_rv  # our lost-response write landed
                return False
            if mutate is None or method == "POST":
                # genuine conflict, the CALLER resolves (ConflictError).
                # For PUTs, adopt the server truth onto the canonical
                # object first, so the caller's retry cycle (re-read ->
                # re-apply -> update) works from current state
                # immediately instead of losing a race to the next
                # informer pump — their intended write is already lost
                # either way, that is what the 409 says.
                if method == "PUT":
                    self._graft(obj, fresh)
                return False
            # true read-modify-write: graft the SERVER's fresh state
            # onto the canonical instance, then re-apply the caller's
            # mutation on top — the remote actor's fields survive,
            # ours land
            self._graft(obj, fresh)
            mutate(obj)
            return True

        status, body = self._request(
            "create" if method == "POST" else "update", method, path,
            body_fn=lambda: to_cr(obj), on_conflict=on_conflict,
        )
        if status == 409 and resolved:
            obj.metadata.resource_version = resolved["rv"]
            return
        if status == 409 and vanished:
            raise NotFoundError(vanished["msg"])
        if status == 409:
            raise ConflictError(body.get("message", "conflict"))
        if status == 404:
            raise NotFoundError(body.get("message", obj.key))
        if status == 422:
            raise InvalidError(body.get("message", "invalid"))
        if status >= 400:
            raise ApiError(status, body.get("message", ""))
        new_rv = int(
            body.get("metadata", {}).get("resourceVersion", "0") or 0
        )
        if new_rv:
            # stamp the server-assigned rv on the canonical object (the
            # per-object guard in _apply then dedupes the watch echo).
            # Deliberately do NOT advance the per-kind _last_rv here: a
            # concurrent remote event with a lower rv than our write
            # has not been pumped yet, and skipping past it would drop
            # it forever.
            obj.metadata.resource_version = new_rv

    def _announce(self, kind: str, event: str, obj) -> None:
        """Queue a watch event for a SELF-originated write: the pump
        dedupes the server's echo by resourceVersion, so local handlers
        would otherwise never hear about this process's own mutations
        (the in-memory client announces every write; controllers rely
        on it — DirtyTracker, state informers, the batcher hook)."""
        with self._lock:
            self._pending_events.append((kind, event, obj))
        if self._event_pending_hook is not None:
            try:
                self._event_pending_hook()
            except Exception:
                pass

    def create(self, obj):
        self._push("POST", obj, _path(obj.kind, namespace=obj.metadata.namespace))
        obj.metadata.generation = 1
        if obj.kind not in self._mirror:
            return obj  # write-only kind (Events): push, don't cache
        with self._lock:
            self._mirror[obj.kind][obj.key] = obj
            self._index_pod(obj)
        self._announce(obj.kind, ADDED, obj)
        return obj

    def update(self, obj, mutate=None):
        """Write the object back. `mutate` (optional) is the caller's
        intended mutation as a FUNCTION of the object — applied before
        the first attempt and RE-applied after each conflict re-GET,
        so a racy write converges to read-modify-write instead of
        last-write-wins."""
        if mutate is not None:
            mutate(obj)
        self._push(
            "PUT", obj,
            _path(obj.kind, obj.metadata.name, obj.metadata.namespace),
            mutate=mutate,
        )
        if obj.kind not in self._mirror:
            return obj  # write-only kind (Events): push, don't cache
        with self._lock:
            self._mirror[obj.kind][obj.key] = obj
            self._index_pod(obj)
        self._announce(obj.kind, MODIFIED, obj)
        return obj

    def relist_generation(self, kind: str) -> int:
        """Monotone count of 410-driven relists for one kind — the
        lost-continuity signal DirtyTracker.relisted latches."""
        with self._lock:
            return self._relist_gen.get(kind, 0)

    def relist_generations(self, kind: str) -> dict[int, int]:
        """Per-shard relist generations for one kind (empty for
        unsharded kinds) — the scoped lost-continuity signal
        DirtyTracker.relisted_shards latches. A full-stream relist
        bumps every shard's generation, so shard-aware consumers see
        it as all-shards-dirty (the merged contract's reading)."""
        with self._lock:
            gens = self._shard_relist_gen.get(kind)
            if gens is None:
                return {}
            return {shard: gen for shard, gen in enumerate(gens)}

    def touch(self, obj) -> None:
        """In-place mutations must land on the server: touch IS update
        here (the in-memory client's free local touch has no remote
        analogue). Like the in-memory touch, an object that is already
        gone (deleted between the mutation and the announce) is a
        no-op, not an error."""
        with self._lock:
            if self._mirror.get(obj.kind, {}).get(obj.key) is not obj:
                return
        try:
            self.update(obj)
        except NotFoundError:
            with self._lock:
                self._mirror[obj.kind].pop(obj.key, None)

    def evict(self, pod, now: Optional[float] = None):
        """Drain through the policy/v1 Eviction subresource so the API
        SERVER enforces PDBs (terminator/eviction.go:170-185): 429 maps
        to EvictionBlockedError for the caller's backoff queue; an
        already-gone pod is success."""
        path = _path("Pod", pod.metadata.name, pod.metadata.namespace)
        # eviction is idempotent server-side: a racy/injected 409 is
        # safely re-sent (the PDB-blocked 429 still passes through)
        status, body = self._request("evict", "POST", path + "/eviction", {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod.metadata.name,
                         "namespace": pod.metadata.namespace},
        }, on_conflict=lambda *_: True)
        if status == 404:
            with self._lock:
                self._mirror["Pod"].pop(pod.key, None)
                self._index_pod(pod, removed=True)
            # in-process watch subscribers (dirty trackers, cluster
            # state) must see the deletion like the post-eviction gone
            # path below — without the announce they'd only learn of
            # it from a later stream event or relist
            self._announce("Pod", DELETED, pod)
            return None
        if status == 429:
            causes = (body.get("details") or {}).get("causes") or [{}]
            raise EvictionBlockedError(causes[0].get("message", ""))
        if status >= 400:
            raise ApiError(status, body.get("message", ""))
        # A REAL apiserver answers eviction with a Status object, not
        # the pod; the in-memory one returns the pod CR. When the body
        # carries no deletionTimestamp, GET the pod to learn whether it
        # is terminating (grace period / finalizers) or already gone.
        if not (body and body.get("metadata", {}).get("deletionTimestamp")):
            st, got = self._request("get", "GET", path)
            body = got if st == 200 else {}
        # mirror bookkeeping identical to delete(): either the pod is
        # wedged terminating behind a finalizer or it is gone
        if body and body.get("metadata", {}).get("deletionTimestamp"):
            from karpenter_tpu_torch.kube.serialize import ts_from_rfc3339

            pod.metadata.deletion_timestamp = (
                now if now is not None else ts_from_rfc3339(
                    body["metadata"]["deletionTimestamp"]
                )
            )
            pod.metadata.resource_version = int(
                body["metadata"].get("resourceVersion", "0") or 0
            )
            self._announce("Pod", MODIFIED, pod)
            return pod
        with self._lock:
            self._mirror["Pod"].pop(pod.key, None)
            self._index_pod(pod, removed=True)
        self._announce("Pod", DELETED, pod)
        return None

    def delete(self, obj_or_kind, key: Optional[str] = None,
               now: Optional[float] = None):
        if isinstance(obj_or_kind, str):
            obj = self.get(obj_or_kind, key)
        else:
            obj = self.get(obj_or_kind.kind, obj_or_kind.key)
        if obj is None:
            return None
        # deletes carry no resourceVersion precondition here: a
        # racy/injected 409 is safely re-sent (idempotent)
        status, body = self._request(
            "delete", "DELETE",
            _path(obj.kind, obj.metadata.name, obj.metadata.namespace),
            on_conflict=lambda *_: True,
        )
        if status == 404:
            # already gone server-side (another actor, or OUR earlier
            # delete whose response was lost and the wrapper retried):
            # in-process subscribers must still hear the deletion —
            # the server's DELETED echo skips keys the mirror already
            # dropped, so without this announce they never would
            with self._lock:
                self._mirror[obj.kind].pop(obj.key, None)
                self._index_pod(obj, removed=True)
            self._announce(obj.kind, DELETED, obj)
            return None
        if status >= 400:
            raise ApiError(status, body.get("message", ""))
        if body and body.get("metadata", {}).get("deletionTimestamp"):
            from karpenter_tpu_torch.kube.serialize import ts_from_rfc3339

            obj.metadata.deletion_timestamp = (
                now if now is not None else ts_from_rfc3339(
                    body["metadata"]["deletionTimestamp"]
                )
            )
            obj.metadata.resource_version = int(
                body["metadata"].get("resourceVersion", "0") or 0
            )
            self._announce(obj.kind, MODIFIED, obj)
            return obj
        with self._lock:
            self._mirror[obj.kind].pop(obj.key, None)
            self._index_pod(obj, removed=True)
        self._announce(obj.kind, DELETED, obj)
        return None

    def remove_finalizer(self, obj, finalizer: str) -> None:
        if finalizer in obj.metadata.finalizers:
            obj.metadata.finalizers.remove(finalizer)
        try:
            self.update(obj)
        except NotFoundError:
            # already finalized server-side (another actor removed the
            # last finalizer first) — the in-memory client's
            # remove_finalizer never raises here either, and controllers
            # rely on that tolerance
            pass
        if obj.metadata.deletion_timestamp is not None and not (
            obj.metadata.finalizers
        ):
            with self._lock:
                self._mirror[obj.kind].pop(obj.key, None)
                self._index_pod(obj, removed=True)
            self._announce(obj.kind, DELETED, obj)

    def bind_pod(self, pod, node_name: str) -> None:
        # bindings are idempotent toward the same target: a
        # racy/injected 409 is safely re-sent
        status, body = self._request(
            "bind", "POST",
            _path("Pod", pod.metadata.name, pod.metadata.namespace)
            + "/binding",
            {"target": {"kind": "Node", "name": node_name}},
            on_conflict=lambda *_: True,
        )
        if status >= 400:
            raise ApiError(status, body.get("message", ""))
        pod.spec.node_name = node_name
        with self._lock:
            self._index_pod(pod)
        self._announce("Pod", MODIFIED, pod)

    # -- reads (mirror) ---------------------------------------------------

    def get(self, kind: str, key: str):
        with self._lock:
            return self._mirror.get(kind, {}).get(key)

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[LabelSelector] = None) -> list:
        if kind in UNMAPPED_KINDS:
            return []
        with self._lock:
            out = []
            for obj in self._mirror.get(kind, {}).values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if selector is not None and not selector.matches(
                    obj.metadata.labels
                ):
                    continue
                out.append(obj)
            return out

    def _index_pod(self, obj, removed: bool = False) -> None:
        if obj.kind != "Pod":
            return
        old = self._pod_node.get(obj.key)
        new = "" if removed else obj.spec.node_name
        if old == new:
            return
        if old:
            self._pods_by_node.get(old, set()).discard(obj.key)
        if new:
            self._pods_by_node.setdefault(new, set()).add(obj.key)
            self._pod_node[obj.key] = new
        else:
            self._pod_node.pop(obj.key, None)

    def pods_on_node(self, node_name: str) -> list:
        with self._lock:
            keys = self._pods_by_node.get(node_name)
            if not keys:
                return []
            bucket = self._mirror.get("Pod", {})
            return [bucket[k] for k in keys if k in bucket]

    # -- typed sugar (KubeClient parity) ----------------------------------

    def pods(self, namespace=None, selector=None):
        return self.list("Pod", namespace, selector)

    def nodes(self):
        return self.list("Node")

    def node_claims(self):
        return self.list("NodeClaim")

    def node_pools(self):
        return self.list("NodePool")

    def daemon_sets(self):
        return self.list("DaemonSet")

    def pdbs(self):
        return self.list("PodDisruptionBudget")

    def csi_nodes(self):
        return self.list("CSINode")

    def get_pod(self, namespace: str, name: str):
        return self.get("Pod", f"{namespace}/{name}")

    def get_node(self, name: str):
        return self.get("Node", name)

    def get_node_claim(self, name: str):
        return self.get("NodeClaim", name)

    def get_node_pool(self, name: str):
        return self.get("NodePool", name)

    def get_pvc(self, namespace: str, name: str):
        return self.get("PersistentVolumeClaim", f"{namespace}/{name}")

    def get_storage_class(self, name: str):
        return self.get("StorageClass", name)

    def get_pv(self, name: str):
        return self.get("PersistentVolume", name)

    def get_csi_node(self, name: str):
        return self.get("CSINode", name)
