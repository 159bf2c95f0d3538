"""Envtest-analogue: a real HTTP(S) Kubernetes API server over InMemoryKube.

The reference's integration tier runs against envtest — a real
kube-apiserver + etcd with no kubelet (SURVEY.md §4 tier 2,
e.g. pkg/controller/constrainttemplate/constrainttemplate_controller_suite_test.go:40).
This module plays that role for the TPU build: it serves the actual
Kubernetes REST protocol (discovery, CRUD verbs with real status codes,
resourceVersion semantics, `limit`/`continue` pagination, streaming
watches with resume and 410 Gone, the status subresource, bearer-token
auth, TLS) backed by the InMemoryKube store, so HttpKube — the client the
product ships — is exercised end-to-end over the wire.

Faithfulness notes:
- CRDs (apiextensions v1 and v1beta1 shapes) register their served
  versions into discovery and gain an Established condition, optionally
  after a delay, so clients exercise the establishment wait.
- Types whose CRD declares the status subresource get real subresource
  semantics: status dropped on create, preserved on spec PUT, writable
  only via PUT .../status (what Status().Update hits in the reference,
  audit manager.go:604).
- Watch resume is gap-free: a global event hook records every event with
  its resourceVersion; resuming below the retained window returns 410,
  forcing the client down the relist path (informer Replace()).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .inmem import GVK, Conflict, InMemoryKube, NotFound, WatchEvent, gvk_of

CRD_KINDS = {
    ("apiextensions.k8s.io", "v1", "CustomResourceDefinition"),
    ("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition"),
}

# (group, version, kind, plural, namespaced, has_status)
BUILTIN_TYPES = [
    ("", "v1", "Namespace", "namespaces", False, True),
    ("", "v1", "Pod", "pods", True, True),
    ("", "v1", "Secret", "secrets", True, False),
    ("", "v1", "ConfigMap", "configmaps", True, False),
    ("", "v1", "Service", "services", True, True),
    ("", "v1", "Event", "events", True, False),
    ("", "v1", "Node", "nodes", False, True),
    ("apps", "v1", "Deployment", "deployments", True, True),
    ("apps", "v1", "ReplicaSet", "replicasets", True, True),
    ("apps", "v1", "DaemonSet", "daemonsets", True, True),
    ("apps", "v1", "StatefulSet", "statefulsets", True, True),
    ("admissionregistration.k8s.io", "v1", "ValidatingWebhookConfiguration",
     "validatingwebhookconfigurations", False, False),
    ("apiextensions.k8s.io", "v1", "CustomResourceDefinition",
     "customresourcedefinitions", False, True),
    ("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition",
     "customresourcedefinitions", False, True),
]


class _TypeInfo:
    __slots__ = ("gvk", "plural", "namespaced", "has_status")

    def __init__(self, gvk: GVK, plural: str, namespaced: bool,
                 has_status: bool):
        self.gvk = gvk
        self.plural = plural
        self.namespaced = namespaced
        self.has_status = has_status


def _status_doc(code: int, reason: str, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "code": code, "reason": reason, "message": message}


class KubeApiServer:
    """Serve an InMemoryKube over the Kubernetes REST protocol."""

    def __init__(self, kube: Optional[InMemoryKube] = None,
                 token: Optional[str] = None,
                 tls: Optional[Tuple[str, str]] = None,
                 establish_delay_s: float = 0.0,
                 watch_history: int = 4096):
        self.kube = kube or InMemoryKube()
        self.token = token
        self.tls = tls
        self.establish_delay_s = establish_delay_s
        self.watch_history = watch_history
        self._lock = threading.RLock()
        # (group, version, plural) -> _TypeInfo; and gvk -> _TypeInfo
        self._by_plural: Dict[Tuple[str, str, str], _TypeInfo] = {}
        self._by_gvk: Dict[GVK, _TypeInfo] = {}
        for g, v, k, plural, namespaced, has_status in BUILTIN_TYPES:
            self.register_resource(g, v, k, plural, namespaced, has_status)
        # event history for watch resume: gvk -> deque[(seq, WatchEvent)]
        self._history: Dict[GVK, deque] = {}
        self._compacted_below: Dict[GVK, int] = {}
        self._subscribers: Dict[GVK, List[queue.Queue]] = {}
        # snapshot continuations for paginated lists:
        # token -> (snapshot resourceVersion, remaining items)
        import itertools

        self._cont_seq = itertools.count(1)
        self._continuations: Dict[str, Tuple[str, List[dict]]] = {}
        self.kube.on_event = self._record_event
        # register types for any CRDs already present in the store
        for crd in self.kube.list(
                ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")):
            self._register_crd(crd)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.port = 0

    # ---- type registry -----------------------------------------------------

    def register_resource(self, group: str, version: str, kind: str,
                          plural: str, namespaced: bool,
                          has_status: bool = False):
        info = _TypeInfo((group, version, kind), plural, namespaced,
                         has_status)
        with self._lock:
            self._by_plural[(group, version, plural)] = info
            self._by_gvk[(group, version, kind)] = info

    def _register_crd(self, crd: dict):
        spec = crd.get("spec") or {}
        group = spec.get("group", "")
        names = spec.get("names") or {}
        plural = names.get("plural", "")
        kind = names.get("kind", "")
        namespaced = spec.get("scope", "Namespaced") == "Namespaced"
        spec_sub = bool((spec.get("subresources") or {}).get("status")
                        is not None)
        versions = spec.get("versions") or []
        if not versions and spec.get("version"):
            versions = [{"name": spec["version"], "served": True}]
        for ver in versions:
            if not ver.get("served", True):
                continue
            has_status = spec_sub or bool(
                (ver.get("subresources") or {}).get("status") is not None)
            self.register_resource(group, ver["name"], kind, plural,
                                   namespaced, has_status)

    def _establish_crd(self, crd: dict):
        """Mark Established (after the configured delay) and register the
        served versions into discovery — what the real apiserver's CRD
        controller does and what clients wait on."""

        def establish():
            if self.establish_delay_s:
                time.sleep(self.establish_delay_s)
            self._register_crd(crd)
            name = crd.get("metadata", {}).get("name", "")
            try:
                cur = self.kube.get(gvk_of(crd), name)
            except NotFound:
                return
            cur.setdefault("status", {})["conditions"] = [
                {"type": "Established", "status": "True"},
                {"type": "NamesAccepted", "status": "True"},
            ]
            try:
                self.kube.update(cur, check_version=True)
            except (Conflict, NotFound):
                pass

        if self.establish_delay_s:
            threading.Thread(target=establish, daemon=True).start()
        else:
            establish()

    # ---- event history (watch resume) -------------------------------------

    def _record_event(self, gvk: GVK, ev: WatchEvent):
        rv = int(ev.object.get("metadata", {}).get("resourceVersion", 0))
        with self._lock:
            hist = self._history.setdefault(
                gvk, deque(maxlen=self.watch_history))
            if len(hist) == hist.maxlen and hist:
                self._compacted_below[gvk] = hist[0][0]
            hist.append((rv, ev))
            for q in self._subscribers.get(gvk, []):
                q.put(ev)

    def _subscribe(self, gvk: GVK, since_rv: int):
        """Atomically collect history > since_rv and register a live queue.
        Returns (backlog, queue) or raises _GoneError."""
        with self._lock:
            if since_rv and since_rv < self._compacted_below.get(gvk, 0):
                raise _GoneError()
            backlog = [ev for seq, ev in self._history.get(gvk, ())
                       if seq > since_rv]
            # gklint: disable=unbounded-queue -- watch fan-out is bounded by
            # cluster churn, and a slow consumer must see every event (dropping
            # one silently desyncs its cache); backpressure is the RV resync
            q: queue.Queue = queue.Queue()
            self._subscribers.setdefault(gvk, []).append(q)
            return backlog, q

    def _unsubscribe(self, gvk: GVK, q: queue.Queue):
        with self._lock:
            try:
                self._subscribers.get(gvk, []).remove(q)
            except ValueError:
                pass

    def kill_watches(self):
        """Force-drop every active watch stream (chaos/testing hook)."""
        with self._lock:
            for qs in self._subscribers.values():
                for q in qs:
                    q.put(None)

    # ---- server lifecycle --------------------------------------------------

    def start(self, port: int = 0) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                outer._dispatch(self, "GET")

            def do_POST(self):
                outer._dispatch(self, "POST")

            def do_PUT(self):
                outer._dispatch(self, "PUT")

            def do_DELETE(self):
                outer._dispatch(self, "DELETE")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*self.tls)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="kube-apiserver", daemon=True).start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}"

    # ---- request handling --------------------------------------------------

    def _dispatch(self, h: BaseHTTPRequestHandler, method: str):
        try:
            if self.token is not None:
                auth = h.headers.get("Authorization", "")
                if auth != f"Bearer {self.token}":
                    return self._send(h, 401, _status_doc(
                        401, "Unauthorized", "invalid bearer token"))
            path, _, query = h.path.partition("?")
            params = {}
            for part in query.split("&"):
                if "=" in part:
                    k, v = part.split("=", 1)
                    params[k] = v
            segs = [s for s in path.split("/") if s]
            body = None
            length = int(h.headers.get("Content-Length") or 0)
            if length:
                body = json.loads(h.rfile.read(length))
            self._route(h, method, segs, params, body)
        except BrokenPipeError:
            pass
        except Exception as exc:  # noqa: BLE001 — surface as 500 Status
            try:
                self._send(h, 500, _status_doc(
                    500, "InternalError", f"{type(exc).__name__}: {exc}"))
            except OSError:
                pass  # client already hung up; nothing left to tell it

    def _send(self, h, code: int, doc: dict):
        payload = json.dumps(doc).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)

    def _route(self, h, method: str, segs: List[str], params: dict,
               body: Optional[dict]):
        # discovery
        if segs == ["api"]:
            return self._send(h, 200, {"kind": "APIVersions",
                                       "versions": ["v1"]})
        if segs == ["apis"]:
            return self._send(h, 200, self._group_list())
        if len(segs) == 2 and segs[0] == "api":
            return self._send(h, 200, self._resource_list("", segs[1]))
        if len(segs) == 3 and segs[0] == "apis":
            return self._send(h, 200, self._resource_list(segs[1], segs[2]))

        # resource routes
        if segs[0] == "api" and len(segs) >= 3:
            group, version, rest = "", segs[1], segs[2:]
        elif segs[0] == "apis" and len(segs) >= 4:
            group, version, rest = segs[1], segs[2], segs[3:]
        else:
            return self._send(h, 404, _status_doc(
                404, "NotFound", f"unknown path /{'/'.join(segs)}"))

        namespace = ""
        if rest and rest[0] == "namespaces" and len(rest) >= 3:
            # /namespaces/<ns>/<plural>/... — but /api/v1/namespaces/<name>
            # (the Namespace resource itself) has len == 2 and is handled
            # by the plural route below
            namespace, rest = rest[1], rest[2:]
        plural = rest[0] if rest else ""
        name = rest[1] if len(rest) > 1 else ""
        subresource = rest[2] if len(rest) > 2 else ""

        with self._lock:
            info = self._by_plural.get((group, version, plural))
        if info is None:
            return self._send(h, 404, _status_doc(
                404, "NotFound",
                f"the server could not find the requested resource "
                f"({group}/{version} {plural})"))
        if subresource and subresource != "status":
            return self._send(h, 404, _status_doc(
                404, "NotFound", f"unknown subresource {subresource}"))
        if subresource == "status" and not info.has_status:
            return self._send(h, 404, _status_doc(
                404, "NotFound",
                f"{plural}/{name} has no status subresource"))

        if not name:
            if method == "GET" and params.get("watch") in ("1", "true"):
                return self._serve_watch(h, info, params, namespace)
            if method == "GET":
                return self._serve_list(h, info, namespace, params)
            if method == "POST":
                return self._serve_create(h, info, namespace, body)
            return self._send(h, 405, _status_doc(
                405, "MethodNotAllowed", method))

        if method == "GET":
            return self._serve_get(h, info, namespace, name)
        if method == "PUT":
            return self._serve_put(h, info, namespace, name, subresource,
                                   body)
        if method == "DELETE":
            return self._serve_delete(h, info, namespace, name)
        return self._send(h, 405, _status_doc(405, "MethodNotAllowed",
                                              method))

    # ---- discovery docs ----------------------------------------------------

    def _group_list(self) -> dict:
        with self._lock:
            groups: Dict[str, List[str]] = {}
            for (g, v, _plural) in self._by_plural:
                if g:
                    groups.setdefault(g, [])
                    if v not in groups[g]:
                        groups[g].append(v)
        return {
            "kind": "APIGroupList",
            "groups": [
                {
                    "name": g,
                    "versions": [{"groupVersion": f"{g}/{v}", "version": v}
                                 for v in vs],
                    "preferredVersion": {"groupVersion": f"{g}/{vs[0]}",
                                         "version": vs[0]},
                }
                for g, vs in sorted(groups.items())
            ],
        }

    def _resource_list(self, group: str, version: str) -> dict:
        with self._lock:
            resources = []
            for (g, v, plural), info in sorted(self._by_plural.items()):
                if (g, v) != (group, version):
                    continue
                resources.append({
                    "name": plural,
                    "singularName": "",
                    "namespaced": info.namespaced,
                    "kind": info.gvk[2],
                    "verbs": ["create", "delete", "get", "list", "patch",
                              "update", "watch"],
                })
                if info.has_status:
                    resources.append({
                        "name": f"{plural}/status",
                        "singularName": "",
                        "namespaced": info.namespaced,
                        "kind": info.gvk[2],
                        "verbs": ["get", "update", "patch"],
                    })
        gv = f"{group}/{version}" if group else version
        return {"kind": "APIResourceList", "groupVersion": gv,
                "resources": resources}

    # ---- verbs -------------------------------------------------------------

    def _serve_get(self, h, info: _TypeInfo, namespace: str, name: str):
        try:
            obj = self.kube.get(info.gvk, name, namespace)
        except NotFound:
            return self._send(h, 404, _status_doc(
                404, "NotFound", f"{info.plural} {namespace}/{name} "
                "not found"))
        return self._send(h, 200, obj)

    def _serve_list(self, h, info: _TypeInfo, namespace: str, params: dict):
        limit = int(params.get("limit") or 0)
        cont_token = params.get("continue") or ""
        if cont_token:
            # consistent-snapshot continuation, as the real apiserver:
            # later pages come from the snapshot taken at the first page —
            # INCLUDING its resourceVersion, so a list+watch that paginates
            # resumes the watch from the snapshot RV and cannot skip events
            # that landed between pages
            with self._lock:
                popped = self._continuations.pop(cont_token, None)
            if popped is None:
                return self._send(h, 410, _status_doc(
                    410, "Expired", "continue token expired"))
            snapshot_rv, items = popped
        else:
            # RV read BEFORE the list: a write interleaving between the two
            # reads then yields duplicate replay on watch resume (safe),
            # never a skipped event
            snapshot_rv = self.kube.current_rv()
            items = self.kube.list(info.gvk, namespace or None)
        meta = {"resourceVersion": snapshot_rv}
        if limit and limit < len(items):
            page, remainder = items[:limit], items[limit:]
            token = f"c{next(self._cont_seq)}"
            with self._lock:
                self._continuations[token] = (snapshot_rv, remainder)
                while len(self._continuations) > 64:  # bound leaked tokens
                    self._continuations.pop(
                        next(iter(self._continuations)))
            meta["continue"] = token
        else:
            page = items
        gv = (f"{info.gvk[0]}/{info.gvk[1]}" if info.gvk[0]
              else info.gvk[1])
        return self._send(h, 200, {
            "kind": info.gvk[2] + "List",
            "apiVersion": gv,
            "metadata": meta,
            "items": page,
        })

    def _serve_create(self, h, info: _TypeInfo, namespace: str,
                      body: Optional[dict]):
        if body is None:
            return self._send(h, 400, _status_doc(400, "BadRequest",
                                                  "empty body"))
        if info.namespaced:
            body.setdefault("metadata", {}).setdefault(
                "namespace", namespace)
            if not body["metadata"].get("namespace"):
                return self._send(h, 400, _status_doc(
                    400, "BadRequest", "namespace required"))
        if info.has_status and info.gvk not in CRD_KINDS:
            body.pop("status", None)  # status writable only via /status
        try:
            stored = self.kube.create(body)
        except Conflict:
            meta = body.get("metadata", {})
            return self._send(h, 409, _status_doc(
                409, "AlreadyExists",
                f"{info.plural} \"{meta.get('name')}\" already exists"))
        if info.gvk in CRD_KINDS:
            self._establish_crd(stored)
            try:  # re-read: establishment may have stamped conditions
                stored = self.kube.get(
                    info.gvk, stored["metadata"]["name"])
            except NotFound:
                pass
        return self._send(h, 201, stored)

    def _serve_put(self, h, info: _TypeInfo, namespace: str, name: str,
                   subresource: str, body: Optional[dict]):
        if body is None:
            return self._send(h, 400, _status_doc(400, "BadRequest",
                                                  "empty body"))
        body.setdefault("metadata", {}).setdefault("name", name)
        if info.namespaced:
            body["metadata"].setdefault("namespace", namespace)
        check = bool(body.get("metadata", {}).get("resourceVersion"))
        try:
            if subresource == "status":
                stored = self.kube.update(body, check_version=check,
                                          subresource="status")
            else:
                if info.has_status and info.gvk not in CRD_KINDS:
                    # spec PUT cannot touch status: restore stored status
                    try:
                        cur = self.kube.get(info.gvk, name, namespace)
                        if "status" in cur:
                            body["status"] = cur["status"]
                        else:
                            body.pop("status", None)
                    except NotFound:
                        pass
                stored = self.kube.update(body, check_version=check)
        except NotFound:
            return self._send(h, 404, _status_doc(
                404, "NotFound", f"{info.plural} {namespace}/{name}"))
        except Conflict as exc:
            return self._send(h, 409, _status_doc(409, "Conflict",
                                                  str(exc)))
        if info.gvk in CRD_KINDS:
            self._establish_crd(stored)
        return self._send(h, 200, stored)

    def _serve_delete(self, h, info: _TypeInfo, namespace: str, name: str):
        if self.kube.delete(info.gvk, name, namespace):
            return self._send(h, 200, _status_doc(200, "Success", "deleted")
                              | {"status": "Success"})
        return self._send(h, 404, _status_doc(
            404, "NotFound", f"{info.plural} {namespace}/{name}"))

    # ---- watch streaming ---------------------------------------------------

    def _serve_watch(self, h, info: _TypeInfo, params: dict,
                     namespace: str = ""):
        since_rv = int(params.get("resourceVersion") or 0)
        try:
            backlog, q = self._subscribe(info.gvk, since_rv)
        except _GoneError:
            return self._send(h, 410, _status_doc(
                410, "Expired",
                f"too old resource version: {since_rv}"))

        def in_scope(ev) -> bool:
            if not namespace:
                return True
            return (ev.object.get("metadata", {}).get("namespace")
                    == namespace)
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()

        def write_chunk(data: bytes):
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        try:
            for ev in backlog:
                if not in_scope(ev):
                    continue
                write_chunk(json.dumps(
                    {"type": ev.type, "object": ev.object}).encode() + b"\n")
            while True:
                try:
                    ev = q.get(timeout=30.0)
                except queue.Empty:
                    # bookmark keeps the stream warm and advances client RV
                    write_chunk(json.dumps({
                        "type": "BOOKMARK",
                        "object": {"metadata": {"resourceVersion":
                                                self.kube.current_rv()}},
                    }).encode() + b"\n")
                    continue
                if ev is None:  # kill_watches()
                    break
                if not in_scope(ev):
                    continue
                write_chunk(json.dumps(
                    {"type": ev.type, "object": ev.object}).encode() + b"\n")
        except (BrokenPipeError, ConnectionError, OSError):
            pass
        finally:
            self._unsubscribe(info.gvk, q)
            try:
                write_chunk(b"")  # terminating chunk
            except OSError:
                pass  # watcher already disconnected mid-stream


class _GoneError(Exception):
    pass
