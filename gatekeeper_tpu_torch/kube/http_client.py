"""Real Kubernetes API client over HTTPS.

Implements the same kube surface as InMemoryKube (get / list / watch /
create / update / apply / delete / list_gvks) against a live API server,
so `App(kube=HttpKube(...))` runs the whole control plane — controllers,
webhook namespace fetches, audit status writes, readiness lists — on a
real cluster.  This is the role controller-runtime's client + dynamic
RESTMapper play in the reference (main.go:140-151, the discovery client in
pkg/audit/manager.go:245-331, Status().Update at manager.go:604).

Design notes, mapped to the reference behavior:

- **Auth**: in-cluster service-account (token file re-read on change, CA
  from the mounted secret — what rest.InClusterConfig does) or kubeconfig
  (current-context cluster/user: CA data or file, bearer token, client
  cert/key files).
- **Discovery / RESTMapper**: GVK -> (plural, namespaced) resolved from
  /api/v1 and /apis/<g>/<v>; cached; refreshed with a bounded retry loop
  on unknown kinds so a just-created CRD becomes usable once the server
  establishes it (the reference waits on CRD establishment the same way:
  constrainttemplate_controller.go:431-455 relies on the RESTMapper
  catching up).
- **list**: chunked with `limit` + `continue` tokens, mirroring the audit
  manager's --audit-chunk-size paging (manager.go:342-396).
- **watch**: list+watch with resourceVersion resume; reconnect from the
  last seen RV on drop; on HTTP 410 Gone relist and synthesize
  ADDED/MODIFIED/DELETED against the known key set — the informer
  Replace() semantics the dynamic cache fork provides
  (third_party/.../informers_map.go).
- **update**: PUT with the object's resourceVersion (409 -> Conflict);
  `check_version=False` strips the RV for a last-write-wins update.
  `subresource="status"` routes to PUT .../status, which is how every
  status write in the reference goes out (Status().Update).
- **apply**: create-or-update loop (the controllers' CreateOrUpdate).

Only the standard library is used (http.client + ssl + json); no
kubernetes-client dependency exists in the image.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import ssl
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import faults
from ..syncutil import Backoff
from .inmem import GVK, Conflict, NotFound, WatchEvent, gvk_of, obj_key

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeError(Exception):
    """Non-404/409 API error."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Gone(KubeError):
    """HTTP 410: watch window compacted away; caller must relist."""

    def __init__(self, message: str = "resource version too old"):
        super().__init__(410, message)


def _group_version(gvk: GVK) -> str:
    g, v, _ = gvk
    return f"{g}/{v}" if g else v


class HttpKube:
    """Kube surface over a real API server."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        ca_data: Optional[bytes] = None,
        client_cert_file: Optional[str] = None,
        client_key_file: Optional[str] = None,
        verify: bool = True,
        timeout: float = 30.0,
        discovery_retry_s: float = 5.0,
    ):
        self.base_url = base_url.rstrip("/")
        scheme, rest = self.base_url.split("://", 1)
        self._tls = scheme == "https"
        self._hostport = rest
        self._token = token
        self._token_file = token_file
        self._token_mtime = 0.0
        self.timeout = timeout
        self.discovery_retry_s = discovery_retry_s
        self._local = threading.local()
        if self._tls:
            if verify:
                ctx = ssl.create_default_context(cafile=ca_file)
                if ca_data:
                    ctx.load_verify_locations(
                        cadata=ca_data.decode()
                        if isinstance(ca_data, bytes) else ca_data)
            else:
                ctx = ssl._create_unverified_context()
            if client_cert_file:
                ctx.load_cert_chain(client_cert_file, client_key_file)
            self._ssl_ctx: Optional[ssl.SSLContext] = ctx
        else:
            self._ssl_ctx = None
        # RESTMapper cache: gvk -> (plural, namespaced)
        self._mapper: Dict[GVK, Tuple[str, bool]] = {}
        # negative cache: gvk -> monotonic expiry.  After a full failed
        # establishment wait, later lookups fail fast until the TTL lapses
        # so hot paths (per-request Config fetches) never stall on a kind
        # that simply doesn't exist.
        self._mapper_miss: Dict[GVK, float] = {}
        self._mapper_lock = threading.Lock()

    # ---- constructors ------------------------------------------------------

    @classmethod
    def in_cluster(cls) -> "HttpKube":
        """rest.InClusterConfig: env + mounted service-account secret."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("KUBERNETES_SERVICE_HOST not set; "
                               "not running in a cluster")
        return cls(
            f"https://{host}:{port}",
            token_file=os.path.join(SA_DIR, "token"),
            ca_file=os.path.join(SA_DIR, "ca.crt"),
        )

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "HttpKube":
        import yaml

        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context")
        ctx = next(c["context"] for c in cfg.get("contexts", [])
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg.get("clusters", [])
                       if c["name"] == ctx["cluster"])
        user = next((u["user"] for u in cfg.get("users", [])
                     if u["name"] == ctx.get("user")), {})
        ca_data = cluster.get("certificate-authority-data")
        return cls(
            cluster["server"],
            token=user.get("token"),
            ca_file=cluster.get("certificate-authority"),
            ca_data=base64.b64decode(ca_data) if ca_data else None,
            client_cert_file=user.get("client-certificate"),
            client_key_file=user.get("client-key"),
            verify=not cluster.get("insecure-skip-tls-verify", False),
        )

    # ---- transport ---------------------------------------------------------

    def _bearer(self) -> Optional[str]:
        if self._token_file:
            try:
                mtime = os.path.getmtime(self._token_file)
                if mtime != self._token_mtime:
                    with open(self._token_file) as f:
                        self._token = f.read().strip()
                    self._token_mtime = mtime
            except OSError:
                pass
        return self._token

    def _new_conn(self, timeout: Optional[float] = None):
        timeout = self.timeout if timeout is None else timeout
        if self._tls:
            return http.client.HTTPSConnection(
                self._hostport, timeout=timeout, context=self._ssl_ctx)
        return http.client.HTTPConnection(self._hostport, timeout=timeout)

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._new_conn()
            self._local.conn = conn
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass  # dropping a broken connection; close is best-effort
            self._local.conn = None

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Tuple[int, dict]:
        if faults.ENABLED:
            faults.fire(faults.KUBE_SEND, method=method, path=path)
        headers = {"Accept": "application/json"}
        tok = self._bearer()
        if tok:
            headers["Authorization"] = f"Bearer {tok}"
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        for attempt in (0, 1):
            conn = self._conn()
            sent = False
            try:
                conn.request(method, path, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_conn()
                # Retry only when safe: GETs are idempotent; for mutating
                # verbs retry only a send-phase failure (request never went
                # out).  A response-phase failure after a successful send
                # may have committed server-side — surface it and let the
                # caller's semantic retry (RetryKube / apply loop) decide.
                if attempt or (sent and method != "GET"):
                    raise
        if faults.ENABLED:
            faults.fire(faults.KUBE_RECV, method=method, path=path)
        try:
            doc = json.loads(data) if data else {}
        except ValueError:
            doc = {"message": data.decode(errors="replace")}
        return resp.status, doc

    def _check(self, status: int, doc: dict, what: str):
        if status < 300:
            return
        msg = doc.get("message", "") or doc.get("reason", "")
        if status == 404:
            raise NotFound(f"{what}: {msg}")
        if status == 409:
            raise Conflict(f"{what}: {msg}")
        if status == 410:
            raise Gone(msg)
        raise KubeError(status, f"{what}: {msg}")

    # ---- discovery / RESTMapper -------------------------------------------

    def _load_group_version(self, gv: str) -> None:
        path = f"/api/{gv}" if "/" not in gv else f"/apis/{gv}"
        status, doc = self._request("GET", path)
        if status != 200:
            return
        if "/" in gv:
            g, v = gv.split("/", 1)
        else:
            g, v = "", gv
        for r in doc.get("resources", []):
            if "/" in r.get("name", ""):
                continue  # subresource
            gvk = (g, v, r.get("kind", ""))
            with self._mapper_lock:
                self._mapper[gvk] = (r["name"], bool(r.get("namespaced")))

    def _refresh_discovery(self) -> None:
        self._load_group_version("v1")
        status, doc = self._request("GET", "/apis")
        if status != 200:
            return
        for grp in doc.get("groups", []):
            for ver in grp.get("versions", []):
                self._load_group_version(ver["groupVersion"])

    def _resolve(self, gvk: GVK) -> Tuple[str, bool]:
        with self._mapper_lock:
            hit = self._mapper.get(gvk)
            miss_until = self._mapper_miss.get(gvk, 0.0)
        if hit:
            return hit
        if time.monotonic() < miss_until:
            raise NotFound(f"no server resource for {gvk}")
        # unknown kind: refresh with a bounded wait — a CRD created moments
        # ago becomes discoverable once Established (the CRD establishment
        # wait the reference's RESTMapper performs implicitly)
        deadline = time.monotonic() + self.discovery_retry_s
        while True:
            self._load_group_version(_group_version(gvk))
            with self._mapper_lock:
                hit = self._mapper.get(gvk)
                if hit:
                    self._mapper_miss.pop(gvk, None)
                    return hit
            if time.monotonic() >= deadline:
                with self._mapper_lock:
                    self._mapper_miss[gvk] = time.monotonic() + 5.0
                raise NotFound(f"no server resource for {gvk}")
            time.sleep(0.1)

    def _path(self, gvk: GVK, namespace: str = "",
              name: str = "", subresource: str = "") -> str:
        g, v, _ = gvk
        plural, namespaced = self._resolve(gvk)
        root = f"/api/{v}" if not g else f"/apis/{g}/{v}"
        parts = [root]
        if namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    # ---- CRUD --------------------------------------------------------------

    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        path = self._path(gvk, namespace, name)
        status, doc = self._request("GET", path)
        self._check(status, doc, f"get {path}")
        return doc

    def create(self, obj: dict) -> dict:

        gvk = gvk_of(obj)
        ns, _ = obj_key(obj)
        path = self._path(gvk, ns)
        status, doc = self._request("POST", path, obj)
        self._check(status, doc, f"create {path}")
        return doc

    def update(self, obj: dict, check_version: bool = False,
               subresource: Optional[str] = None) -> dict:

        gvk = gvk_of(obj)
        ns, name = obj_key(obj)
        path = self._path(gvk, ns, name, subresource or "")
        if not check_version:
            obj = dict(obj)
            meta = dict(obj.get("metadata") or {})
            meta.pop("resourceVersion", None)
            obj["metadata"] = meta
        status, doc = self._request("PUT", path, obj)
        self._check(status, doc, f"update {path}")
        return doc

    def apply(self, obj: dict) -> dict:
        """create-or-update (controller-runtime's CreateOrUpdate loop)."""

        for _ in range(5):
            try:
                return self.create(obj)
            except Conflict:
                pass
            gvk = gvk_of(obj)
            ns, name = obj_key(obj)
            try:
                current = self.get(gvk, name, ns)
            except NotFound:
                continue  # deleted between create and get: recreate
            merged = dict(obj)
            meta = dict(merged.get("metadata") or {})
            meta["resourceVersion"] = (
                current.get("metadata", {}).get("resourceVersion"))
            merged["metadata"] = meta
            try:
                return self.update(merged, check_version=True)
            except (Conflict, NotFound):
                continue
        raise Conflict(f"apply {obj.get('kind')} "
                       f"{obj.get('metadata', {}).get('name')}: "
                       "retries exhausted")

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> bool:
        path = self._path(gvk, namespace, name)
        status, doc = self._request("DELETE", path)
        if status == 404:
            return False
        self._check(status, doc, f"delete {path}")
        return True

    def list(self, gvk: GVK, namespace: Optional[str] = None,
             limit: int = 500) -> List[dict]:
        items, _ = self._list_rv(gvk, namespace, limit)
        return items

    def list_pages(self, gvk: GVK, namespace: Optional[str] = None,
                   limit: int = 500):
        """Stream the list one API page (`limit` + `continue` token) at a
        time: host memory stays bounded by the page size regardless of
        cluster size.  The audit's chunked discovery sweep consumes this
        (reference manager.go:342-396)."""
        for page, _rv in self._pages_rv(gvk, namespace, limit):
            yield page

    def _pages_rv(self, gvk: GVK, namespace: Optional[str] = None,
                  limit: int = 500):
        path = self._path(gvk, namespace or "")
        cont = ""
        rv = "0"
        api_version = _group_version(gvk)
        while True:
            q = f"?limit={limit}"
            if cont:
                q += f"&continue={cont}"
            status, doc = self._request("GET", path + q)
            self._check(status, doc, f"list {path}")
            page = doc.get("items", [])
            for it in page:
                # list items omit apiVersion/kind; restore them
                it.setdefault("apiVersion", api_version)
                it.setdefault("kind", gvk[2])
            rv = doc.get("metadata", {}).get("resourceVersion", rv)
            cont = doc.get("metadata", {}).get("continue", "")
            yield page, rv
            if not cont:
                return

    def _list_rv(self, gvk: GVK, namespace: Optional[str] = None,
                 limit: int = 500) -> Tuple[List[dict], str]:
        items: List[dict] = []
        rv = "0"
        for page, rv in self._pages_rv(gvk, namespace, limit):
            items.extend(page)
        return items, rv

    def list_gvks(self) -> List[GVK]:
        """Discovery-mode enumeration (ServerPreferredResources,
        audit manager.go:245-331): every listable GVK the server knows."""
        self._refresh_discovery()
        with self._mapper_lock:
            return sorted(self._mapper.keys())

    # ---- watch -------------------------------------------------------------

    def watch(self, gvk: GVK, replay: bool = True) -> "HttpWatcher":
        return HttpWatcher(self, gvk, replay)


class HttpWatcher:
    """list+watch with resourceVersion resume over a streaming GET.

    Matches the Watcher interface watch/manager.py's pump consumes:
    next(timeout) -> WatchEvent | None, stop(), and a _stopped attribute.
    """

    def __init__(self, kube: HttpKube, gvk: GVK, replay: bool):
        self.kube = kube
        self.gvk = gvk
        # gklint: disable=unbounded-queue -- watch stream events are bounded
        # by cluster churn and must not be dropped (a gap forces a full relist)
        self.queue: "queue.Queue" = queue.Queue()
        self._stopped = False
        self._conn = None
        self._sock = None
        self._known: Dict[Tuple[str, str], str] = {}  # key -> rv
        items, rv = kube._list_rv(gvk)

        for it in items:
            self._known[obj_key(it)] = (
                it.get("metadata", {}).get("resourceVersion", "0"))
            if replay:
                self.queue.put(WatchEvent("ADDED", it))
        self._rv = rv
        self._thread = threading.Thread(
            target=self._pump, name=f"http-watch-{gvk}", daemon=True)
        self._thread.start()

    # -- consumer side --

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        if self._stopped:
            return None
        try:
            ev = self.queue.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if ev is None else ev

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        # Shut the raw socket down rather than conn.close(): close() takes
        # the buffered reader's lock, which the pump thread holds while
        # parked in readline(), so close() would block until the next
        # bookmark.  shutdown() unblocks the reader immediately.
        sock = self._sock
        if sock is not None:
            import socket as _socket

            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by the peer; shutdown is the nudge
        self.queue.put(None)

    # -- producer side --

    # Reconnect schedule: exponential from RECONNECT_BASE_S hard-capped at
    # RECONNECT_CAP_S, with downward jitter so a fleet of watchers whose
    # streams all died together (apiserver restart, network partition)
    # desynchronizes instead of relisting in lockstep.
    RECONNECT_BASE_S = 0.05
    RECONNECT_CAP_S = 2.0
    RECONNECT_JITTER = 0.5

    def _pump(self):

        backoff = Backoff(
            base=self.RECONNECT_BASE_S, cap=self.RECONNECT_CAP_S,
            jitter=self.RECONNECT_JITTER,
        )
        while not self._stopped:
            try:
                self._stream_once()
                backoff.reset()
            except Gone:
                try:
                    self._relist()
                    backoff.reset()
                except Exception:
                    # relist failed too (server down / auth expired):
                    # back off so the pump doesn't spin on 410s
                    if self._stopped:
                        return
                    time.sleep(backoff.next())
            except Exception:
                if self._stopped:
                    return
                time.sleep(backoff.next())

    def _stream_once(self):
        """One watch connection: stream events until the server ends it."""
        if faults.ENABLED:
            faults.fire(faults.KUBE_SEND, method="WATCH", path=str(self.gvk))
        k = self.kube
        path = k._path(self.gvk) + (
            f"?watch=1&resourceVersion={self._rv}&allowWatchBookmarks=true")
        headers = {"Accept": "application/json"}
        tok = k._bearer()
        if tok:
            headers["Authorization"] = f"Bearer {tok}"
        conn = k._new_conn(timeout=330.0)
        self._conn = conn
        try:
            conn.request("GET", path, headers=headers)
            self._sock = conn.sock
            resp = conn.getresponse()
            if resp.status == 410:
                resp.read()
                raise Gone()
            if resp.status != 200:
                body = resp.read().decode(errors="replace")
                raise KubeError(resp.status, f"watch {path}: {body}")
            while not self._stopped:
                line = resp.readline()
                if not line:
                    return  # server closed; reconnect from last rv
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                self._handle(ev)
        finally:
            self._conn = None
            self._sock = None
            try:
                conn.sock and conn.sock.close()
            except OSError:
                pass  # stream teardown of an already-dead socket

    def _handle(self, ev: dict):

        etype = ev.get("type", "")
        obj = ev.get("object", {}) or {}
        rv = obj.get("metadata", {}).get("resourceVersion")
        if etype == "BOOKMARK":
            if rv:
                self._rv = rv
            return
        if etype == "ERROR":
            # apiserver streams a Status with code 410 when the RV expires
            if obj.get("code") == 410:
                raise Gone()
            return
        if rv:
            self._rv = rv
        key = obj_key(obj)
        if etype == "DELETED":
            self._known.pop(key, None)
        elif etype in ("ADDED", "MODIFIED"):
            self._known[key] = rv or "0"
        if not self._stopped:
            self.queue.put(WatchEvent(etype, obj))

    def _relist(self):
        """410 Gone: relist and synthesize the diff against known keys —
        informer Replace() semantics."""

        items, rv = self.kube._list_rv(self.gvk)
        fresh = {obj_key(it): it for it in items}
        for key, it in fresh.items():
            new_rv = it.get("metadata", {}).get("resourceVersion", "0")
            old_rv = self._known.get(key)
            if old_rv is None:
                self.queue.put(WatchEvent("ADDED", it))
            elif old_rv != new_rv:
                self.queue.put(WatchEvent("MODIFIED", it))
        for key in list(self._known):
            if key not in fresh:
                tomb = {
                    "apiVersion": _group_version(self.gvk),
                    "kind": self.gvk[2],
                    "metadata": {"namespace": key[0] or None,
                                 "name": key[1]},
                }
                self.queue.put(WatchEvent("DELETED", tomb))
        self._known = {
            k: it.get("metadata", {}).get("resourceVersion", "0")
            for k, it in fresh.items()
        }
        self._rv = rv
