"""In-memory Kubernetes API: the control plane's API-server abstraction.

Plays the role envtest plays in the reference's test strategy (SURVEY.md
section 4 tier 2): a real store with list/get/create/update/delete/watch
semantics and resourceVersion bookkeeping, no kubelet.  The controllers,
webhook, audit manager and readiness tracker are written against this
interface; a real-cluster client can implement the same surface later.

Watches deliver ADDED/MODIFIED/DELETED events over per-watcher queues with
replay of existing objects on start (the reference's watch manager replays
cached objects to late joiners, pkg/watch/replay.go:35-120).
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

GVK = Tuple[str, str, str]  # (group, version, kind)


def gvk_of(obj: dict) -> GVK:
    api = obj.get("apiVersion", "")
    if "/" in api:
        g, v = api.split("/", 1)
    else:
        g, v = "", api
    return (g, v, obj.get("kind", ""))


def obj_key(obj: dict) -> Tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "", meta.get("name") or "")


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: dict


_STOP = object()  # sentinel enqueued by Watcher.stop()


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


class InMemoryKube:
    def __init__(self):
        self._store: Dict[GVK, Dict[Tuple[str, str], dict]] = {}
        self._watchers: Dict[GVK, List[queue.Queue]] = {}
        self._rv = itertools.count(1)
        self._last_rv = 0
        self._lock = threading.RLock()
        # global event hook: called as on_event(gvk, WatchEvent) under the
        # store lock for every ADDED/MODIFIED/DELETED.  The HTTP API-server
        # shim uses this to keep a complete, ordered event history so
        # watch?resourceVersion=N resume is gap-free (kube/apiserver.py).
        self.on_event: Optional[Callable[[GVK, "WatchEvent"], None]] = None

    def _next_rv(self) -> str:
        self._last_rv = next(self._rv)
        return str(self._last_rv)

    def current_rv(self) -> str:
        """Most recently issued resourceVersion (list-level RV, as the real
        API server stamps on ListMeta)."""
        with self._lock:
            return str(self._last_rv)

    # ---- CRUD -------------------------------------------------------------

    def create(self, obj: dict) -> dict:
        with self._lock:
            gvk = gvk_of(obj)
            key = obj_key(obj)
            bucket = self._store.setdefault(gvk, {})
            if key in bucket:
                raise Conflict(f"{gvk} {key} already exists")
            stored = copy.deepcopy(obj)
            meta = stored.setdefault("metadata", {})
            meta["resourceVersion"] = self._next_rv()
            meta.setdefault("uid", f"uid-{meta.get('name', '')}-{meta['resourceVersion']}")
            bucket[key] = stored
            self._notify(gvk, WatchEvent("ADDED", copy.deepcopy(stored)))
            return copy.deepcopy(stored)

    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        with self._lock:
            try:
                return copy.deepcopy(self._store[gvk][(namespace, name)])
            except KeyError:
                raise NotFound(f"{gvk} {namespace}/{name}")

    def update(self, obj: dict, check_version: bool = False,
               subresource: Optional[str] = None) -> dict:
        """Whole-object replace, or — with subresource='status' — a status
        write that leaves spec/metadata untouched (the real API server's
        PUT .../status; reference audit manager.go:604 and the status
        controllers write through Status().Update)."""
        with self._lock:
            gvk = gvk_of(obj)
            key = obj_key(obj)
            bucket = self._store.setdefault(gvk, {})
            if key not in bucket:
                raise NotFound(f"{gvk} {key}")
            if check_version:
                old_rv = bucket[key].get("metadata", {}).get("resourceVersion")
                new_rv = obj.get("metadata", {}).get("resourceVersion")
                if old_rv != new_rv:
                    raise Conflict(f"{gvk} {key}: resourceVersion mismatch")
            if subresource == "status":
                merged = copy.deepcopy(bucket[key])
                if "status" in obj:
                    merged["status"] = copy.deepcopy(obj["status"])
                else:
                    merged.pop("status", None)
                obj = merged
            elif subresource is not None:
                raise NotFound(f"{gvk} {key}: no subresource {subresource}")
            # no-op detection (as the real apiserver: an update that changes
            # nothing keeps the resourceVersion and emits no event) — this is
            # what lets write-back controller loops converge
            if self._semantically_equal(bucket[key], obj):
                return copy.deepcopy(bucket[key])
            stored = copy.deepcopy(obj)
            stored.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
            # preserve uid across updates
            stored["metadata"].setdefault(
                "uid", bucket[key].get("metadata", {}).get("uid")
            )
            bucket[key] = stored
            self._notify(gvk, WatchEvent("MODIFIED", copy.deepcopy(stored)))
            return copy.deepcopy(stored)

    @staticmethod
    def _semantically_equal(stored: dict, new: dict) -> bool:
        def strip(o):
            out = copy.deepcopy(o)
            meta = out.get("metadata")
            if isinstance(meta, dict):
                meta.pop("resourceVersion", None)
                meta.pop("uid", None)  # preserved from stored on update
            return out

        return strip(stored) == strip(new)

    def apply(self, obj: dict) -> dict:
        """create-or-update."""
        try:
            return self.create(obj)
        except Conflict:
            return self.update(obj)

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> bool:
        with self._lock:
            bucket = self._store.get(gvk, {})
            obj = bucket.pop((namespace, name), None)
            if obj is None:
                return False
            # stamp a fresh RV on the final state so the DELETED event is
            # ordered after every prior event in resourceVersion terms
            final = copy.deepcopy(obj)
            final.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
            self._notify(gvk, WatchEvent("DELETED", final))
            return True

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = []
            for (ns, _name), obj in sorted(self._store.get(gvk, {}).items()):
                if namespace is None or ns == namespace:
                    out.append(copy.deepcopy(obj))
            return out

    def list_pages(self, gvk: GVK, namespace: Optional[str] = None,
                   limit: int = 500):
        """Page-streamed list (API parity with HttpKube.list_pages): the
        in-memory store has no wire to chunk, but the audit's streaming
        consumer is written against this surface."""
        objs = self.list(gvk, namespace)
        if limit and limit > 0:
            for i in range(0, len(objs), limit):
                yield objs[i:i + limit]
        else:
            yield objs

    def list_rvs(self, gvk: GVK) -> Dict[Tuple[str, str], str]:
        """Metadata-only listing: {(namespace, name): resourceVersion}.
        The real-apiserver analogue is a PartialObjectMetadata list; the
        snapshot loader's delta resync uses this so RV-matched objects
        never pay a body copy."""
        with self._lock:
            return {
                key: str(
                    (obj.get("metadata") or {}).get("resourceVersion") or ""
                )
                for key, obj in self._store.get(gvk, {}).items()
            }

    def list_gvks(self) -> List[GVK]:
        """Discovery: every GVK with stored objects (the analogue of
        ServerPreferredResources in audit discovery mode)."""
        with self._lock:
            return sorted(self._store.keys())

    # ---- watch ------------------------------------------------------------

    def watch(self, gvk: GVK, replay: bool = True) -> "Watcher":
        # gklint: disable=unbounded-queue -- watch fan-out bounded by store
        # churn; events must not drop (consumers reconcile by replay, not RV gap)
        q: queue.Queue = queue.Queue()
        with self._lock:
            if replay:
                for obj in self.list(gvk):
                    q.put(WatchEvent("ADDED", obj))
            self._watchers.setdefault(gvk, []).append(q)
        return Watcher(self, gvk, q)

    def _unwatch(self, gvk: GVK, q: queue.Queue):
        with self._lock:
            try:
                self._watchers.get(gvk, []).remove(q)
            except ValueError:
                pass

    def _notify(self, gvk: GVK, event: WatchEvent):
        if self.on_event is not None:
            self.on_event(gvk, WatchEvent(event.type,
                                          copy.deepcopy(event.object)))
        # each watcher gets its own copy: consumers may mutate the object
        for q in self._watchers.get(gvk, []):
            q.put(WatchEvent(event.type, copy.deepcopy(event.object)))


class Watcher:
    def __init__(self, kube: InMemoryKube, gvk: GVK, q: queue.Queue):
        self.kube = kube
        self.gvk = gvk
        self.queue = q
        self._stopped = False

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        if self._stopped:
            return None
        try:
            ev = self.queue.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if ev is _STOP else ev

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self.kube._unwatch(self.gvk, self.queue)
            self.queue.put(_STOP)  # unblock a consumer parked in next()
