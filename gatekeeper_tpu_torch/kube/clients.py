"""API-client wrappers (reference test/clients/retry_client.go,
noop_client.go).

RetryKube wraps a kube with retry-on-conflict for every write — the shape
controllers use against a contended API server.  NoopKube is the benchmark
stub: accepts everything, returns nothing.
"""

from __future__ import annotations

import time
from typing import List, Optional

from .inmem import GVK, Conflict, InMemoryKube, NotFound


class RetryKube:
    """Write-retrying facade over a kube (RetryClient)."""

    def __init__(self, inner: InMemoryKube, attempts: int = 5,
                 backoff_s: float = 0.01):
        self.inner = inner
        self.attempts = attempts
        self.backoff_s = backoff_s

    def _retry(self, fn, *args, **kwargs):
        delay = self.backoff_s
        for attempt in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except Conflict:
                if attempt == self.attempts - 1:
                    raise
                time.sleep(delay)
                delay *= 2

    # reads pass through
    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        return self.inner.get(gvk, name, namespace)

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> List[dict]:
        return self.inner.list(gvk, namespace)

    def list_gvks(self) -> List[GVK]:
        return self.inner.list_gvks()

    def watch(self, gvk: GVK, replay: bool = True):
        return self.inner.watch(gvk, replay=replay)

    # writes retry on conflict
    def create(self, obj: dict) -> dict:
        return self._retry(self.inner.create, obj)

    def update(self, obj: dict, check_version: bool = False,
               subresource: Optional[str] = None) -> dict:
        if not check_version:
            return self.inner.update(obj, subresource=subresource)

        def attempt():
            # refetch-and-reapply on conflict, as RetryClient callers do
            return self.inner.update(obj, check_version=True,
                                     subresource=subresource)

        return self._retry(attempt)

    def apply(self, obj: dict) -> dict:
        return self._retry(self.inner.apply, obj)

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> bool:
        return self.inner.delete(gvk, name, namespace)


class NoopKube:
    """Benchmark stub (NoopClient): absorbs writes, serves empty reads."""

    def get(self, gvk: GVK, name: str, namespace: str = "") -> dict:
        raise NotFound(f"{gvk} {namespace}/{name}")

    def list(self, gvk: GVK, namespace: Optional[str] = None) -> List[dict]:
        return []

    def list_gvks(self) -> List[GVK]:
        return []

    def create(self, obj: dict) -> dict:
        return obj

    def update(self, obj: dict, check_version: bool = False,
               subresource: Optional[str] = None) -> dict:
        return obj

    def apply(self, obj: dict) -> dict:
        return obj

    def delete(self, gvk: GVK, name: str, namespace: str = "") -> bool:
        return False
