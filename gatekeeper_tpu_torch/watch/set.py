"""Thread-safe GVK set with union/difference (reference pkg/watch/set.go)."""

from __future__ import annotations

import threading
from typing import Iterable, List, Set, Tuple

GVK = Tuple[str, str, str]


class GVKSet:
    def __init__(self, items: Iterable[GVK] = ()):
        self._lock = threading.RLock()
        self._items: Set[GVK] = set(items)

    def add(self, *gvks: GVK):
        with self._lock:
            self._items.update(gvks)

    def remove(self, *gvks: GVK):
        with self._lock:
            self._items.difference_update(gvks)

    def contains(self, gvk: GVK) -> bool:
        with self._lock:
            return gvk in self._items

    def items(self) -> List[GVK]:
        with self._lock:
            return sorted(self._items)

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def union(self, other: "GVKSet") -> "GVKSet":
        with self._lock, other._lock:
            return GVKSet(self._items | other._items)

    def difference(self, other: "GVKSet") -> "GVKSet":
        with self._lock, other._lock:
            return GVKSet(self._items - other._items)

    def intersection(self, other: "GVKSet") -> "GVKSet":
        with self._lock, other._lock:
            return GVKSet(self._items & other._items)

    def equals(self, other: "GVKSet") -> bool:
        with self._lock, other._lock:
            return self._items == other._items

    def copy(self) -> "GVKSet":
        with self._lock:
            return GVKSet(self._items)
