"""Config CRD types — the dynamic-config singleton (reference
apis/config/v1alpha1/config_types.go:22-82).

spec.sync.syncOnly[]      -> which GVKs replicate into the engine inventory
spec.validation.traces[]  -> per-(user, GVK) decision tracing, optional Dump
spec.match[]              -> namespace exclusion per process (audit/sync/webhook/*)
spec.readiness.statsEnabled
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

GROUP = "config.gatekeeper.sh"
VERSION = "v1alpha1"
KIND = "Config"
GVK = (GROUP, VERSION, KIND)

# the singleton key (reference pkg/keys/config.go:25)
CONFIG_NAME = "config"


@dataclass
class SyncOnlyEntry:
    group: str = ""
    version: str = ""
    kind: str = ""

    def gvk(self) -> Tuple[str, str, str]:
        return (self.group, self.version, self.kind)


@dataclass
class Trace:
    user: str = ""
    kind: Tuple[str, str, str] = ("", "", "")
    dump: str = ""


@dataclass
class MatchEntry:
    excluded_namespaces: List[str] = field(default_factory=list)
    processes: List[str] = field(default_factory=list)


@dataclass
class ConfigSpec:
    sync_only: List[SyncOnlyEntry] = field(default_factory=list)
    traces: List[Trace] = field(default_factory=list)
    match: List[MatchEntry] = field(default_factory=list)
    readiness_stats_enabled: bool = False


def parse_config(obj: Optional[dict]) -> ConfigSpec:
    """Parse a Config CR dict into a ConfigSpec (tolerant of missing keys,
    as the reference's unstructured access is)."""
    spec = (obj or {}).get("spec") or {}
    sync = (spec.get("sync") or {}).get("syncOnly") or []
    sync_only = [
        SyncOnlyEntry(
            group=e.get("group", "") or "",
            version=e.get("version", "") or "",
            kind=e.get("kind", "") or "",
        )
        for e in sync
        if isinstance(e, dict)
    ]
    traces = []
    for t in (spec.get("validation") or {}).get("traces") or []:
        if not isinstance(t, dict):
            continue
        k = t.get("kind") or {}
        traces.append(
            Trace(
                user=t.get("user", "") or "",
                kind=(k.get("group", "") or "", k.get("version", "") or "", k.get("kind", "") or ""),
                dump=t.get("dump", "") or "",
            )
        )
    match = []
    for m in spec.get("match") or []:
        if not isinstance(m, dict):
            continue
        match.append(
            MatchEntry(
                excluded_namespaces=list(m.get("excludedNamespaces") or []),
                processes=list(m.get("processes") or []),
            )
        )
    readiness = bool((spec.get("readiness") or {}).get("statsEnabled"))
    return ConfigSpec(
        sync_only=sync_only,
        traces=traces,
        match=match,
        readiness_stats_enabled=readiness,
    )
