"""On-disk snapshot format: layout, manifest, sealing, key codecs.

A snapshot is one directory (written temp-then-rename, so readers only
ever see complete snapshots):

    snap-<millis>-<pid>/
      MANIFEST.json     schema version, code fingerprint, per-file
                        sha256 checksums, HMAC seal (util/seal.py)
      interner.json     the global string vocabulary, id order preserved
      registry.json     raw ConstraintTemplate + constraint objects
      pack.json         audit-pack row metadata: column keys, row paths,
                        namespaces, free list, per-row resourceVersions
      arrays.npz        the packed review-side + column arrays

Trust model (shared with ops/aotcache.py; docs/snapshots.md): the
manifest is HMAC-sealed and every file is checksummed in it, so nothing
is parsed — not even json — before its bytes authenticate.  Validation
failures are NEVER errors to the caller's caller: the loader reports
them and the process falls back to the cold start path.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..util import seal as sealmod

SCHEMA_VERSION = 1
MANIFEST = "MANIFEST.json"
INTERNER = "interner.json"
REGISTRY = "registry.json"
PACK = "pack.json"
ARRAYS = "arrays.npz"
# the frozen inventory tree + per-row reviews, pickled: restoring them
# wholesale is what turns the resync into a metadata-only pass — the
# cold path's per-object freeze of the whole cluster (seconds at 100k
# objects) disappears.  Pickle is only parsed AFTER the manifest HMAC
# and this file's checksum verify (the aotcache trust model).
INVENTORY = "inventory.pkl"

PAYLOAD_FILES = (INTERNER, REGISTRY, PACK, ARRAYS, INVENTORY)

SNAP_PREFIX = "snap-"
TMP_PREFIX = ".tmp-"
# snapshots that failed validation are renamed under here (dot-prefixed:
# excluded from list_snapshots and the writer's prune) instead of being
# re-validated — and re-failed — on every subsequent restart
QUARANTINE_DIR = ".quarantine"


class SnapshotError(Exception):
    """Any reason a snapshot cannot be written or restored; carries a
    short machine-greppable reason as its message."""


# ---- column-key / path codecs ----------------------------------------------
# AuditPackCache keys columns by nested tuples of strings
# ((kind, iter_paths, rel_path, exclude)); JSON has no tuples, so the
# codec is a structure-preserving tuple<->list swap.


def encode_key(key) -> Any:
    if isinstance(key, tuple):
        return [encode_key(k) for k in key]
    return key


def decode_key(key) -> Any:
    if isinstance(key, list):
        return tuple(decode_key(k) for k in key)
    return key


# ---- manifest ---------------------------------------------------------------


def _canonical(manifest: Dict[str, Any]) -> bytes:
    body = {k: v for k, v in manifest.items() if k != "hmac"}
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(snap_dir: str) -> None:
    files = {}
    for name in PAYLOAD_FILES:
        files[name] = file_sha256(os.path.join(snap_dir, name))
    manifest: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "fingerprint": sealmod.code_fingerprint(),
        "files": files,
    }
    manifest["hmac"] = sealmod.seal(_canonical(manifest))
    with open(os.path.join(snap_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def read_manifest(snap_dir: str) -> Dict[str, Any]:
    """Parse + authenticate the manifest and verify every payload file's
    checksum.  Raises SnapshotError with a short reason on any failure —
    nothing beyond the manifest json itself is parsed before the HMAC
    verifies, and no payload is parsed before its checksum does."""
    path = os.path.join(snap_dir, MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotError(f"manifest unreadable: {e}")
    if not isinstance(manifest, dict):
        raise SnapshotError("manifest not an object")
    if not sealmod.verify(_canonical(manifest), manifest.get("hmac", "")):
        raise SnapshotError("manifest hmac verification failed")
    if manifest.get("schema") != SCHEMA_VERSION:
        raise SnapshotError(
            f"schema {manifest.get('schema')!r} != {SCHEMA_VERSION}"
        )
    if manifest.get("fingerprint") != sealmod.code_fingerprint():
        raise SnapshotError("code fingerprint mismatch (different build)")
    files = manifest.get("files")
    if not isinstance(files, dict) or set(files) != set(PAYLOAD_FILES):
        raise SnapshotError("manifest file list mismatch")
    for name, want in files.items():
        fpath = os.path.join(snap_dir, name)
        try:
            got = file_sha256(fpath)
        except OSError as e:
            raise SnapshotError(f"{name} unreadable: {e}")
        if got != want:
            raise SnapshotError(f"{name} checksum mismatch")
    return manifest


# ---- directory management ---------------------------------------------------


def list_snapshots(root: str) -> List[str]:
    """Completed snapshot dir names, newest first (names embed the write
    time, so the lexicographic order is the age order)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(
        (n for n in names if n.startswith(SNAP_PREFIX)), reverse=True
    )


def dir_bytes(snap_dir: str) -> int:
    total = 0
    try:
        for name in os.listdir(snap_dir):
            try:
                total += os.path.getsize(os.path.join(snap_dir, name))
            except OSError:
                pass
    except OSError:
        pass
    return total


def path_rv(frozen_obj: Any) -> str:
    """metadata.resourceVersion of a (frozen) stored object, or ''."""
    try:
        meta = frozen_obj.get("metadata")
        rv = meta.get("resourceVersion") if meta is not None else None
        return str(rv) if rv else ""
    except Exception:
        return ""


def gvk_api_version(gvk: Tuple[str, str, str]) -> str:
    group, version, _kind = gvk
    return f"{group}/{version}" if group else version


def path_identity(seg: Tuple[str, ...]) -> Optional[Tuple[str, str, str, str]]:
    """(api_version, kind, name, namespace) of an object-depth store path
    (the same shape ops/auditpack.py uses), else None."""
    if seg and seg[0] == "cluster" and len(seg) == 4:
        return seg[1], seg[2], seg[3], ""
    if seg and seg[0] == "namespace" and len(seg) == 5:
        return seg[2], seg[3], seg[4], seg[1]
    return None
