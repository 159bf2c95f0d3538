"""One trust model for on-disk derived state (AOT executables, snapshots).

Both persistence layers (ops/aotcache.py pickled executables,
snapshot/ packed-state directories) load bytes from disk that were
written by an earlier process and feed them to loaders that are NOT
safe against malicious input (pickle, np.load).  The shared seal here
closes the gap ADVICE flagged for the AOT cache: every artifact is
authenticated with an HMAC-SHA256 before it is parsed, so a writable
cache/snapshot directory alone is no longer enough to smuggle a
payload into the process — the attacker must also know the key.

Key derivation, in priority order:

1. ``GK_SEAL_KEY`` environment variable (operators: a per-deployment
   secret, e.g. projected from a Kubernetes Secret).  This is the
   production configuration; with it the seal is a real authentication
   boundary.
2. Fallback: a digest of this package's source fingerprint.  This is
   NOT secret (anyone holding the image can derive it) — it still
   rejects artifacts written by a different build and any accidental
   corruption/truncation, and keeps the artifact format identical so
   enabling a real key later is a pure config change.  The residual
   trust assumption (documented in docs/snapshots.md) is that the
   cache directory is only writable by the gatekeeper pod itself,
   which is why both layers also create their directories 0700.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
from typing import Optional

_code_fp: Optional[str] = None


def code_fingerprint() -> str:
    """Digest of every source file in this package: derived state written
    by a build whose code changed must never be reused (it would silently
    reproduce pre-fix semantics).  The kernels' CUDA sources (.cu, and
    the .cuh headers they include) count as sources: a snapshot's delta
    basis, the resident mask, is what the kernels computed."""
    global _code_fp
    if _code_fp is None:
        h = hashlib.sha256()
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for root, _dirs, files in sorted(os.walk(pkg)):
            for f in sorted(files):
                if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                    path = os.path.join(root, f)
                    h.update(f.encode())
                    try:
                        with open(path, "rb") as fh:
                            h.update(fh.read())
                    except OSError:
                        pass
        _code_fp = h.hexdigest()
    return _code_fp


def seal_key() -> bytes:
    """The HMAC key shared by every sealed-artifact layer."""
    k = os.environ.get("GK_SEAL_KEY", "")
    if k:
        return k.encode()
    return hashlib.sha256(
        b"gatekeeper-tpu-seal:" + code_fingerprint().encode()
    ).digest()


def seal(data: bytes) -> str:
    """Hex HMAC-SHA256 tag over `data` under the shared key."""
    return _hmac.new(seal_key(), data, hashlib.sha256).hexdigest()


def stable_seal_key() -> bytes:
    """Key for sealed artifacts that are SOURCE data meant to outlive
    builds (decision-log segments, obs/decisionlog.py): ``GK_SEAL_KEY``
    when set (the real authentication boundary, same variable as
    ``seal_key``), else a fixed package constant.  Unlike ``seal_key``'s
    code-fingerprint fallback — correct for DERIVED state, which must
    never cross a build — a decision archive's whole point is to be
    replayed against a LATER engine (tools/replay_decisions.py), so its
    fallback key must not change when the source does.  Without a real
    key either fallback is derivable from the image; the unkeyed seal
    detects corruption, reordering and truncation, not a deliberate
    re-signer (docs/decision-logs.md documents the posture)."""
    k = os.environ.get("GK_SEAL_KEY", "")
    if k:
        return k.encode()
    return hashlib.sha256(b"gatekeeper-tpu-seal:source-data:v1").digest()


def stable_seal(data: bytes) -> str:
    """Hex HMAC-SHA256 tag over `data` under the build-stable key."""
    return _hmac.new(stable_seal_key(), data, hashlib.sha256).hexdigest()


def verify(data: bytes, tag: str) -> bool:
    """Constant-time check of `tag` against `data`; False on any
    malformed tag rather than raising — callers treat a bad seal as a
    cache miss / cold-start fallback, never an error path."""
    try:
        return _hmac.compare_digest(seal(data), str(tag))
    except Exception:
        return False


def secure_makedirs(path: str) -> None:
    """mkdir -p with 0700 on every directory this process creates: the
    artifacts under it gate what the process will deserialize, so group/
    world write (or read — the HMAC fallback key is derivable) is never
    acceptable."""
    os.makedirs(path, mode=0o700, exist_ok=True)
    try:
        os.chmod(path, 0o700)  # pre-existing dir: tighten, don't trust
    except OSError:
        pass
