"""SnapshotWriter + the background Snapshotter thread.

The writer captures, under the driver lock, exactly the state whose
rebuild dominates a cold start:

  - the interner vocabulary (ids are baked into every packed array)
  - the resident audit pack (review-side arrays + column store + row
    metadata), as synced to the inventory store
  - per-row resourceVersions, so the loader can delta-resync against
    the live API instead of re-packing the world
  - the raw template/constraint registry

Capture is a few array copies (~ms per 100MB) so admission traffic
stalls briefly at worst; serialization and the atomic rename happen
outside the lock.  A snapshot is only taken when the pack is exactly
synced to the store (the state right after an audit sweep) — per-row
resourceVersions must describe the packed content, not newer writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import faults
from .. import logging as gklog
from ..metrics.catalog import record_snapshot_write
from ..obs import trace as obstrace
from ..util import seal as sealmod
from . import format as fmt
from .format import SnapshotError
from ..util import join_thread

log = gklog.get("snapshot")

DEFAULT_RETAIN = 3

# advisory cross-process writer lock (fleet shared snapshot dirs,
# docs/fleet.md): two audit-role processes pointed at one directory must
# not interleave prunes with each other's renames.  POSIX-only; where
# fcntl is unavailable the writer degrades to the single-process
# behavior it always had.
try:
    import fcntl as _fcntl
except ImportError:  # pragma: no cover - non-POSIX
    _fcntl = None
WRITE_LOCK = ".write.lock"


class _WriterLock:
    """Non-blocking exclusive flock on <root>/.write.lock; raises
    SnapshotError when another process holds it (the Snapshotter treats
    that as an ordinary skip and retries next cycle).  Readers never
    take it — the atomic tmp-dir rename is what makes concurrent
    restores safe."""

    def __init__(self, root: str):
        self._path = os.path.join(root, WRITE_LOCK)
        self._fh = None

    def __enter__(self):
        if _fcntl is None:
            return self
        self._fh = open(self._path, "a+")
        try:
            _fcntl.flock(self._fh, _fcntl.LOCK_EX | _fcntl.LOCK_NB)
        except OSError:
            self._fh.close()
            self._fh = None
            raise SnapshotError(
                "another process is writing to this snapshot dir"
            )
        return self

    def __exit__(self, *exc):
        if self._fh is not None:
            try:
                _fcntl.flock(self._fh, _fcntl.LOCK_UN)
            finally:
                self._fh.close()
                self._fh = None
        return False


class SnapshotWriter:
    def __init__(self, root: str, retain: int = DEFAULT_RETAIN,
                 capture_delta: bool = True):
        self.root = root
        self.retain = max(1, retain)
        # capture_delta=False skips the incremental-sweep basis (and the
        # base-mask resolution wait it may imply); restores then pay one
        # full device sweep — tests of the validation/fallback surface
        # use this to stay fast
        self.capture_delta = capture_delta
        sealmod.secure_makedirs(root)

    # ---- capture ----------------------------------------------------------

    @staticmethod
    def _capture_delta(driver, ap) -> Optional[Dict[str, Any]]:
        """The incremental-sweep basis (ops/deltasweep.py DeltaState), when
        it is current: counts, candidate lists, the rendered-result cache,
        and a REFERENCE to the base-mask source.  The mask itself resolves
        in _resolve_mask OUTSIDE the driver lock — its dispatch runs for
        seconds at 100k rows and must never stall admission reviews
        queueing on the lock.  With the basis, a restart's first capped
        sweep runs the O(churn) delta path instead of a full [C, R]
        dispatch.  None when unavailable — the snapshot is still valid,
        the restart just pays one full device sweep."""
        st = getattr(driver, "_delta_state", None)
        if st is None:
            return None
        if (
            st.cs_epoch != driver._cs_epoch
            or st.layout_gen != ap.layout_gen
            or st.store_epoch != driver.store.epoch
        ):
            return None
        ordered_keys = [
            (k, n) for k, n, _c in driver._ordered_constraints()
        ]
        # referential policies: the delta path needs the host join-group
        # index (ops/joinkernel.py) — a basis restored without it could
        # not maintain the aggregates incrementally, so when plans are
        # active and the index is stale the basis is withheld entirely
        # (the restart's first sweep rebases via one full dispatch)
        join_index = None
        plans = ()
        if hasattr(driver, "_active_join_plans"):
            plans = driver._active_join_plans()
        if plans:
            js = getattr(driver, "_join_state", None)
            if (
                js is None or not js.built
                or js.rebuild_gen != ap.rebuild_gen
                or js.sig != tuple(p.sig for p in plans)
            ):
                return None
            join_index = js.persist()
        # compiled message-plan tiers per constraint: the loader re-binds
        # plans after template replay and validates the classification
        # against this map — a drift (e.g. a plan-compiler change between
        # writer and reader versions) drops the persisted render cache
        # instead of silently reusing results a different tier produced
        return {
            "render_plans": driver._render_plan_tiers(),
            # sweep sharding layout the basis was produced under (mesh
            # device count, 1 = single-device) — the basis's OWN stamp,
            # not the live driver layout: a topology poke between the
            # basis's full sweep and the snapshot tick must not mis-label
            # a mask whose row padding belongs to the old geometry.  The
            # loader refuses the basis when the restoring process's
            # layout differs and rebases via one full sweep rather than
            # serve candidates off a mask whose padded tail no longer
            # matches the live slab geometry.
            "mesh_width": int(st.mesh_width),
            "counts": st.counts.copy(),
            "cand": [list(c) for c in st.cand],
            "horizon": list(st.horizon),
            "crow": np.asarray(st.crow, np.int64).copy(),
            "K": st.K,
            "row_cols": {
                int(r): np.array(c) for r, c in st.row_cols.items()
            },
            "render_cache": dict(st.render_cache),
            "ordered_keys": ordered_keys,
            # the join-group index (None for row-local corpora): restores
            # keep the O(churn) delta path for referential policies; the
            # loader drops the whole basis on plan drift
            "join_index": join_index,
            # resolved post-lock; a MaskSource is internally locked and
            # its value is pinned to this basis's full sweep
            "mask_src": st.mask_src,
        }

    @staticmethod
    def _resolve_mask(mask_src) -> Optional[np.ndarray]:
        """The [C_total, R] base mask as a host bool array, waiting out
        (bounded) an in-flight background prefetch; None when it cannot
        be had.  Runs WITHOUT the driver lock.

        The resolved mask is a bool tensor on the driver's device, or a
        mesh sweep's ShardedMask (one [C_total, slab] tensor a shard, on
        the shard's device).  np.asarray would raise on a CUDA tensor and
        make an object array of a ShardedMask, so the mask comes to the
        host as the driver's _host_rows brings it: .cpu(), the slabs
        joined in row order and cut to the pack's capacity
        (ShardedMask.rows), the width the loader checks; the padding past
        it is always False and the loader pads it back."""
        from ..ops.deltasweep import MaskSource
        from ..parallel.mesh import ShardedMask

        mask = mask_src.peek(wait_s=300.0)
        if mask is None:
            try:
                mask = mask_src.get()
            except Exception:
                return None
        if mask is None or mask is MaskSource.BUSY:
            return None
        if isinstance(mask, ShardedMask):
            return mask.host()
        return mask.cpu().numpy().astype(bool)

    def _capture(self, client) -> Dict[str, Any]:
        """Consistent copy of the serving state (driver lock held)."""
        driver = client.driver
        ap = getattr(driver, "_audit_pack", None)
        interner = getattr(driver, "interner", None)
        if ap is None or interner is None:
            raise SnapshotError("driver exposes no packed audit state")
        with driver._lock:
            if ap.rp is None or ap.col_keys is None:
                raise SnapshotError("no packed audit state yet (no sweep)")
            if ap.synced_epoch != driver.store.epoch:
                # per-row RVs must describe the packed rows; a store that
                # moved past the pack gets snapshotted after its next sweep
                raise SnapshotError("store ahead of pack; retry after sweep")
            rp = {k: np.array(v) for k, v in ap.rp.items()}
            cols_order = sorted(ap.cols.keys())
            cols = {
                ck: {leaf: np.array(a) for leaf, a in ap.cols[ck].items()}
                for ck in cols_order
            }
            rvs: List[str] = []
            for seg in ap.row_path:
                rvs.append(
                    fmt.path_rv(driver.store.get(seg)) if seg else ""
                )
            templates = []
            for kind in client.templates():
                tmpl = client._templates.get(kind)
                if tmpl is None or not tmpl.raw:
                    raise SnapshotError(f"template {kind} has no raw form")
                templates.append(tmpl.raw)
            constraints = [
                c
                for kind in sorted(driver.constraints)
                for _name, c in sorted(driver.constraints[kind].items())
            ]
            # the loader rebuilds the frozen store tree from the reviews'
            # objects, so every stored object must BE a pack row — exotic
            # store paths (deep put_data) would silently drop on restore
            n_objects = sum(1 for _ in driver.store.iter_objects())
            n_live = sum(1 for p in ap.row_path if p is not None)
            if n_objects != n_live:
                raise SnapshotError(
                    f"store holds {n_objects} objects but the pack has "
                    f"{n_live} live rows; snapshot skipped"
                )
            return {
                "interner": list(interner._strings),
                "templates": templates,
                "constraints": constraints,
                "rp": rp,
                "cols_order": cols_order,
                "cols": cols,
                "col_keys": ap.col_keys,
                "row_path": [
                    list(p) if p is not None else None for p in ap.row_path
                ],
                "row_ns": list(ap.row_ns),
                "free": list(ap.free),
                "n_rows": ap.n_rows,
                "rv": rvs,
                # the pickle payload: reviews (plain dicts — they pickle
                # and unpickle at C speed, unlike a FrozenDict graph; the
                # loader re-freezes their objects natively to rebuild the
                # store tree) + render-cache-keying generations + the
                # delta basis
                "reviews": list(ap.reviews),
                "row_gen": list(ap.row_gen),
                "delta": (
                    self._capture_delta(driver, ap)
                    if self.capture_delta else None
                ),
            }

    # ---- serialize --------------------------------------------------------

    def write(self, client) -> str:
        """Capture + persist one snapshot; returns its directory path.
        Raises SnapshotError when the state is not snapshotable and lets
        unexpected errors propagate (the Snapshotter guards)."""
        t0 = time.perf_counter()
        state = self._capture(client)
        delta = state["delta"]
        if delta is not None:
            # outside the driver lock: the mask dispatch may take seconds
            mask = self._resolve_mask(delta.pop("mask_src"))
            if mask is None:
                state["delta"] = None
            else:
                delta["mask_packed"] = np.packbits(mask, axis=1)
                delta["mask_shape"] = list(mask.shape)
        if faults.ENABLED:
            faults.fire(faults.SNAPSHOT_WRITE)
        name = f"{fmt.SNAP_PREFIX}{int(time.time() * 1000):013d}-{os.getpid()}"  # wall-clock: ok (dir name)
        tmp = os.path.join(self.root, f"{fmt.TMP_PREFIX}{name}")
        final = os.path.join(self.root, name)
        # the on-disk phase is serialized ACROSS processes: a concurrent
        # writer's prune must never sweep this writer's tmp dir or race
        # its retention scan (readers stay lock-free — they only ever see
        # complete, atomically-renamed snapshot dirs)
        lock = _WriterLock(self.root)
        lock.__enter__()
        try:
            os.makedirs(tmp, mode=0o700)
            with open(os.path.join(tmp, fmt.INTERNER), "w") as f:
                json.dump(state["interner"], f)
            with open(os.path.join(tmp, fmt.REGISTRY), "w") as f:
                json.dump(
                    {
                        "templates": state["templates"],
                        "constraints": state["constraints"],
                    },
                    f,
                )
            with open(os.path.join(tmp, fmt.PACK), "w") as f:
                json.dump(
                    {
                        "col_keys": fmt.encode_key(list(state["col_keys"])),
                        "col_index": [
                            fmt.encode_key(k) for k in state["cols_order"]
                        ],
                        "row_path": state["row_path"],
                        "row_ns": state["row_ns"],
                        "free": state["free"],
                        "n_rows": state["n_rows"],
                        "rv": state["rv"],
                    },
                    f,
                )
            arrays: Dict[str, np.ndarray] = {}
            for k, v in state["rp"].items():
                arrays[f"rp:{k}"] = v
            for i, ck in enumerate(state["cols_order"]):
                for leaf, a in state["cols"][ck].items():
                    arrays[f"col:{i}:{leaf}"] = a
            with open(os.path.join(tmp, fmt.ARRAYS), "wb") as f:
                np.savez(f, **arrays)
            # the inventory pickle: one dump shares object identity, so a
            # render-cache Result and ap.reviews[row] restore as the SAME
            # dict (the render reuse path depends on nothing more than
            # value equality, but sharing keeps memory flat).  Parsed on
            # restore only after the manifest HMAC + checksum verify.
            import pickle

            with open(os.path.join(tmp, fmt.INVENTORY), "wb") as f:
                pickle.dump(
                    {
                        "reviews": state["reviews"],
                        "row_gen": state["row_gen"],
                        "delta": state["delta"],
                    },
                    f, protocol=pickle.HIGHEST_PROTOCOL,
                )
            fmt.write_manifest(tmp)
            os.rename(tmp, final)
            self._prune()
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            lock.__exit__()
        dur = time.perf_counter() - t0
        nbytes = fmt.dir_bytes(final)
        record_snapshot_write(dur, nbytes)
        gklog.log_event(
            log, "snapshot written",
            **{gklog.EVENT_TYPE: "snapshot_written",
               "snapshot_dir": final, "snapshot_bytes": nbytes,
               "rows": state["n_rows"],
               "duration_ms": round(dur * 1e3, 1)},
        )
        return final

    # tmp dirs older than this are orphans of a killed writer (a live
    # write finishes in seconds); swept on every prune so crash-loops
    # cannot fill the volume with near-full-size partial snapshots
    TMP_ORPHAN_S = 3600.0

    def _prune(self):
        for name in fmt.list_snapshots(self.root)[self.retain:]:
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        now = time.time()  # wall-clock: ok (mtime comparison)
        for name in names:
            if not name.startswith(fmt.TMP_PREFIX):
                continue
            path = os.path.join(self.root, name)
            try:
                if now - os.path.getmtime(path) > self.TMP_ORPHAN_S:
                    shutil.rmtree(path, ignore_errors=True)
            except OSError:
                pass


class Snapshotter:
    """Background snapshot cadence: one snapshot after the first audit
    sweep, then at most one per `interval_s`, re-armed by each completed
    sweep (AuditManager.notify hook) and by a timer so idle clusters
    still refresh their RV horizon.  Write failures are logged and
    retried next cycle — persistence must never affect serving."""

    def __init__(self, client, root: str, interval_s: float = 300.0,
                 retain: int = DEFAULT_RETAIN, capture_delta: bool = True):
        self.client = client
        self.writer = SnapshotWriter(
            root, retain=retain, capture_delta=capture_delta
        )
        self.interval_s = max(1.0, interval_s)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_write = 0.0  # perf_counter timeline
        self.last_path: Optional[str] = None
        self.last_error: Optional[str] = None

    def start(self):
        # idempotent: a second start() (warm-restore paths call it after
        # App wiring) must not spawn a second writer loop — two loops
        # would double the write cadence and race the retention prune
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="snapshotter", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            join_thread(self._thread, 5.0, "snapshotter loop")
            self._thread = None

    def notify_sweep(self):
        """Called by the audit manager after each successful sweep: the
        pack is freshly synced, the ideal capture point."""
        self._wake.set()

    def _due(self) -> bool:
        return (
            self._last_write == 0.0
            or time.perf_counter() - self._last_write >= self.interval_s
        )

    def _loop(self):
        from ..obs import brownout as _brownout

        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            if _brownout.defer_background():
                # brownout ladder level >= 1: a snapshot capture takes
                # the driver lock and serializes the pack — deferred
                # while admissions are saturated.  The wake flag is
                # already cleared; the next sweep (or the interval
                # timer) re-arms once pressure clears
                log.info("snapshot arming deferred by brownout ladder")
                continue
            if not self._due():
                continue
            self.write_once()

    def write_once(self) -> Optional[str]:
        """One guarded write attempt (also the direct call for tests and
        the bench)."""
        with obstrace.root_span("snapshot.write"):
            try:
                path = self.writer.write(self.client)
            except SnapshotError as e:
                # expected skips (no sweep yet, store mid-churn): debug only
                log.debug("snapshot skipped: %s", e)
                self.last_error = str(e)
                return None
            except Exception as e:
                log.exception("snapshot write failed")
                self.last_error = str(e)
                return None
        self._last_write = time.perf_counter()
        self.last_path = path
        self.last_error = None
        return path
