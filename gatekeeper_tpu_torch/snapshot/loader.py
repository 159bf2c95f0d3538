"""SnapshotLoader: validate, restore, delta-resync.

Restore sequence (startup only, before controllers/audit start):

  1. validate    — manifest HMAC + schema + code fingerprint + per-file
                   checksums (format.read_manifest); any failure moves
                   on to the next-older snapshot, then to the cold path
  2. load        — np.load the packed arrays, parse row metadata,
                   structural consistency checks
  3. install     — interner vocabulary, template/constraint registry
                   (via the client, so CRDs re-synthesize), the frozen
                   inventory tree + reviews wholesale, audit-pack
                   adoption (ops/auditpack.py adopt_restored)
  4. delta resync— list the snapshot's GVKs from the kube API
                   (metadata-only listing when the kube surface offers
                   one) and reconcile per object by resourceVersion:
                     same RV   -> nothing: the restored tree, reviews
                                  and packed row already hold exactly
                                  this content
                     diff RV / -> normal add_data (change-logged; only
                     new path     this row re-packs on the next sweep,
                                  via the existing ops/auditpack.py /
                                  ops/deltasweep.py machinery)
                     gone path -> delete_data (change-logged; the pack
                                  tombstones the row on sync)
                   so the first sweep's host cost is O(churn while
                   down), not O(cluster)
  5. delta basis — when the snapshot carries the incremental-sweep
                   state (counts, candidates, bit-packed base mask,
                   rendered-result cache) and the restored constraint
                   order matches, the first capped sweep runs the
                   O(churn) delta path — no full [C, R] dispatch, and
                   unchanged constraints reuse their persisted rendered
                   results.

Outcomes (snapshot_restore_outcome_total{outcome}):
  restored — a snapshot validated and seeded the pack
  fallback — snapshots existed but none was usable, a mid-restore
             failure forced a state wipe, or the RVs were fully stale
             (every row re-packs: cold-equivalent work, done safely)
  none     — no snapshot on disk (ordinary cold start)

plus one `quarantined` sample per snapshot that FAILED validation and
was renamed aside into `<root>/.quarantine/` (docs/failure-modes.md):
a corrupt snapshot is inspected once, never re-validated — and
re-failed — on every subsequent restart.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import faults
from .. import logging as gklog
from ..metrics.catalog import record_snapshot_load, record_snapshot_outcome
from ..obs import trace as obstrace
from ..process.excluder import SYNC
from . import format as fmt
from .format import SnapshotError

log = gklog.get("snapshot")


def _load_json(snap_dir: str, name: str):
    try:
        with open(os.path.join(snap_dir, name)) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotError(f"{name} unreadable: {e}")


class SnapshotLoader:
    def __init__(self, root: str, quarantine: Optional[bool] = None):
        self.root = root
        # quarantine policy: None (default) follows ownership — the
        # resync=True restore path is the dir's OWNER (single-process or
        # the audit role) and moves validation-failed snapshots aside;
        # the resync=False path is a read-mostly fleet consumer of a
        # SHARED dir and must never mutate warmth it does not own
        # (docs/fleet.md trust model, tests/test_snapshot_concurrent.py)
        self.quarantine = quarantine
        # filled by restore(): resync statistics for logs/bench, and
        # whether the incremental-sweep basis was installed
        self.stats: Dict[str, Any] = {}
        self.delta_restored = False

    # ---- read + validate one snapshot -------------------------------------

    def _read(self, snap_dir: str) -> Dict[str, Any]:
        fmt.read_manifest(snap_dir)  # hmac + fingerprint + checksums
        if faults.ENABLED:
            # post-seal payload-validation seam: an error-mode rule models
            # a snapshot whose sealed bytes fail structural validation —
            # the quarantine path, not the try-the-next-snapshot path
            try:
                faults.fire(faults.SNAPSHOT_CORRUPT)
            except Exception as e:
                raise SnapshotError(f"injected corruption: {e}")
        interner = _load_json(snap_dir, fmt.INTERNER)
        registry = _load_json(snap_dir, fmt.REGISTRY)
        pack = _load_json(snap_dir, fmt.PACK)
        if not isinstance(interner, list) or not interner or interner[0] != "":
            raise SnapshotError("interner table malformed")
        if not isinstance(registry, dict) or not isinstance(pack, dict):
            raise SnapshotError("registry/pack malformed")
        try:
            with np.load(
                os.path.join(snap_dir, fmt.ARRAYS), allow_pickle=False
            ) as npz:
                arrays = {k: npz[k] for k in npz.files}
        except Exception as e:
            raise SnapshotError(f"arrays unreadable: {e}")
        rp = {
            k[len("rp:"):]: v for k, v in arrays.items()
            if k.startswith("rp:")
        }
        col_index = [fmt.decode_key(k) for k in pack.get("col_index", [])]
        cols: Dict[Any, Dict[str, np.ndarray]] = {ck: {} for ck in col_index}
        for k, v in arrays.items():
            if not k.startswith("col:"):
                continue
            _tag, idx_s, leaf = k.split(":", 2)
            try:
                ck = col_index[int(idx_s)]
            except (ValueError, IndexError):
                raise SnapshotError(f"array key {k!r} has no column index")
            cols[ck][leaf] = v
        row_path = pack.get("row_path")
        row_ns = pack.get("row_ns")
        free = pack.get("free")
        rvs = pack.get("rv")
        n_rows = pack.get("n_rows")
        if not (
            isinstance(row_path, list) and isinstance(row_ns, list)
            and isinstance(free, list) and isinstance(rvs, list)
            and isinstance(n_rows, int)
            and len(row_path) == len(row_ns) == len(rvs)
        ):
            raise SnapshotError("pack row metadata malformed")
        if not rp or "valid" not in rp:
            raise SnapshotError("review-side arrays missing")
        capacity = len(rp["valid"])
        if n_rows > capacity or len(row_path) > capacity:
            raise SnapshotError("row metadata exceeds array capacity")
        for k, v in rp.items():
            if len(v) != capacity:
                raise SnapshotError(f"rp[{k}] capacity mismatch")
        for ck, leaves in cols.items():
            if not leaves:
                raise SnapshotError("column store entry with no arrays")
            for leaf, v in leaves.items():
                if len(v) != capacity:
                    raise SnapshotError("column capacity mismatch")
        col_keys = tuple(fmt.decode_key(k) for k in pack.get("col_keys", []))
        if set(col_keys) != set(col_index):
            raise SnapshotError("column key set mismatch")
        # the inventory pickle is parsed LAST and only because the
        # manifest hmac + checksum already authenticated its bytes
        import pickle

        try:
            with open(os.path.join(snap_dir, fmt.INVENTORY), "rb") as f:
                inv = pickle.load(f)
        except Exception as e:
            raise SnapshotError(f"inventory unreadable: {e}")
        if not isinstance(inv, dict):
            raise SnapshotError("inventory malformed")
        reviews = inv.get("reviews")
        row_gen = inv.get("row_gen")
        if not (
            isinstance(reviews, list) and isinstance(row_gen, list)
            and len(reviews) == len(row_path) == len(row_gen)
        ):
            raise SnapshotError("inventory row lists malformed")
        return {
            "interner": interner,
            "templates": registry.get("templates") or [],
            "constraints": registry.get("constraints") or [],
            "rp": rp,
            "cols": cols,
            "col_keys": col_keys,
            "row_path": [
                tuple(p) if isinstance(p, list) else None for p in row_path
            ],
            "row_ns": row_ns,
            "free": free,
            "n_rows": n_rows,
            "rv": rvs,
            "reviews": reviews,
            "row_gen": row_gen,
            "delta": inv.get("delta"),
        }

    # ---- install -----------------------------------------------------------

    def _install(self, client, state: Dict[str, Any]):
        driver = client.driver
        interner = driver.interner
        with driver._lock:
            strings = state["interner"]
            if interner._strings != strings[: len(interner._strings)]:
                raise SnapshotError(
                    "live interner diverges from snapshot vocabulary"
                )
            interner._strings = list(strings)
            interner._ids = {s: i for i, s in enumerate(strings)}
            for tmpl in state["templates"]:
                client.add_template(tmpl)
            for c in state["constraints"]:
                # schema validation happened when the constraint first
                # entered the engine; the manifest seal vouches for the
                # persisted copy, so restore installs directly
                kind = c.get("kind")
                name = (c.get("metadata") or {}).get("name")
                if not kind or not name:
                    raise SnapshotError("constraint missing kind/name")
                driver.put_constraint(kind, name, c)
            # rebuild the store tree from the reviews' objects.  Leaves
            # are frozen eagerly ONLY when an installed template reads
            # data.inventory (the one consumer that hashes them —
            # _inventory_for_render's contract); inventory-free corpora
            # adopt plain-dict leaves and skip the O(cluster) freeze,
            # with store.frozen() converting lazily if a later template
            # install ever needs it
            from ..engine.value import freeze

            uses_inv = any(
                getattr(t.policy, "uses_inventory", True)
                for t in driver.templates.values()
            )
            tree: Dict[str, Any] = {}
            for row, seg in enumerate(state["row_path"]):
                if seg is None:
                    continue
                review = state["reviews"][row]
                obj = (
                    review.get("object") if isinstance(review, dict)
                    else None
                )
                if obj is None:
                    raise SnapshotError(f"row {row} review missing object")
                node = tree
                for s in seg[:-1]:
                    node = node.setdefault(s, {})
                node[seg[-1]] = freeze(obj) if uses_inv else obj
            driver.store.adopt_tree(tree, leaves_frozen=uses_inv)
            driver._audit_pack.adopt_restored(
                rp=state["rp"],
                cols=state["cols"],
                col_keys=state["col_keys"],
                reviews=state["reviews"],
                row_path=state["row_path"],
                row_ns=state["row_ns"],
                row_gen=state["row_gen"],
                free=state["free"],
                n_rows=state["n_rows"],
                synced_epoch=driver.store.epoch,
            )

    # ---- delta resync -------------------------------------------------------

    @staticmethod
    def _kube_get(kube, gvk, name: str, ns: str):
        try:
            return kube.get(gvk, name, ns)
        except Exception:
            return None  # deleted between list and get: next pass catches

    def _resync(self, client, kube, state: Dict[str, Any],
                excluder=None) -> Dict[str, int]:
        """Reconcile the restored state against the live API by
        resourceVersion.  The listing is metadata-only when the kube
        surface offers `list_rvs` (the real apiserver analogue is a
        PartialObjectMetadata list) — matched objects then cost one dict
        lookup, never a body transfer or a freeze."""
        driver = client.driver
        recorded: Dict[Tuple[str, ...], Tuple[int, str]] = {}
        snap_kinds = set()
        for row, seg in enumerate(state["row_path"]):
            if seg is None:
                continue
            ident = fmt.path_identity(seg)
            if ident is None:
                raise SnapshotError(f"row path {seg!r} not object-depth")
            recorded[seg] = (row, state["rv"][row])
            snap_kinds.add((ident[0], ident[1]))
        stats = {"matched": 0, "changed": 0, "added": 0, "deleted": 0}
        seen_rows: set = set()
        if faults.ENABLED:
            faults.fire(faults.SNAPSHOT_RESYNC)
        with driver._lock:
            for gvk in kube.list_gvks():
                api = fmt.gvk_api_version(gvk)
                kind = gvk[2]
                if (api, kind) not in snap_kinds:
                    # GVKs the snapshot never held flow through the normal
                    # controller replay (store.put dedups re-lists by RV)
                    continue
                if hasattr(kube, "list_rvs"):
                    entries = [
                        (ns, name, rv, None)
                        for (ns, name), rv in kube.list_rvs(gvk).items()
                    ]
                else:
                    entries = []
                    for obj in kube.list(gvk):
                        meta = obj.get("metadata") or {}
                        entries.append((
                            meta.get("namespace") or "",
                            meta.get("name") or "",
                            str(meta.get("resourceVersion") or ""),
                            obj,
                        ))
                for ns, name, rv, obj in entries:
                    segments = (
                        ("namespace", ns, api, kind, name) if ns
                        else ("cluster", api, kind, name)
                    )
                    rec = recorded.get(segments)
                    if rec is None:
                        if excluder is not None and ns and \
                                excluder.is_namespace_excluded(SYNC, ns):
                            continue
                        obj = obj if obj is not None else self._kube_get(
                            kube, gvk, name, ns)
                        if obj is None:
                            continue
                        client.add_data(obj)  # created while down: new row
                        stats["added"] += 1
                        continue
                    row, snap_rv = rec
                    seen_rows.add(row)
                    if snap_rv and str(rv) == snap_rv:
                        # the restored tree, review and packed row already
                        # hold exactly this content: nothing to do
                        stats["matched"] += 1
                        continue
                    obj = obj if obj is not None else self._kube_get(
                        kube, gvk, name, ns)
                    if obj is None:
                        driver.delete_data(segments)
                        stats["deleted"] += 1
                        continue
                    client.add_data(obj)  # change-logged: row re-packs
                    stats["changed"] += 1
            for seg, (row, _rv) in recorded.items():
                if row not in seen_rows:
                    # change-logged delete: the pack tombstones the row
                    # through the ordinary sync machinery
                    driver.delete_data(seg)
                    stats["deleted"] += 1
            # epoch bump without a change-log entry: sweep/frozen caches
            # re-read; ap.synced_epoch stays at its adoption value, so the
            # next sync() consumes exactly the changes logged above
            driver.store.invalidate_frozen()
        return stats

    # ---- delta-sweep basis ---------------------------------------------------

    def _restore_delta(self, client, state: Dict[str, Any]) -> bool:
        """Install the persisted incremental-sweep state so the first
        capped audit runs the O(churn) delta path.  Refused (False) when
        the restored constraint order diverges from the snapshot's — the
        per-constraint indices would be misaligned; the first sweep then
        falls back to one full dispatch, which rebases everything.

        Where the port differs from the JAX package after this: the
        controllers' replay re-puts every constraint from the API store,
        whose status and resourceVersion have usually moved since the
        snapshot.  TorchDriver.put_constraint ignores such a re-put, so
        this basis serves the first sweep; the JAX package's TpuDriver
        skips only an identical replay, so there the replay rebases it
        with one full sweep.  The results are the same: neither field is
        read by evaluation or the render."""
        delta = state.get("delta")
        if not delta:
            return False
        driver = client.driver
        from ..convert import to_device
        from ..ops.deltasweep import DeltaState, MaskSource
        from ..parallel.mesh import ShardedMask

        with driver._lock:
            ap = driver._audit_pack
            cur_keys = [
                (k, n) for k, n, _c in driver._ordered_constraints()
            ]
            if cur_keys != [tuple(k) for k in delta["ordered_keys"]]:
                log.warning(
                    "snapshot delta basis dropped: constraint order "
                    "diverged (first sweep will be a full dispatch)"
                )
                return False
            # width-drift invalidation: a basis produced under a different
            # sweep sharding layout (mesh width) carries that layout's row
            # padding in its base mask — rebase via one full sweep instead
            # of serving candidates across a drifted slab geometry.  A
            # basis missing the field predates the stamp; those were all
            # produced by the single-device sweep, so treat as width 1.
            snap_width = int(delta.get("mesh_width") or 1)
            live_width = driver.mesh_layout()
            if snap_width != live_width:
                log.warning(
                    "snapshot delta basis dropped: sweep sharding width "
                    "drifted (snapshot %d, live %d); first sweep will be "
                    "a full dispatch", snap_width, live_width,
                )
                return False
            shape = tuple(delta["mask_shape"])
            mask = np.unpackbits(
                np.asarray(delta["mask_packed"]), axis=1, count=shape[1]
            ).astype(bool)
            if mask.shape != shape or shape[1] != ap.capacity:
                log.warning("snapshot delta basis dropped: mask shape "
                            "mismatch")
                return False
            # re-bind the compiled render plans eagerly and validate the
            # classification against the snapshot's: the persisted render
            # cache holds rendered Results, and reusing them under a
            # DIFFERENT plan classification (a plan-compiler change
            # between writer and reader) could mask a rendering change —
            # drop the cache and re-render on mismatch, keep the rest of
            # the warm basis either way
            render_cache = delta["render_cache"]
            persisted_plans = delta.get("render_plans")
            if persisted_plans is not None:
                if driver._render_plan_tiers() != dict(persisted_plans):
                    log.warning(
                        "snapshot render-plan classification diverged "
                        "from the rebuilt plans; dropping the persisted "
                        "render cache (first sweep re-renders)"
                    )
                    render_cache = {}
            # referential policies: rebuild the persisted join-group
            # index (ops/joinkernel.py).  Plan drift — a template change
            # reclassifying the join families between writer and reader —
            # or a missing index drops the WHOLE basis: candidates and
            # counts were produced by the old aggregates, and the delta
            # path cannot maintain aggregates it has no index for.
            plans = ()
            if hasattr(driver, "_active_join_plans"):
                plans = driver._active_join_plans()
            join_state = None
            if plans:
                from ..ops.joinkernel import JoinState

                ji = delta.get("join_index")
                join_state = (
                    JoinState.restore(tuple(plans), ji, ap.rebuild_gen)
                    if ji else None
                )
                if join_state is None:
                    log.warning(
                        "snapshot delta basis dropped: referential join "
                        "plans active but the persisted join index is "
                        "missing or drifted (first sweep will be a full "
                        "dispatch)"
                    )
                    return False
            # device upload stays lazy: the first sweep with zero churn
            # never needs the mask at all.  Under a mesh the mask goes
            # back in row slabs, each on its shard's device, in the slab
            # geometry of a sweep at this width (the same-width check
            # above guarantees it matches; ShardedMask.place pads past the
            # capacity as the sweep's slabs are padded) — the mesh's delta
            # sweep gathers each row's before-column on its owning shard.
            # On one device it is a bool tensor on the driver's device.
            # Either way one copy a device, pinned and asynchronous on the
            # card, where the JAX package calls jax.device_put
            mesh = driver._mesh()
            if mesh is not None:
                mask_src = MaskSource(
                    lambda: ShardedMask.place(mask, mesh)
                )
            else:
                mask_src = MaskSource(
                    lambda: to_device(mask, driver.device)
                )
            driver._delta_state = DeltaState.from_restore(
                counts=delta["counts"],
                cand=delta["cand"],
                horizon=delta["horizon"],
                crow=delta["crow"],
                K=int(delta["K"]),
                mask_src=mask_src,
                row_cols=delta["row_cols"],
                render_cache=render_cache,
                cs_epoch=driver._cs_epoch,
                layout_gen=ap.layout_gen,
                store_epoch=driver.store.epoch,
                # the same-width check above ran against the live layout,
                # so the restored basis carries exactly that topology
                mesh_width=live_width,
            )
            if join_state is not None:
                driver._join_state = join_state
        return True

    # ---- the whole restore --------------------------------------------------

    def restore(self, client, kube, excluder=None, resync: bool = True) -> str:
        """Try every snapshot newest-first; returns the outcome string
        (restored / fallback / none) after recording it in metrics.
        Validation failures fall through to older snapshots; a failure
        AFTER state installation wipes back to a clean cold start.

        ``resync=False`` skips step 4 (the resourceVersion reconcile
        against the live API): fleet webhook replicas adopting a SHARED
        warm snapshot pass this — their local store starts empty, so a
        resync would read every restored row as deleted and tombstone
        the pack they just adopted.  The watch replay still reconciles
        the store afterwards (store RV dedup turns it into a delta
        resync), and the pack they restored is read-mostly state they
        do not own (docs/fleet.md)."""
        t0 = time.perf_counter()
        names = fmt.list_snapshots(self.root)
        if not names:
            record_snapshot_outcome("none")
            self.stats = {}
            return "none"
        outcome = "fallback"
        quarantine = self.quarantine if self.quarantine is not None \
            else resync
        with obstrace.root_span("snapshot.restore", snapshots=len(names)):
            for name in names:
                snap_dir = os.path.join(self.root, name)
                try:
                    with obstrace.span("snapshot.load", snapshot=name):
                        if faults.ENABLED:
                            faults.fire(faults.SNAPSHOT_LOAD)
                        state = self._read(snap_dir)
                except SnapshotError as e:
                    log.warning("snapshot %s rejected: %s", name, e)
                    if quarantine:
                        self._quarantine(snap_dir, name, str(e))
                    continue
                except Exception as e:
                    log.exception("snapshot %s unreadable", name)
                    if quarantine:
                        self._quarantine(snap_dir, name, repr(e))
                    continue
                try:
                    with obstrace.span("snapshot.install",
                                       rows=state["n_rows"]):
                        self._install(client, state)
                    if resync:
                        with obstrace.span("snapshot.resync") as sp:
                            stats = self._resync(
                                client, kube, state, excluder=excluder
                            )
                            sp.set_attrs(**stats)
                    else:
                        stats = {"resync": "skipped"}
                    self.delta_restored = self._restore_delta(client, state)
                except Exception:
                    # any failure past validation may have left partial
                    # state (e.g. adopt_tree landed, adopt_restored did
                    # not): always wipe — on a still-clean driver the
                    # wipe is a harmless no-op
                    log.exception(
                        "snapshot %s failed mid-restore; wiping to the "
                        "cold path", name,
                    )
                    self._wipe(client)
                    break
                self.stats = stats
                live_rows = sum(
                    1 for p in state["row_path"] if p is not None
                )
                if not resync:
                    # adopted wholesale (fleet shared-warmth path): the
                    # snapshot IS the state; staleness is the watch
                    # replay's problem, not a fallback condition
                    outcome = "restored"
                elif live_rows and not stats["matched"]:
                    # fully stale RVs: every row re-packs — safe, but
                    # cold-equivalent, so report it as the fallback it is
                    log.warning(
                        "snapshot %s resourceVersions fully stale "
                        "(%d rows, 0 matched): first sweep re-packs "
                        "everything", name, live_rows,
                    )
                    outcome = "fallback"
                else:
                    outcome = "restored"
                gklog.log_event(
                    log, "snapshot restored",
                    **{gklog.EVENT_TYPE: "snapshot_restored",
                       "snapshot_dir": snap_dir, "outcome": outcome,
                       **stats},
                )
                break
        record_snapshot_load(time.perf_counter() - t0)
        record_snapshot_outcome(outcome)
        return outcome

    def _quarantine(self, snap_dir: str, name: str, reason: str):
        """Move a snapshot that failed validation aside into
        `<root>/.quarantine/<name>` so it is inspected once and never
        re-validated (and re-failed) on every subsequent restart — a
        corrupt newest snapshot otherwise taxes every restore attempt
        forever.  One `snapshot_restore_outcome_total{outcome=
        "quarantined"}` sample per moved snapshot; a failed rename is
        logged and swallowed (quarantine is hygiene, never a reason to
        fail the restore that already fell past this snapshot)."""
        qroot = os.path.join(self.root, fmt.QUARANTINE_DIR)
        try:
            os.makedirs(qroot, exist_ok=True)
            dst = os.path.join(qroot, name)
            if os.path.exists(dst):
                # a same-named quarantined dir already exists (clock
                # reuse): keep both, suffixed by arrival order
                n = 1
                while os.path.exists(f"{dst}.{n}"):
                    n += 1
                dst = f"{dst}.{n}"
            os.rename(snap_dir, dst)
        except OSError:
            log.exception("failed to quarantine snapshot %s", name)
            return
        record_snapshot_outcome("quarantined")
        gklog.log_event(
            log, "snapshot quarantined",
            **{gklog.EVENT_TYPE: "snapshot_quarantined",
               "snapshot_dir": snap_dir, "quarantined_to": dst,
               "reason": reason[:500]},
        )

    @staticmethod
    def _wipe(client):
        """Return a partially-restored driver to a clean cold start:
        wipe the replicated inventory (change-logged as a wipe, so every
        downstream cache rebuilds) and drop the adopted pack.  The
        template/constraint registry stays — those restored via the
        client API are valid regardless."""
        driver = client.driver
        try:
            with driver._lock:
                driver.store.delete(())
                from ..ops.auditpack import AuditPackCache

                driver._audit_pack = AuditPackCache()
        except Exception:
            log.exception("post-failure wipe failed")
