"""TorchDriver: the vectorized PyTorch/CUDA evaluation backend.

Pipeline per review batch or audit sweep:
  1. host: pack reviews + constraints into integer/float arrays (ops/pack.py,
     columns.py, params.py; incremental interner) and carry them onto the
     device (convert.py)
  2. device: the match kernel (K1) -> bool[C, R]; every template-structure
     group's violation program, as bytecode (ops/progcode.py), ANDed into
     its static row block by one launch of the program kernel (K9, with
     K2's and K3's cell functions inside, ops/program.py); for capped
     audits the packed [C, 1+K] reduction (K4); for reviews the mask and
     the autoreject mask bit-packed into one uint8 array at the end of
     K9's launch (K10's pack, ops/packbits.py), the one array downloaded
  3. host: for each positive cell, the exact native match re-check and the
     violation render — through the compiled render plan (ops/renderplan.py)
     where the template has one, else the interpreter

Correctness never depends on the device mask being tight, only
throughput does.  Templates with no vectorized program get all-true
columns (pure interpreter render for their cells).

This is the main path of gatekeeper_tpu/ops/driver.py TpuDriver with its
semantics kept — the group-major padded constraint layout, review-mode
evaluation (join nodes resolve to their polarity default), masks gathered
through ``crow``, the capped render and its "exact"/"resources" totals —
and its serving machinery left out: every review evaluates on the device,
with no tier routing, request memo, circuit breaker or compile cache.

Audits are incremental, as in TpuDriver: a full sweep keeps its [C, R]
mask resident and rebases the host-side DeltaState (ops/deltasweep.py);
later sweeps evaluate only the dirty rows and fold the [C, 2w] before |
after columns of the delta gather (K5) into it, and the next full sweep
patches the dirty rows into the resident inputs with the row scatter (K6).
Left out: the background warm-up of the base mask (nothing here compiles
per shape).

Referential templates (ops/joinkernel.py) are exact on the audit path: a
full sweep evaluates in 'trace' join mode, each plan's key table built on
the card by K7 from the resident columns, and rebuilds the host join-group
index (JoinState); a delta sweep also re-evaluates the readers of every key
group its churn touched, against the index's tables ('tables' mode); every
JoinCmp lookup is K8.  Flagged cells of a join-safe template render against
a pruned inventory holding only their key groups' provider rows.  Left out:
the join metrics and route ledger, and the index in snapshots.

Audit sweeps shard the resource axis over a mesh of devices when one is
visible (parallel/mesh.py; GK_MESH, set_mesh): the resident inventory lives
in contiguous row slabs, one a shard, committed once per pack layout and
patched by K6 on the owning shards only; each shard runs K1 -> K9 -> K4
(K4 writing global rows) on its slab, each join plan's table is K7 per
shard and K7's merge, and the host merges the [W, C, 1+K'] reductions.  A
delta sweep evaluates its dirty rows on the mesh's first device and K5
gathers their before-columns on their owning shards.  compute_masks, and
so review_batch, evaluates the review batch in row slabs too, as
TpuDriver's _dispatch does: K1 -> K9 (packing) on each shard, each
shard's packed mask unpacked to its own slab.  Left out: the mesh's
metrics and flight-recorder events, and the circuit breaker that a stalled
dispatch trips there (a stall degrades the mesh and raises).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..client.drivers import (
    CompiledTemplate,
    InterpDriver,
    Result,
    constraint_match_spec,
    constraint_parameters,
)
from ..convert import (
    group_params_from_numpy,
    state_from_numpy,
    take_rows,
    tree_nbytes,
)
from ..parallel.mesh import (
    DISPATCH_LOCK,
    MeshDispatchStall,
    ShardedMask,
    audit_mesh,
    maybe_audit_mesh,
    owning_shards,
    replicate_tree,
    shard_review_side,
    sharded_masks,
    slab_rows,
    visible_devices,
)
from ..device import kernels, select_device
from ..target.match import constraint_matches, needs_autoreject
from ..target.target import K8sValidationTarget
from .auditpack import AuditPackCache
from .columns import extract_columns
from .delta import delta_columns, delta_index
from .deltasweep import DeltaState, MaskSource, NeedsFullSweep
from .interning import Interner, PredicateTable
from .matchkernel import constraint_records, match_kernel
from .pack import _bucket as _bucket_pow2, pack_constraints, pack_reviews
from .packbits import packed_empty, unpack_review_masks
from .params import pack_params
from .reduction import packed_reduction
from .scatter import scatter_rows
from .vectorizer import vectorize
from .program import bind_group, lookup_joins, program_eval
from .progcode import encode
from .vexpr import EvalEnv, VProgram

log = logging.getLogger("gatekeeper_tpu_torch.driver")

# _bound_plans miss sentinel (None is a valid cached "no plan")
_PLAN_MISS = object()


def _evaluated_part(constraint):
    """A constraint without what a status write changes: its status and
    metadata.resourceVersion, which neither evaluation nor the render
    reads."""
    if not isinstance(constraint, dict):
        return constraint
    out = {k: v for k, v in constraint.items() if k != "status"}
    md = out.get("metadata")
    if isinstance(md, dict) and "resourceVersion" in md:
        out["metadata"] = {k: v for k, v in md.items()
                           if k != "resourceVersion"}
    return out


def _constraint_name(constraint: dict) -> str:
    md = constraint.get("metadata")
    if isinstance(md, dict):
        return str(md.get("name", ""))
    return ""


class TorchDriver(InterpDriver):
    """Drop-in Driver with device-side batched evaluation.  Inherits state
    management (templates/constraints/store) and the interpreter render
    from InterpDriver.  ``device=None`` means the CUDA card (and raises
    without one); pass ``device="cpu"`` for the plain PyTorch versions."""

    # Candidate rows fetched per constraint for the capped audit: at least
    # this many, and at least 2x the cap (oversampling absorbs device
    # over-approximation without a mask-row fetch).  Power-of-two.
    AUDIT_TOPK_MIN = 32
    # audit render memo bound; at the cap the oldest 1/16 is evicted
    RENDER_MEMO_MAX = 2_000_000
    # dirty rows per steady-state sweep beyond which a full device sweep
    # is cheaper than the delta evaluation + host merge
    DELTA_MAX_ROWS = 256
    # cumulative rows tracked since the last full sweep beyond which the
    # state is rebased (bounds row_cols host memory at ~ROWS_MAX x C bytes)
    DELTA_ROW_COLS_MAX = 8192

    def __init__(self, target: Optional[K8sValidationTarget] = None,
                 device=None, mesh_watchdog_s: Optional[float] = None):
        super().__init__(target)
        self.device = select_device(device)
        # several devices: the audit sweep's row axis sharded over a mesh
        # (parallel/mesh.py).  GK_MESH=0 keeps the single-device path,
        # GK_MESH=1 (the default) meshes every visible device, GK_MESH=<n>
        # for n >= 2 pins the mesh to the first n; the visible devices are
        # visible_devices()'s (the cards, or GK_VIRTUAL_DEVICES slots of
        # one device).  Mutate via set_mesh(), which invalidates every
        # cache keyed on the topology.
        mesh_env = os.environ.get("GK_MESH", "1")
        try:
            width = int(mesh_env)
        except ValueError:
            width = -1
        if width < 0:
            raise ValueError(
                f"GK_MESH={mesh_env!r} is not a non-negative integer"
            )
        if width > 1 and width > len(visible_devices(self.device)):
            raise ValueError(
                f"GK_MESH={mesh_env} exceeds visible devices "
                f"({len(visible_devices(self.device))})"
            )
        self.mesh_enabled = mesh_env != "0"
        self.mesh_width: Optional[int] = width if width > 1 else None
        self._mesh_cache: Optional[tuple] = None
        # a mesh dispatch that runs past this many seconds is written off
        # (MeshDispatchStall) and the mesh narrowed; None or 0: no watchdog
        self.mesh_watchdog_s = mesh_watchdog_s
        # eager native build/load: the g++ compile happens here, not
        # inside the first review
        from ..native import load as _load_native

        _load_native()
        # eager kernel build/load on the card, likewise: nvcc runs here,
        # never inside an admission request's deadline, and a failed
        # build raises here (wait_ready)
        self.kernels_load_s = 0.0
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            kernels()
            self.kernels_load_s = time.perf_counter() - t0
        self.interner = Interner()
        self.programs: Dict[str, Optional[VProgram]] = {}
        self.pred_cache: Dict[Tuple[str, str], PredicateTable] = {}
        # constraint-side packing, invalidated on any template/constraint
        # mutation and on vocabulary growth (str-pred tables are vocab-sized)
        self._cs_epoch = 0
        self._cs_cache = None
        self._cs_device_cache = None
        self._ordered_cache = None
        # resident incremental audit packing (ops/auditpack.py) and its
        # device copy: (layout_gen, (rv, cols)), patched in place by the
        # row scatter (K6) and re-uploaded only when the layout changed;
        # under a mesh the slabs, (layout_gen, mesh, [(rv, cols)])
        self._audit_pack = AuditPackCache()
        self._audit_dev = None
        self._audit_dev_mesh = None
        # the last full sweep, served again while neither the inventory
        # nor the constraint side changed: (key, sweep, host mask or None)
        self._audit_cache = None
        # incremental O(changes) sweep (ops/deltasweep.py): steady-state
        # audits evaluate only dirty rows and fold them into host-side
        # counts and candidate lists; GK_DELTA=0 forces every sweep down
        # the full path
        self.delta_enabled = os.environ.get("GK_DELTA", "1") != "0"
        self._delta_state = None
        # referential-policy state (ops/joinkernel.py): the host-side
        # join-group index (key -> provider/reader rows) that gives the
        # delta sweep O(churn) key-group invalidation, and the per-epoch
        # unique-plan and join-safe caches
        self._join_state = None
        self._join_plans_cache: Optional[tuple] = None
        self._join_safe_cache: Optional[tuple] = None
        # audit render memo: (kind, name, row) -> (row_gen, violations),
        # valid for one constraint-side epoch
        self._render_memo: Dict[Tuple, Tuple[int, list]] = {}
        self._render_memo_epoch = -1
        # compiled render plans bound per constraint, per epoch
        self._bound_plans: Dict[Tuple[str, str], object] = {}
        self._bound_plans_epoch = -1
        self._uses_inventory_cache: Optional[Tuple[int, bool]] = None
        # per-sweep stage times and counts (read by chip_smoke.py)
        self.last_sweep_stats: Dict[str, float] = {}
        # running totals of constraint-side re-packs and uploads, and the
        # host time they took (read by chip_smoke.py around each review)
        self.side_stats: Dict[str, float] = {
            "repacks": 0, "pack_ms": 0.0, "uploads": 0, "upload_ms": 0.0,
        }

    # ---- lifecycle --------------------------------------------------------

    def wait_ready(self, timeout: Optional[float] = 120.0) -> bool:
        """True once the kernels are built and loaded (TpuDriver's
        signature; there it waits for the background compile).  They load
        when the driver is constructed on the card, so this never waits
        and ``timeout`` is unused; a failed build raises.  On the CPU
        there is nothing to load."""
        if self.device.type == "cuda":
            kernels()
        return True

    def put_template(self, kind: str, artifact: CompiledTemplate):
        with self._lock:
            super().put_template(kind, artifact)
            self.programs[kind] = vectorize(artifact.policy)
            self._cs_epoch += 1

    def delete_template(self, kind: str) -> bool:
        with self._lock:
            self.programs.pop(kind, None)
            out = super().delete_template(kind)
            self._cs_epoch += 1
            return out

    def put_constraint(self, kind: str, name: str, constraint: dict):
        with self._lock:
            stored = self.constraints.get(kind, {}).get(name)
            if stored is not None and stored is not constraint and \
                    _evaluated_part(stored) == _evaluated_part(constraint):
                # a replay that changes nothing evaluation reads: the
                # constraint controller re-puts every constraint whose
                # status the audit just wrote (a new status and
                # resourceVersion), and an epoch bump would rebase the
                # delta basis, so every audit cycle behind the App would
                # be a full sweep.  TpuDriver.put_constraint skips only an
                # identical replay.  The same holds for the replay after a
                # snapshot restore (snapshot/loader.py): the restored basis
                # serves the first sweep, where TpuDriver rebases it once
                # the stored status has moved.  The identity guard: the
                # same dict mutated in place compares equal to itself and
                # must still invalidate
                return
            super().put_constraint(kind, name, constraint)
            self._cs_epoch += 1

    def delete_constraint(self, kind: str, name: str) -> bool:
        with self._lock:
            out = super().delete_constraint(kind, name)
            self._cs_epoch += 1
            return out

    def reset(self):
        with self._lock:
            super().reset()
            self.programs.clear()
            self._cs_cache = None
            self._cs_device_cache = None
            self._ordered_cache = None
            self._audit_pack = AuditPackCache()
            self._audit_dev = None  # layout gens restart with the new pack
            self._audit_dev_mesh = None
            self._audit_cache = None
            self._delta_state = None
            self._join_state = None
            self._render_memo.clear()
            self._bound_plans.clear()
            self._bound_plans_epoch = -1
            self._cs_epoch += 1

    # ---- the mesh (parallel/mesh.py) ---------------------------------------

    def _mesh(self):
        """The audit sweep's mesh: every visible device (or the pinned
        mesh_width), data-parallel on the resource axis.  None on one
        device, at width 1, or when mesh_enabled is off."""
        if not self.mesh_enabled:
            return None
        if self._mesh_cache is None:
            if self.mesh_width is not None:
                mesh = (audit_mesh(self.mesh_width, self.device)
                        if self.mesh_width > 1 else None)
            else:
                mesh = maybe_audit_mesh(self.device)
            self._mesh_cache = (mesh,)
        return self._mesh_cache[0]

    def set_mesh(self, enabled: bool, width: Optional[int] = None):
        """Switch the mesh topology (on/off, or a pinned device count) and
        invalidate every cache keyed on it: the mesh itself, the resident
        audit slabs, the sweep cache and the delta-sweep basis (its
        resident mask lies in the old topology's slabs).  width=None uses
        every visible device; width=1 forces the single-device path even
        when enabled.  A width past visible_devices() is refused."""
        n = len(visible_devices(self.device))
        if enabled and width is not None and width > n:
            raise ValueError(f"mesh width {width} exceeds visible devices "
                             f"({n})")
        with self._lock:
            self.mesh_enabled = bool(enabled)
            self.mesh_width = width
            self._mesh_cache = None
            self._audit_dev = None
            self._audit_dev_mesh = None
            self._audit_cache = None
            self._delta_state = None

    def mesh_layout(self) -> int:
        """The row-sharding width serving audit sweeps: the active mesh's
        device count, 1 on the single-device path.  A delta basis stamped
        with another width is refused (_try_delta)."""
        mesh = self._mesh()
        return 1 if mesh is None else int(mesh.devices.size)

    def _guarded_mesh_dispatch(self, mesh, thunk):
        """Run one mesh dispatch (every shard's launches) under the
        dispatch gate, with the stall watchdog when mesh_watchdog_s is
        set: then the guarded dispatch runs on a worker thread the caller
        joins with the budget; a timeout (the gate never freed, or the
        dispatch itself wedged) revokes the gate's generation, so
        narrower dispatches can proceed past the wedged holder, narrows
        the mesh (degrade_mesh) and raises MeshDispatchStall.  An
        abandoned worker keeps its operand tensors until its dispatch
        returns."""
        timeout = self.mesh_watchdog_s or 0.0
        if timeout <= 0:
            with DISPATCH_LOCK:
                return thunk()

        def _stall(where: str) -> MeshDispatchStall:
            DISPATCH_LOCK.revoke()
            log.warning("mesh dispatch watchdog: %s exceeded %.3fs at "
                        "width %d", where, timeout, mesh.devices.size)
            self.degrade_mesh()
            return MeshDispatchStall(
                f"mesh dispatch {where} exceeded the {timeout:.3f}s "
                f"watchdog budget"
            )

        token = DISPATCH_LOCK.acquire(timeout=timeout)
        if token is None:
            raise _stall("gate wait")  # a previous dispatch holds the gate
        done = threading.Event()
        box: dict = {}

        def run():
            try:
                box["out"] = thunk()
            except BaseException as e:  # surfaced on the caller's side
                box["err"] = e
            finally:
                done.set()
                # released from the worker: a late (post-revoke) release
                # of an abandoned generation is harmless by design
                DISPATCH_LOCK.release(token)

        threading.Thread(target=run, name="gk-mesh-dispatch",
                         daemon=True).start()
        if not done.wait(timeout):
            raise _stall("dispatch")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def degrade_mesh(self) -> int:
        """Re-shard the audit sweep one step narrower after a stalled
        dispatch (_guarded_mesh_dispatch): width w -> w // 2, bottoming
        out at the single-device path.  set_mesh drops every topology-keyed cache, the delta basis
        included, so the next sweep is one full sweep that rebases the
        incremental state at the new width.  -> the new width."""
        width = self.mesh_layout()
        new = width // 2 if width // 2 >= 2 else 1
        self.set_mesh(True, width=new)
        log.warning("mesh degraded after a dispatch stall: width %d -> %d",
                    width, new)
        return new

    # ---- constraint side --------------------------------------------------

    def _ordered_constraints(self) -> List[Tuple[str, str, dict]]:
        cached = self._ordered_cache
        if cached is not None and cached[0] == self._cs_epoch:
            return cached[1]
        out = []
        for kind in sorted(self.constraints):
            for name in sorted(self.constraints[kind]):
                out.append((kind, name, self.constraints[kind][name]))
        self._ordered_cache = (self._cs_epoch, out)
        return out

    def _constraint_side(self):
        """Cached constraint-side packing: match pack + violation-program
        groups -> (ordered, cp, groups, col_specs, crow).

        Programs are grouped by STRUCTURE, so template clones share one
        group with their constraints batched on the C axis.  The layout is
        group-major with per-group padded blocks: each group occupies mask
        rows [start, start+B), B the bucketed group size, so a group's
        program mask ANDs into a static slice.  Pad rows pack as None
        (valid=False: the match kernel keeps them all-False, so whatever a
        group's padded program rows compute is ANDed away).  crow[i] is
        the padded-layout mask row of sorted constraint i, so every
        host-side gather lands in sorted (kind, name) order."""
        ordered = self._ordered_constraints()
        key = (self._cs_epoch, self.interner.snapshot_size())
        if self._cs_cache and self._cs_cache[0] == key:
            return self._cs_cache[1]

        t0 = time.perf_counter()
        specs = {}
        by_struct: Dict[str, list] = {}
        ungrouped: List[int] = []
        for i, (kind, _n, _c) in enumerate(ordered):
            prog = self.programs.get(kind)
            if not prog:
                ungrouped.append(i)  # match-only rows (no template program)
                continue
            by_struct.setdefault(prog.structure_key(), [prog, []])[1].append(i)
        padded_cs: List[Optional[dict]] = []
        crow: List[int] = [0] * len(ordered)
        groups = []
        for _sk, (prog, idxs) in sorted(by_struct.items()):
            for spec in prog.column_specs:
                specs[spec.key] = spec
            kcs = [ordered[i][2] for i in idxs]
            B = _bucket_pow2(len(kcs))
            start = len(padded_cs)
            for i in idxs:
                crow[i] = len(padded_cs)
                padded_cs.append(ordered[i][2])
            padded_cs.extend([None] * (B - len(kcs)))
            packed = pack_params(kcs, prog, self.interner, self.pred_cache, B)
            groups.append((prog, start, B, packed))
        for i in ungrouped:
            crow[i] = len(padded_cs)
            padded_cs.append(ordered[i][2])
        cp = pack_constraints(padded_cs, self.interner)
        side = (
            ordered, cp, groups, list(specs.values()),
            np.asarray(crow, np.int64),
        )
        # key on the vocab size AFTER param packing interned new strings
        key = (self._cs_epoch, self.interner.snapshot_size())
        self._cs_cache = (key, side)
        self.side_stats["repacks"] += 1
        self.side_stats["pack_ms"] += (time.perf_counter() - t0) * 1e3
        return side

    def _constraint_device(self, side, device=None):
        """The constraint side on ``device`` (default the driver's), cached
        on (epoch, vocab) and placed once per distinct device: (match
        arrays, K1's constraint records, group params)."""
        device = self.device if device is None else torch.device(device)
        key = self._cs_cache[0]
        cache = self._cs_device_cache
        if cache is None or cache[0] != key:
            cache = self._cs_device_cache = (key, {})
        if device in cache[1]:
            return cache[1][device]
        t0 = time.perf_counter()
        _ordered, cp, groups, _specs, _crow = side
        cs = state_from_numpy(cp.arrays, device)
        records = constraint_records(cs) if device.type == "cuda" else None
        gp = group_params_from_numpy(
            [packed for *_s, packed in groups], device
        )
        placed = (cs, records, gp)
        cache[1][device] = placed
        self.side_stats["uploads"] += 1
        self.side_stats["upload_ms"] += (time.perf_counter() - t0) * 1e3
        return placed

    # ---- device evaluation ------------------------------------------------

    def _eval(self, side, rv, cols, placed, join_mode: Optional[str] = None,
              joins=None, pack_out=None, delta=None):
        """The match kernel plus every violation-program group ->
        (candidate mask bool[C, R], autoreject bool[C, R]) on the device.

        ``pack_out`` (a review's uint8[2C, ceil(R/8)], ops/packbits.py
        packed_empty): both masks are also packed into it, by K9's launch
        (program_eval's ``pack``).  ``delta`` (a delta sweep's (resident
        mask, column indices on the device, int8 [C, 2R] output)): the
        before | after columns are written into the output, by K9's launch
        (program_eval's ``delta``).

        ``join_mode`` (ops/joinkernel.py): None on the review path (every
        JoinCmp resolves to its polarity default); 'trace' for full audit
        sweeps, ``joins`` then holding each active plan's kind id and
        vocabulary size (_join_trace_args), the tables built on the card;
        'tables' for delta sweeps, ``joins`` holding the host join index's
        tables on the device (_join_delta_tables)."""
        _ordered, _cp, groups, _specs, _crow = side
        cs, records, gp = placed
        mask, autoreject = match_kernel(rv, cs, records)
        R = mask.shape[1]
        pidx = {}
        if joins is not None:
            pidx = {p: i for i, p in enumerate(self._active_join_plans())}
        # join tables and counts shared ACROSS groups: N template clones of
        # one referential family cost one table build and one lookup per
        # (plan, exclude_self) a sweep
        shared_tables: dict = {}
        staged = []
        for (prog, start, B, _packed), (params, elems, tables) in zip(
            groups, gp
        ):
            keysets = {
                spec.key: cols[spec.key]["ids"]
                for spec in prog.column_specs
                if spec.kind == "keyset"
            }
            prog_cols = {
                spec.key: cols[spec.key]
                for spec in prog.column_specs
                if spec.kind != "keyset"
            }
            # the evaluation's device: a mesh shard's, not the driver's
            env = EvalEnv(
                prog_cols, params, elems, tables, keysets, B, R, mask.device
            )
            if pidx and prog.join_plans:
                from .joinkernel import JoinBinding

                env.joins = JoinBinding(
                    join_mode, prog.join_plans,
                    [joins[pidx[p]] for p in prog.join_plans],
                    rv=rv, cache=shared_tables,
                )
            staged.append((encode(prog), env, start))
        # the join lookups of every group (K8), the table-mode ones in
        # one launch
        lookup_joins([(enc, env) for enc, env, _s in staged])
        bound = [bind_group(enc, env, start) for enc, env, start in staged]
        # every group's program ANDed into its static slice of the fresh
        # match mask, one launch (K9): pad rows are match-False and stay so;
        # a review's launch packs both masks too, a delta sweep's writes
        # its before | after columns
        modes = {}
        if pack_out is not None:
            modes["pack"] = (autoreject, pack_out)
        if delta is not None:
            modes["delta"] = delta
        program_eval(mask, bound, **modes)
        return mask, autoreject

    def _review_pack(self, reviews: List[dict]):
        """Pack ``reviews`` for an evaluation -> (side, review arrays,
        columns, rows), rows the bucketed review count."""
        side = self._constraint_side()
        rp = pack_reviews(reviews, self.interner, self.store.cached_namespace)
        rows = len(rp.arrays["valid"])
        cols = extract_columns(reviews, side[3], self.interner, rows)
        # row packing may have interned new strings: the side re-packs
        # (its predicate tables are vocab-sized)
        return self._constraint_side(), rp.arrays, cols, rows

    def compute_masks(self, reviews: List[dict]):
        """-> (ordered constraints, candidate mask [C, rows], autoreject
        mask [C, rows]) as numpy bool arrays, rows the bucketed review
        count, in sorted constraint order (pad block rows dropped).

        Both masks leave the device as one bit-packed uint8 array, packed
        by K9's launch and unpacked on the host, as in TpuDriver.  Under a
        mesh the review batch is evaluated in row slabs, one a shard
        (sharded_masks)."""
        mesh = self._mesh()
        if mesh is not None:
            return sharded_masks(self, reviews, mesh)
        side, rv, cols, rows = self._review_pack(reviews)
        ordered, cp, _groups, _specs, crow = side
        placed = self._constraint_device(side)
        rv_d = state_from_numpy(rv, self.device)
        cols_d = state_from_numpy(cols, self.device)
        out = packed_empty(cp.arrays["valid"].shape[0], rows, self.device)
        self._eval(side, rv_d, cols_d, placed, pack_out=out)
        packed = out.cpu().numpy()
        mask_np, rej_np = unpack_review_masks([packed], rows, crow, rows)
        return ordered, mask_np, rej_np

    # ---- referential policies (ops/joinkernel.py) -------------------------

    def _active_join_plans(self) -> tuple:
        """Ordered unique JoinPlans across every installed program,
        cached per constraint-side epoch.  Index order is the order of
        the ``joins`` argument of _eval."""
        cached = self._join_plans_cache
        if cached is not None and cached[0] == self._cs_epoch:
            return cached[1]
        plans: List = []
        for kind in sorted(self.programs):
            prog = self.programs.get(kind)
            for p in getattr(prog, "join_plans", ()) or ():
                if p not in plans:
                    plans.append(p)
        out = tuple(plans)
        self._join_plans_cache = (self._cs_epoch, out)
        return out

    def _join_trace_args(self) -> Optional[tuple]:
        """'trace'-mode join arguments, one per active plan: the interned
        remote-kind id, and the vocabulary size K7 counts over (taken
        after every intern, so every packed key id lies below it)."""
        plans = self._active_join_plans()
        if not plans:
            return None
        kind_ids = [self.interner.intern(p.remote_kind) for p in plans]
        vocab = self.interner.snapshot_size()
        return tuple({"kind_id": k, "vocab": vocab} for k in kind_ids)

    def _join_delta_tables(self, device=None) -> Optional[tuple]:
        """'tables'-mode join arguments from the host join index, on
        ``device`` (default the driver's): per plan its (uk, uc) tables
        and the kind id JoinCmp.exclude_self needs."""
        js = self._join_state
        if js is None or not js.built:
            return None
        out = []
        for p, tab in zip(self._active_join_plans(), js.delta_tables()):
            tab = state_from_numpy(tab, device or self.device)
            tab["kind_id"] = self.interner.intern(p.remote_kind)
            out.append(tab)
        return tuple(out)

    def _ensure_join_state(self):
        """Bring the host join-group index current with the audit pack
        (full-sweep path).  The rebuild DIFFS against the previous index
        and bumps the row generations of readers whose key group
        changed, so the render caches can never replay a message whose
        aggregate (a quota count, a duplicate set) moved underneath it."""
        plans = self._active_join_plans()
        ap = self._audit_pack
        if not plans:
            self._join_state = None
            return None
        from .joinkernel import JoinState

        js = self._join_state
        sig = tuple(p.sig for p in plans)
        if js is None or js.sig != sig or js.rebuild_gen != ap.rebuild_gen:
            # a pack rebuild reassigned row ids (and reset every row
            # generation with it), so a fresh index starts diff-free
            js = JoinState(plans, ap.rebuild_gen)
            self._join_state = js
        bump = js.rebuild(ap, self.interner)
        if bump:
            ap.bump_row_gen(bump)
        return js

    def _join_safe(self, kind: str) -> bool:
        """True when a referential template's rendered results are
        reusable across sweeps: every inventory read is a classified
        join plan (prog.exact survived compilation), so verdict and
        message depend only on (row content, key-group aggregate) — and
        the join index bumps reader row generations whenever a group
        changes."""
        cached = self._join_safe_cache
        if cached is None or cached[0] != self._cs_epoch:
            cached = (self._cs_epoch, {})
            self._join_safe_cache = cached
        hit = cached[1].get(kind)
        if hit is None:
            prog = self.programs.get(kind)
            hit = bool(
                prog is not None
                and getattr(prog, "join_plans", ())
                and prog.exact
                and kind in self.templates
            )
            cached[1][kind] = hit
        return hit

    def _join_strict(self, kind: str, constraint: dict) -> bool:
        """A flagged-but-renders-empty cell for this constraint is a
        genuine plan-vs-oracle divergence (not a legitimate match or
        mask over-approximation): exact join program, selector-free
        match (the packed match is exact without label selectors)."""
        prog = self.programs.get(kind)
        if prog is None or not getattr(prog, "join_plans", ()) \
                or not prog.exact:
            return False
        match = constraint_match_spec(constraint)
        return not match.get("labelSelector") and not match.get(
            "namespaceSelector"
        )

    def _note_join_false_positive(self, kind: str, name: str, ri: int):
        """A strict-eligible join cell whose interpreter render came back
        empty: raise it as a divergence under GK_JOIN_ASSERT, UNLESS the
        documented groupVersion-twin corner explains it (legitimate
        filter work)."""
        from . import joinkernel

        prog = self.programs.get(kind)
        js = self._join_state
        if (
            js is not None and prog is not None
            and joinkernel.gv_twin_corner(
                js, getattr(prog, "join_plans", ()), self._audit_pack, ri
            )
        ):
            return
        joinkernel.note_false_positive(kind, name, ri)

    def _join_render_inventory(self, kind: str, rows) -> Optional[object]:
        """ONE grouped inventory for rendering this kind's flagged join
        cells: the interpreter re-runs the Rego body per flagged cell,
        and its ``data.inventory`` iteration walks the FULL provider
        collection — O(R) per cell.  For a join-safe kind the verdict and
        message depend only on the provider rows in the flagged readers'
        key groups, so one pass builds a pruned tree holding exactly
        those rows and every flagged cell renders byte-identically
        against it.

        Returns the frozen pruned tree, or None when equivalence cannot
        be proven (no current join index, unknown plan, provider row
        outside the pack) — the caller then falls back to the full
        inventory.  A pruning defect surfaces as a flagged-but-renders-
        empty cell, which GK_JOIN_ASSERT=1 turns into a failure."""
        js = self._join_state
        prog = self.programs.get(kind)
        if js is None or not js.built or prog is None:
            return None
        plans = getattr(prog, "join_plans", ()) or ()
        if not plans:
            return None
        reviews = self._audit_pack.reviews
        by_sig = {p.sig: i for i, p in enumerate(js.plans)}
        provider_rows: set = set()
        for plan in plans:
            i = by_sig.get(plan.sig)
            if i is None:
                return None  # index predates this plan set: rebase path
            row_rkeys = js.row_rkeys[i]
            providers = js.providers[i]
            keys: set = set()
            for r in rows:
                keys.update(row_rkeys.get(int(r), ()))
            for k in keys:
                provider_rows |= providers.get(k, set())
        tree: Dict[str, dict] = {}
        for ri in sorted(provider_rows):
            if ri >= len(reviews):
                return None  # index/pack drift: never render against it
            rev = reviews[ri]
            if rev is None:
                continue  # tombstoned provider: contributes nothing
            obj = rev.get("object")
            if not isinstance(obj, dict) and not hasattr(obj, "get"):
                return None
            meta = obj.get("metadata") or {}
            api = obj.get("apiVersion") or ""
            okind = obj.get("kind") or ""
            name = meta.get("name") or ""
            # placement mirrors target.py inventory_segments: the
            # OBJECT's namespace decides cluster- vs namespace-scope
            ns = meta.get("namespace") or ""
            if ns:
                node = (
                    tree.setdefault("namespace", {})
                    .setdefault(ns, {})
                    .setdefault(api, {})
                    .setdefault(okind, {})
                )
            else:
                node = (
                    tree.setdefault("cluster", {})
                    .setdefault(api, {})
                    .setdefault(okind, {})
                )
            node[name] = obj
        from ..engine.value import freeze

        return freeze(tree)

    def _lazy_join_inventory(self, kind: str, rows, full_inventory):
        """Thunk form of _join_render_inventory, memoized on first call:
        the grouped-tree build runs only when a cell actually MISSES the
        render memo.  Falls back to the full inventory when pruning
        cannot be proven equivalent."""
        box: list = []

        def get():
            if not box:
                pruned = self._join_render_inventory(kind, rows)
                box.append(full_inventory if pruned is None else pruned)
            return box[0]

        return get

    def join_plan_shapes(self) -> List[dict]:
        """Join-plan summary: groups, provider and reader rows per plan
        once the index is built, else the plans alone."""
        js = self._join_state
        if js is not None and js.built:
            return js.shapes()
        return [
            {
                "agg": p.agg, "kind": p.remote_kind,
                "scope": p.remote_scope, "slot_key": p.local_slot,
                "groups": None, "provider_rows": None, "reader_rows": None,
            }
            for p in self._active_join_plans()
        ]

    # ---- render (exactness filter) ---------------------------------------

    def _render_plan_for(self, kind: str, name: str, constraint: dict):
        """The constraint's bound render plan (ops/renderplan.py), or None
        when the template is plan-ineligible; cached per epoch."""
        if self._bound_plans_epoch != self._cs_epoch:
            self._bound_plans.clear()
            self._bound_plans_epoch = self._cs_epoch
        key = (kind, name)
        got = self._bound_plans.get(key, _PLAN_MISS)
        if got is not _PLAN_MISS:
            return got
        plan = None
        tmpl = self.templates.get(kind)
        prog = self.programs.get(kind)
        if tmpl is not None and prog is not None:
            from . import renderplan

            try:
                plan = renderplan.bind(prog, tmpl.policy, constraint)
            except Exception:  # a plan bug must degrade, never fail a cell
                log.exception("render-plan bind failed for %s/%s", kind, name)
                plan = None
        self._bound_plans[key] = plan
        return plan

    def _render_plan_tiers(self) -> Dict[str, str]:
        """Per-constraint render-plan classification ("kind/name" ->
        tier), shared by the snapshot writer (persists it in the sweep
        basis) and loader (validates the rebuilt classification against
        it).  Caller holds the lock.  As TpuDriver's, over this driver's
        _render_plan_for and its per-epoch _bound_plans cache."""
        out: Dict[str, str] = {}
        for kind, name, constraint in self._ordered_constraints():
            try:
                plan = self._render_plan_for(kind, name, constraint)
            except Exception:
                plan = None
            out[f"{kind}/{name}"] = (
                plan.tier if plan is not None else "interp"
            )
        return out

    def _eval_cell(self, constraint: dict, kind: str, review: dict,
                   frozen_review, inventory, rowview=None,
                   allow_plan: bool = True) -> list:
        """Exact evaluation of one (constraint, review) cell: native match
        re-check + violation rendering — through the compiled render plan
        when this constraint has one, else the interpreter.  Returns the
        violation dicts ([] when the device mask over-approximated).
        allow_plan=False is for render-pool workers: they touch no shared
        state."""
        from ..engine.value import freeze

        tmpl = self.templates.get(kind)
        if tmpl is None:
            return []
        if not constraint_matches(constraint, review, self.store.cached_namespace):
            return []  # device over-approximation filtered here
        if allow_plan:
            plan = self._render_plan_for(
                kind, _constraint_name(constraint), constraint
            )
            if plan is not None:
                if rowview is None:
                    from .renderplan import RowView

                    rowview = RowView(review, frozen_review)
                return plan.apply(rowview)
        params = constraint_parameters(constraint)
        if frozen_review is None:
            frozen_review = (
                rowview.frozen() if rowview is not None else freeze(review)
            )
        return tmpl.policy.eval_violations(
            frozen_review, freeze(params), inventory
        )

    def _append_violation_results(self, results, violations, constraint,
                                  kind, review, tracing_log=None):
        """The one violation-dict -> Result shaping, shared by every
        render path."""
        if not violations:
            return
        action = self._enforcement_action(constraint)
        for v in violations:
            results.append(
                Result(
                    msg=str(v.get("msg", "")),
                    metadata={"details": v.get("details", {})},
                    constraint=constraint,
                    review=review,
                    enforcement_action=action,
                )
            )
            if tracing_log is not None:
                tracing_log.append(
                    f"violation {kind}/{constraint['metadata']['name']}: "
                    f"{v.get('msg')}"
                )

    def _inventory_for_render(self):
        """The frozen inventory handed to render paths, or an empty
        FrozenDict when no installed template reads data.inventory (the
        render can then never touch it); cached per epoch."""
        cached = self._uses_inventory_cache
        if cached is not None and cached[0] == self._cs_epoch:
            uses = cached[1]
        else:
            uses = any(
                getattr(t.policy, "uses_inventory", True)
                for t in self.templates.values()
            )
            self._uses_inventory_cache = (self._cs_epoch, uses)
        if uses:
            return self.store.frozen()
        from ..engine.value import freeze

        return freeze({})

    # ---- admission reviews ------------------------------------------------

    def review(self, review: dict, tracing: bool = False):
        return self.review_batch([review], tracing=tracing)[0]

    def review_batch(self, reviews: List[dict], tracing: bool = False):
        """N admission reviews in one device evaluation: the mask is
        [C, N], then each review's positive cells render on the host.
        Traced reviews take the interpreter walk, which emits the trace."""
        if not reviews:
            return []
        if tracing:
            return [InterpDriver.review(self, r, tracing=True)
                    for r in reviews]
        with self._lock:
            ordered, mask, autoreject = self.compute_masks(reviews)
            return self._render_masked(
                reviews, ordered, mask, autoreject,
                self._inventory_for_render(),
            )

    def _render_masked(self, reviews, ordered, mask_np, rej_np, inventory):
        """Sparse render of the (review, constraint) cells the mask marked
        positive, review-major so each review's results keep the dense
        loop's order; reviews with no positive cell cost no host work.
        Plan cells render inline, the interpreter tail through the
        bounded render pool; Results are assembled in cell order
        (autoreject entries first per cell).  Caller holds the lock."""
        from .renderplan import RenderPool, RowView

        out: List = [([], None) for _ in reviews]
        ris, iis = np.nonzero((mask_np | rej_np).T)
        cells = list(zip(ris.tolist(), iis.tolist()))
        if not cells:
            return out
        mflags = mask_np[iis, ris].tolist()
        rflags = rej_np[iis, ris].tolist()
        cached_ns = self.store.cached_namespace
        rows: Dict[int, RowView] = {}
        resolved: Dict[int, list] = {}
        deferred: List[Tuple[int, int, int]] = []
        for idx, (ri, i) in enumerate(cells):
            if not mflags[idx]:
                continue  # autoreject-only cell: handled at assembly
            kind, name, constraint = ordered[i]
            review = reviews[ri]
            row = rows.get(ri)
            if row is None:
                row = rows[ri] = RowView(review)
            plan = self._render_plan_for(kind, name, constraint)
            if plan is None:
                deferred.append((idx, ri, i))
                continue
            # the mask cell already includes the packed match; the native
            # re-check is only needed where packing can over-approximate it
            if plan.match_exact or constraint_matches(
                constraint, review, cached_ns
            ):
                resolved[idx] = plan.apply(row)
            else:
                resolved[idx] = []
        if deferred:
            thunks = [
                (lambda c=ordered[i][2], k=ordered[i][0], r=reviews[ri],
                        f=rows[ri].frozen():
                 self._eval_cell(c, k, r, f, inventory, allow_plan=False))
                for _idx, ri, i in deferred
            ]
            evaled = RenderPool.map_ordered(thunks)
            for (idx, _ri, _i), violations in zip(deferred, evaled):
                resolved[idx] = violations
        for idx, (ri, i) in enumerate(cells):
            kind, _name, constraint = ordered[i]
            review = reviews[ri]
            results = out[ri][0]
            if rflags[idx] and needs_autoreject(constraint, review, cached_ns):
                results.append(
                    Result(
                        msg="Namespace is not cached in OPA.",
                        metadata={"details": {}},
                        constraint=constraint,
                        review=review,
                        enforcement_action=self._enforcement_action(
                            constraint
                        ),
                    )
                )
            self._append_violation_results(
                results, resolved.get(idx), constraint, kind, review
            )
        return out

    # ---- audit ------------------------------------------------------------

    def _audit_topk(self, cap: int) -> int:
        k = self.AUDIT_TOPK_MIN
        while k < 2 * cap:
            k *= 2
        return min(k, 4096)

    def _synced_side(self):
        """Bring the resident audit pack current with the store -> the
        constraint side aligned with it (re-packed if the pack's rows
        interned new strings: its predicate tables are vocab-sized)."""
        side = self._constraint_side()
        self._audit_pack.sync(self, side[3])
        return self._constraint_side()

    def _audit_device_inputs(self):
        """The resident audit pack on the device -> ((rv, cols), upload
        stats).  A full upload only when the pack's layout changed
        (rebuild, growth, a new leaf); otherwise the rows dirtied since
        the last full sweep are patched in place by one row scatter (K6),
        so the bytes moved follow the churn, not the inventory."""
        ap = self._audit_pack
        dirty = ap.take_dirty()
        if dirty:
            # the dirty set is consumed here: the mesh's slabs can no
            # longer patch themselves and are committed anew on next use
            self._audit_dev_mesh = None
        cache = self._audit_dev
        if cache is None or cache[0] != ap.layout_gen:
            tree = (ap.rp, ap.cols)
            placed = state_from_numpy(tree, self.device)
            self._audit_dev = (ap.layout_gen, placed)
            return placed, {"upload_bytes": float(tree_nbytes(tree)),
                            "scatter_rows": 0.0, "scatter_ms": 0.0}
        placed = cache[1]
        if not dirty:
            return placed, {"upload_bytes": 0.0, "scatter_rows": 0.0,
                            "scatter_ms": 0.0}
        t0 = time.perf_counter()
        rows = np.fromiter(sorted(dirty), np.int64, len(dirty))
        host_rows = take_rows((ap.rp, ap.cols), rows)
        scatter_rows(placed, rows, host_rows)
        return placed, {
            "upload_bytes": float(tree_nbytes(host_rows)),
            "scatter_rows": float(len(rows)),
            "scatter_ms": (time.perf_counter() - t0) * 1e3,
        }

    def _audit_device_inputs_mesh(self, mesh):
        """The resident audit pack in row slabs on the mesh -> ([(rv,
        cols)] one a shard, upload stats).  The padded slabs are committed
        once per pack layout (pipelined_shard_commit); later the rows
        dirtied since the last full sweep are patched by K6 on their
        owning shards only, at slab-local rows, and every other slab sees
        no traffic."""
        ap = self._audit_pack
        dirty = ap.take_dirty()
        if dirty:
            self._audit_dev = None  # consumed here: the twin re-uploads
        cache = self._audit_dev_mesh
        if cache is None or cache[0] != ap.layout_gen or cache[1] is not mesh:
            shards, _target = shard_review_side(
                mesh, ap.capacity, ap.rp, ap.cols
            )
            # the mesh object rides in the cache: identity is liveness
            self._audit_dev_mesh = (ap.layout_gen, mesh, shards)
            return shards, {
                "upload_bytes": float(tree_nbytes((ap.rp, ap.cols))),
                "scatter_rows": 0.0, "scatter_ms": 0.0,
            }
        shards = cache[2]
        if not dirty:
            return shards, {"upload_bytes": 0.0, "scatter_rows": 0.0,
                            "scatter_ms": 0.0}
        t0 = time.perf_counter()
        rows = np.fromiter(sorted(dirty), np.int64, len(dirty))
        _target, slab = slab_rows(ap.capacity, mesh.devices.size)
        owner = rows // slab
        nbytes = 0
        for shard in np.unique(owner):
            mine = rows[owner == shard]
            host_rows = take_rows((ap.rp, ap.cols), mine)
            scatter_rows(shards[shard], mine - shard * slab, host_rows)
            nbytes += tree_nbytes(host_rows)
        return shards, {
            "upload_bytes": float(nbytes),
            "scatter_rows": float(len(rows)),
            "scatter_ms": (time.perf_counter() - t0) * 1e3,
            "scatter_shards": float(len(np.unique(owner))),
        }

    def _mesh_join_tables(self, mesh, shards, jargs) -> list:
        """Each join plan's key table of the whole row axis, from the
        shards' slabs: K7 on every shard, K7's merge on the first shard's
        device (joinkernel.provider_key_table under a mesh), then placed
        with the merge's dense counts, which K8 reads, once on each
        distinct device -> one 'tables'-mode ``joins`` tuple a shard."""
        from .joinkernel import provider_key_table

        per_shard: List[list] = [[] for _ in shards]
        rvs = [rv for rv, _cols in shards]
        colss = [cols for _rv, cols in shards]
        for plan, arg in zip(self._active_join_plans(), jargs):
            uk, uc, dense = provider_key_table(
                plan, arg["kind_id"], rvs, colss, torch, axis_name="data",
                vocab=arg["vocab"],
            )
            placed = replicate_tree(mesh,
                                    {"uk": uk, "uc": uc, "dense": dense})
            for mine, tab in zip(per_shard, placed):
                mine.append({**tab, "kind_id": arg["kind_id"]})
        return [tuple(mine) for mine in per_shard]

    def _sweep_shards(self, side, mesh, shards, K: int, jargs=None,
                      first: int = 0):
        """Every shard's full-sweep evaluation and capped reduction ->
        (packed [n, C_total, 1+K'] int32 on the host, the shards' masks).
        Shard i of this mesh holds global row slab ``first + i`` (a
        process of a multi-process sweep holds its own): its K4 writes
        global rows, slab * (first + i) + column, and K' = min(K, slab).
        Every shard's launches are queued before any result is read."""
        slab = int(shards[0][0]["valid"].shape[0])
        joins = ([None] * len(shards) if jargs is None
                 else self._mesh_join_tables(mesh, shards, jargs))
        masks, reds = [], []
        for i, ((rv, cols), dev, jt) in enumerate(
                zip(shards, mesh.devices, joins)):
            placed = self._constraint_device(side, dev)
            mask, _autoreject = self._eval(side, rv, cols, placed,
                                           join_mode="tables", joins=jt)
            masks.append(mask)
            reds.append(packed_reduction(mask, K, (first + i) * slab))
        packed = np.stack([r.cpu().numpy() for r in reds])
        return packed, masks

    def _audit_sweep(self, K: int, reuse_any_k: bool = False):
        """One full device sweep over the resident audit pack ->
        (reviews, ordered, mask_src MaskSource of the resident [C, R']
        mask, counts [C] int64, topk [C, K] int32 -1 padded), or None when
        the inventory is empty.  Cached on (store epoch, constraint epoch,
        K): the device runs only when the inventory or the constraint side
        changed.  reuse_any_k accepts a cached sweep of any K (the
        uncapped path only needs the mask).  Rebases the incremental
        state."""
        key = (self.store.epoch, self._cs_epoch, K)
        if self._audit_cache is not None:
            ckey = self._audit_cache[0]
            if ckey == key or (reuse_any_k and ckey[:2] == key[:2]):
                self.last_sweep_stats = {
                    "pack_ms": 0.0, "device_ms": 0.0, "cached": 1.0,
                }
                return self._audit_cache[1]
        t0 = time.perf_counter()
        side = self._synced_side()
        ap = self._audit_pack
        if ap.n_rows == 0:
            return None
        ordered, _cp, _groups, _specs, crow = side
        # referential policies: bring the host join-group index current
        # (diff-bumps reader row generations for changed key groups) and
        # take the 'trace'-mode arguments: the resident mask, which the
        # delta fold reads its before-columns from, must hold the exact
        # join verdicts, never the review mode's defaults
        self._ensure_join_state()
        jargs = self._join_trace_args()
        mesh = self._mesh()
        if mesh is None:
            placed = self._constraint_device(side)
            (rv_d, cols_d), upload = self._audit_device_inputs()
            _synchronize([self.device])
            t1 = time.perf_counter()
            mask, _autoreject = self._eval(side, rv_d, cols_d, placed,
                                           join_mode="trace", joins=jargs)
            # crow folds the group-major pad rows out: all host-side
            # state is per ordered constraint
            packed = packed_reduction(mask, K).cpu().numpy()[crow]
        else:
            shards, upload = self._audit_device_inputs_mesh(mesh)
            for dev in mesh.distinct():
                self._constraint_device(side, dev)
            _synchronize(mesh.distinct())
            t1 = time.perf_counter()
            packed_all, masks = self._guarded_mesh_dispatch(
                mesh, lambda: self._sweep_shards(side, mesh, shards, K,
                                                 jargs))
            # the width one device gives, min(K, capacity): the merged
            # result equals the single-device reduction bit for bit
            packed = _merge_sharded_packed(
                packed_all, min(K, ap.capacity))[crow]
            mask = ShardedMask(masks, rows=ap.capacity)
        t2 = time.perf_counter()
        counts = packed[:, 0].astype(np.int64)
        # resolved, never lazy: K6 patches the inputs in place, so a mask
        # computed later from them would see rows of a later store
        mask_src = MaskSource.resolved(mask)
        sweep = (ap.reviews, ordered, mask_src, counts, packed[:, 1:])
        self._audit_cache = (key, sweep, None)
        # the mesh_width stamp pins the basis to the sharding that made
        # it: _try_delta refuses a basis of another width
        self._delta_state = DeltaState(
            counts, packed[:, 1:], K, mask_src, cs_epoch=self._cs_epoch,
            layout_gen=ap.layout_gen, store_epoch=self.store.epoch,
            crow=crow, mesh_width=self.mesh_layout(),
        )
        # the full sweep's inputs already hold every pending change; drop
        # the delta channel so those rows aren't applied again
        ap.delta_dirty.clear()
        self.last_sweep_stats = {
            "pack_ms": (t1 - t0) * 1e3,
            "device_ms": (t2 - t1) * 1e3,
            "fetch_bytes": float(packed.nbytes),
            "rows": float(ap.n_rows),
            "padded_rows": float(mask.shape[1]),
            "mask_rows": float(mask.shape[0]),
            "cells": float(len(ordered) * ap.n_rows),
            "shards": float(self.mesh_layout()),
            "rows_per_shard": float(
                slab_rows(ap.capacity, self.mesh_layout())[1]),
            **upload,
        }
        if jargs is not None:
            self.last_sweep_stats["join_plans"] = float(len(jargs))
        return sweep

    def _try_delta(self, K: int):
        """Bring the incremental sweep state current with an O(dirty-rows)
        device evaluation.  Returns (reviews, ordered, state) or None when
        the delta path is ineligible (disabled, no base state, layout
        changed, no current join index, or too many dirty rows with the
        readers of the key groups they touch — then the caller runs a
        full sweep)."""
        if not self.delta_enabled:
            return None
        st = self._delta_state
        if st is None or st.cs_epoch != self._cs_epoch:
            return None
        if st.mesh_width != self.mesh_layout():
            # a basis from another sharding (mesh_enabled or the mesh
            # cache poked directly, not through set_mesh): its mask lies
            # in the old topology's slabs, so rebase via a full sweep; the
            # sweep cache rides the same topology and goes too
            self._delta_state = None
            self._audit_cache = None
            return None
        t0 = time.perf_counter()
        side = self._synced_side()
        ap = self._audit_pack
        ordered = side[0]
        if st.layout_gen != ap.layout_gen or ap.n_rows == 0:
            return None
        if len(st.row_cols) > self.DELTA_ROW_COLS_MAX:
            return None  # too much cumulative churn: rebase via full sweep
        if not ap.delta_dirty:
            st.store_epoch = self.store.epoch
            self.last_sweep_stats = {
                "pack_ms": (time.perf_counter() - t0) * 1e3,
                "device_ms": 0.0, "cached": 1.0,
            }
            return ap.reviews, ordered, st
        if len(ap.delta_dirty) > self.DELTA_MAX_ROWS:
            return None
        # referential policies: the delta dispatch must also re-evaluate
        # the READERS of every key group the churn touched (a churn row
        # invalidates only its key group — never the cluster).  Without a
        # current join index the aggregate cannot be maintained
        # incrementally, so rebase via a full sweep.
        js = None
        plans = self._active_join_plans()
        if plans:
            js = self._join_state
            if (
                js is None or not js.built
                or js.sig != tuple(p.sig for p in plans)
                or js.rebuild_gen != ap.rebuild_gen
            ):
                return None
            affected = js.affected(ap, self.interner, ap.delta_dirty)
            if len(ap.delta_dirty) + len(affected) > self.DELTA_MAX_ROWS:
                return None
        # drained only once eligibility is certain; a failure past this
        # point drops the state and the caller runs a full sweep, which
        # rebases it (and the join index) and clears both dirty channels
        rows = sorted(ap.take_delta_dirty())
        join_rows = 0
        if js is not None:
            # commit the churn to the join index: updates provider/reader
            # maps, bumps affected readers' row generations (stale render
            # reuse), and returns the key-group rows to co-dispatch
            extra = js.commit(ap, self.interner, rows)
            if extra:
                join_rows = len(extra)
                rows = sorted(set(rows) | extra)
        try:
            return self._apply_delta(st, ap, rows, side, t0, join_rows)
        except Exception:
            log.exception(
                "delta sweep failed for %d rows; rebasing via a full sweep",
                len(rows),
            )
            self._delta_state = None
            return None

    def _delta_eval(self, side, placed, mask, rows_pad, rv_slice,
                    cols_slice, joins=None, device=None) -> torch.Tensor:
        """The dirty rows' before-columns from the resident mask and their
        fresh evaluation -> int8 [C_total, 2w] (w =
        len(rows_pad)), the match kernel and the programs run on the
        w-row slice of the pack on ``device`` (default the driver's);
        ``joins`` the host join index's tables there ('tables' mode), or
        None without join plans.  On one device K9 writes both halves in
        its launch (program_eval's ``delta``).  Under a mesh (``mask`` a
        ShardedMask) K5 gathers each row's before-column on its owning
        shard, at its slab-local column, and the result is assembled on
        the host."""
        device = device or self.device
        rv_d = state_from_numpy(rv_slice, device)
        cols_d = state_from_numpy(cols_slice, device)
        w = len(rows_pad)
        if not isinstance(mask, ShardedMask):
            out = torch.empty((mask.shape[0], 2 * w), dtype=torch.int8,
                              device=device)
            self._eval(side, rv_d, cols_d, placed, join_mode="tables",
                       joins=joins, delta=(
                           mask, delta_index(rows_pad, mask.shape[1], device),
                           out))
            return out
        new, _autoreject = self._eval(side, rv_d, cols_d, placed,
                                      join_mode="tables", joins=joins)
        owner = rows_pad // mask.slab
        parts = []
        for shard in np.unique(owner):
            cols = np.nonzero(owner == shard)[0]
            slab = mask.slabs[shard]
            mine = new.index_select(
                1, torch.as_tensor(cols, device=new.device)).to(slab.device)
            parts.append((cols, delta_columns(
                slab, rows_pad[cols] - shard * mask.slab, mine)))
        both = np.empty((new.shape[0], 2 * w), np.int8)
        for cols, part in parts:
            part = part.cpu().numpy()
            both[:, cols] = part[:, :len(cols)]
            both[:, w + cols] = part[:, len(cols):]
        return torch.from_numpy(both)

    def _apply_delta(self, st, ap, rows, side, t0, join_rows: int = 0):
        t1 = time.perf_counter()
        # the slice is padded to a power of two >= 8 by repeating the last
        # row, as TpuDriver does: its [C, 2w] columns compare bit for bit
        width = 8
        while width < len(rows):
            width *= 2
        rows_pad = np.asarray(
            rows + [rows[-1]] * (width - len(rows)), np.int32
        )
        rv_slice, cols_slice = take_rows((ap.rp, ap.cols), rows_pad)
        # under a mesh the [C, w] evaluation runs on its first device
        mesh = self._mesh()
        device = self.device if mesh is None else mesh.devices[0]
        placed = self._constraint_device(side, device)
        # post-commit join tables: the dispatch evaluates the churned rows
        # AND the affected key-group readers against the UPDATED global
        # aggregate
        jt = self._join_delta_tables(device)

        def dispatch():
            return self._delta_eval(
                side, placed, st.mask_src.get(), rows_pad, rv_slice,
                cols_slice, jt, device,
            )

        both = dispatch() if mesh is None else \
            self._guarded_mesh_dispatch(mesh, dispatch)
        both = both.cpu().numpy().astype(bool)[st.crow]
        base_old, dmask = both[:, :width], both[:, width:]
        t2 = time.perf_counter()
        for j, r in enumerate(rows):
            # rows dirtied since the base sweep carry their current column
            # in the state; the device gather serves the rest
            old = st.old_column(r)
            if old is None:
                old = base_old[:, j]
            st.apply_row(r, old, dmask[:, j])
        st.store_epoch = self.store.epoch
        self.last_sweep_stats = {
            "pack_ms": (t1 - t0) * 1e3,
            "device_ms": (t2 - t1) * 1e3,
            "fetch_bytes": float(both.nbytes),
            "delta_rows": float(len(rows)),
            "rows": float(ap.n_rows),
            "cells": float(len(side[0]) * len(rows)),
            "shards": float(self.mesh_layout()),
        }
        if mesh is not None:
            # churn locality: the owning shards are the only ones K5 ran on
            # and the only slabs the next full sweep's K6 patches
            self.last_sweep_stats["delta_shards"] = float(len(
                owning_shards(rows, ap.capacity, mesh.devices.size)))
        if jt is not None:
            # key-group locality: how many of the dispatched rows were
            # affected readers rather than content churn
            self.last_sweep_stats["join_affected_rows"] = float(join_rows)
        return ap.reviews, side[0], st

    def _audit_masks(self):
        """The host candidate mask [C, capacity] for the uncapped audit,
        in ordered-constraint rows -> (reviews, ordered, mask), or empty
        lists and None for an empty inventory.

        Incremental like the capped path: the base mask is fetched once
        per full sweep, and later audits overwrite only the columns of the
        rows the delta sweep re-evaluated (absolute values, so patching
        again is idempotent)."""
        got = self._try_delta(self.AUDIT_TOPK_MIN)
        if got is not None:
            reviews, ordered, st = got
            if st.host_mask is None:
                st.host_mask = _host_rows(
                    st.mask_src.get(), st.crow, self._audit_pack.capacity
                )
                st.pending_mask_rows = set(st.row_cols)
            for r in st.pending_mask_rows:
                st.host_mask[:, r] = st.row_cols[r][: st.host_mask.shape[0]]
            st.pending_mask_rows = set()
            return reviews, ordered, st.host_mask
        sweep = self._audit_sweep(self.AUDIT_TOPK_MIN, reuse_any_k=True)
        if sweep is None:
            return [], [], None
        reviews, ordered, mask_src, _counts, _topk = sweep
        key, cached_sweep, host = self._audit_cache
        if host is None:
            st0 = self._delta_state
            crow0 = st0.crow if st0 is not None and st0.mask_src is mask_src \
                else self._constraint_side()[4]
            host = _host_rows(
                mask_src.get(), crow0, self._audit_pack.capacity
            )
            self._audit_cache = (key, cached_sweep, host)
        # a full sweep just rebased the incremental state: seed its host
        # mask from this fetch so the next delta-path audit does not fetch
        # the same [C, R] mask again
        st = self._delta_state
        if st is not None and st.host_mask is None \
                and st.mask_src is mask_src:
            st.host_mask = host.copy()
            st.pending_mask_rows = set(st.row_cols)
        return reviews, ordered, host

    def audit(self, tracing: bool = False):
        with self._lock:
            reviews, ordered, mask = self._audit_masks()
            if not reviews:
                return [], ("" if tracing else None)
            t2 = time.perf_counter()
            inventory = self._inventory_for_render()
            results: List[Result] = []
            trace: List[str] = [] if tracing else None
            from .renderplan import RowView

            # grouped join renders: per join-safe kind, ONE pruned
            # inventory over the union of its flagged rows — the
            # interpreter's per-cell O(R) inventory walk becomes
            # O(group); built on the kind's first cell
            kind_cis: Dict[str, list] = {}
            for i, (k, _n, _c) in enumerate(ordered):
                kind_cis.setdefault(k, []).append(i)
            join_inv: Dict[str, object] = {}

            def _inv_for(kind):
                got = join_inv.get(kind)
                if got is None:
                    got = inventory
                    if self._join_safe(kind):
                        rows = np.nonzero(
                            mask[kind_cis[kind]].any(axis=0)
                        )[0]
                        pruned = self._join_render_inventory(kind, rows)
                        if pruned is not None:
                            got = pruned
                    join_inv[kind] = got
                return got

            # resource-major order, matching InterpDriver.audit; only
            # reviews with a positive cell pay any render cost
            for ri in np.nonzero(mask.any(axis=0))[0]:
                review = reviews[ri] if ri < len(reviews) else None
                if review is None:  # tombstoned row (valid=False anyway)
                    continue
                rowview = RowView(review)
                for i in np.nonzero(mask[:, ri])[0]:
                    kind, name, constraint = ordered[i]
                    violations = self._eval_cell(
                        constraint, kind, review, None, _inv_for(kind),
                        rowview=rowview,
                    )
                    if not violations and self._join_strict(
                        kind, constraint
                    ):
                        self._note_join_false_positive(kind, name, int(ri))
                    self._append_violation_results(
                        results, violations, constraint, kind, review, trace,
                    )
            self.last_sweep_stats["render_ms"] = (
                time.perf_counter() - t2
            ) * 1e3
            return results, ("\n".join(trace) if tracing else None)

    def audit_capped(self, cap: int, tracing: bool = False):
        """Cap-aware audit: at most `cap` violations kept per constraint
        (--constraint-violations-limit).

        Steady state is incremental: only rows whose packed content
        changed since the last sweep are re-evaluated on the device (the
        [C, 2w] delta), and the per-constraint counts and first-K
        candidate lists are kept on the host (ops/deltasweep.py).  The
        first sweep, and any after a constraint-side or layout change or
        with too much churn, is a full device sweep whose reduction (K4)
        ships only [C] counts and [C, K] candidate rows to the host.  When
        the render needs candidates past the known horizon it fetches
        that constraint's mask row (base state fresh) or falls back to one
        full sweep (NeedsFullSweep).

        Returns (results, totals, trace) with totals {(kind, name):
        (count, how)}: "exact" when the count equals the reference's
        totalViolations — every candidate rendered, or the cap was hit but
        the program is provably count-exact (_count_exact); "resources"
        when the cap cut rendering short and the count is device-candidate
        resources, an over-approximation."""
        if cap is None or cap <= 0:
            return InterpDriver.audit_capped(self, cap or 0, tracing=tracing)
        with self._lock:
            K = self._audit_topk(cap)
            trace: List[str] = [] if tracing else None
            for _attempt in (0, 1):
                got = self._try_delta(K)
                if got is None:
                    sweep = self._audit_sweep(K)
                    if sweep is None:
                        # every registered constraint reports an exact
                        # zero on an empty inventory, as InterpDriver does
                        empty = {
                            (kind, cname): (0, "exact")
                            for kind in self.constraints
                            for cname in self.constraints[kind]
                        }
                        return [], empty, (
                            "\n".join(trace) if tracing else None
                        )
                    got = (self._audit_pack.reviews, sweep[1],
                           self._delta_state)
                try:
                    return self._render_capped(
                        got[0], got[1], got[2], cap, trace
                    )
                except NeedsFullSweep:
                    # the state's known candidates ran out while unknown
                    # ones exist and the base mask is stale: rebase
                    self._delta_state = None
                    self._audit_cache = None
            raise AssertionError("fresh full sweep cannot need another")

    def _evict_render_memo(self):
        from itertools import islice

        drop = max(1, self.RENDER_MEMO_MAX // 16)
        for k in list(islice(iter(self._render_memo), drop)):
            del self._render_memo[k]

    def _memo_cell(self, kind, name, ri, constraint, review, rowviews,
                   inventory, uses_inv, row_gen) -> list:
        """Violations for one cell, memoized across sweeps: an unchanged
        (constraint side, packed row) pair renders identically unless the
        template reads data.inventory (a join-safe template counts as not
        reading it: the join index bumps its readers' row generations).
        ``inventory`` may be a thunk (_lazy_join_inventory)."""
        mkey = (kind, name, ri)
        if not uses_inv:
            hit = self._render_memo.get(mkey)
            if hit is not None and hit[0] == row_gen:
                return hit[1]
        if callable(inventory):
            # lazy grouped join inventory (_lazy_join_inventory):
            # resolved only on this miss path, never on a memo hit
            inventory = inventory()
        row = rowviews.get(ri)
        if row is None:
            from .renderplan import RowView

            row = rowviews[ri] = RowView(review)
        violations = self._eval_cell(
            constraint, kind, review, None, inventory, rowview=row
        )
        if not uses_inv:
            if len(self._render_memo) >= self.RENDER_MEMO_MAX:
                self._evict_render_memo()
            self._render_memo[mkey] = (row_gen, violations)
        return violations

    def _count_exact(self, kind: str, constraint: dict) -> bool:
        """True when the device-counted violating resources provably equal
        the reference's totalViolations for this constraint: the program is
        exact with a single non-iterating clause (a violating resource
        yields exactly one violation), has no join plan, and the match spec
        uses no label selectors (the packed match can only
        over-approximate through non-string labels, ops/pack.py)."""
        prog = self.programs.get(kind)
        if prog is None or not prog.exact:
            return False
        if getattr(prog, "join_plans", ()):
            return False
        if len(prog.clauses) != 1 or prog.clauses[0].slot_iter is not None:
            return False
        match = constraint_match_spec(constraint)
        return not match.get("labelSelector") and not match.get(
            "namespaceSelector"
        )

    def _render_capped(self, reviews, ordered, st, cap, trace):
        """Render up to `cap` violations per constraint from the
        incremental state's candidate lists (the same for a state fresh
        from a full sweep and one a delta updated).

        Per-constraint result reuse: a constraint whose walked candidates
        and their row generations are unchanged since the last sweep
        renders the identical Result slice; with 1-object churn nearly
        every constraint reuses wholesale and the render is O(changed)."""
        t0 = time.perf_counter()
        ap = self._audit_pack
        if self._render_memo_epoch != self._cs_epoch:
            self._render_memo.clear()
            self._render_memo_epoch = self._cs_epoch
        reuse = st.render_cache if trace is None else {}
        new_cache: Dict[Tuple, Tuple] = {}
        inventory = self._inventory_for_render()
        rowviews: Dict[int, object] = {}
        results: List[Result] = []
        totals: Dict[Tuple[str, str], Tuple[int, str]] = {}
        R = len(reviews)
        rendered_cells = 0
        fallback_rows = 0

        def candidates(ci, n_cand):
            """Known candidate rows ascending; beyond the horizon, fetch
            the constraint's mask row while the base mask is fresh (no
            delta applied), else escalate to a full sweep."""
            nonlocal fallback_rows
            lst = st.cand[ci]
            yield from lst
            if st.horizon[ci] is None or n_cand <= len(lst):
                return
            if st.row_cols:
                raise NeedsFullSweep(ci)
            row = _host_row(st.mask_src.get(), int(st.crow[ci]))[:R]
            fallback_rows += 1
            full = [int(x) for x in np.nonzero(row)[0]]
            st.cand[ci] = full  # complete knowledge for later sweeps
            st.horizon[ci] = None
            yield from full[len(lst):]

        def join_complete(ci):
            # complete candidate knowledge: the union below must cover
            # the constraint's readers, and candidates() never extends
            # st.cand past this exact condition
            return (st.horizon[ci] is None
                    or int(st.counts[ci]) <= len(st.cand[ci]))

        # ONE pruned join inventory per kind, shared by its constraints:
        # a provider SUPERSET is equivalence-safe, so the union of the
        # kind's candidate rows serves every constraint of it
        join_union: Dict[str, set] = {}
        for ci, (kind, _name, _c) in enumerate(ordered):
            if (int(st.counts[ci]) == 0 or not self._join_safe(kind)
                    or not join_complete(ci)):
                continue
            tmpl = self.templates.get(kind)
            if tmpl is None or getattr(tmpl.policy, "uses_inventory",
                                       True):
                join_union.setdefault(kind, set()).update(st.cand[ci])
        join_inv_by_kind: Dict[str, object] = {}

        for ci, (kind, name, constraint) in enumerate(ordered):
            ckey = (kind, name)
            n_cand = int(st.counts[ci])
            if n_cand == 0:
                totals[ckey] = (0, "exact")
                continue
            tmpl = self.templates.get(kind)
            uses_inv = (
                True if tmpl is None
                else getattr(tmpl.policy, "uses_inventory", True)
            )
            join_strict = False
            cell_inv = inventory
            if uses_inv and self._join_safe(kind):
                # every inventory read is a classified join plan: the
                # join index bumps reader row generations when a key
                # group changes, so rendered results are content-keyed
                # like inventory-free templates — O(churn) rendering
                uses_inv = False
                join_strict = self._join_strict(kind, constraint)
                if join_complete(ci):
                    # every flagged cell renders against ONE pruned
                    # inventory holding the kind's key groups' provider
                    # rows, built on the first render miss; the
                    # horizon-fetch fallback keeps the full tree
                    cell_inv = join_inv_by_kind.get(kind)
                    if cell_inv is None:
                        cell_inv = self._lazy_join_inventory(
                            kind, sorted(join_union.get(kind, ())),
                            inventory,
                        )
                        join_inv_by_kind[kind] = cell_inv
            lst = st.cand[ci]
            sig = None
            if trace is None and not uses_inv and len(lst) <= 512:
                # unchanged candidates and row generations (and the same
                # cap) render identically; the cap keys the entry
                sig = (
                    cap, n_cand, tuple(lst),
                    tuple(ap.row_gen[r] for r in lst if r < R),
                )
                hit = reuse.get(ckey)
                if hit is not None and hit[0] == sig:
                    results.extend(hit[1])
                    totals[ckey] = hit[2]
                    new_cache[ckey] = hit
                    continue
            action = self._enforcement_action(constraint)
            start = len(results)
            capped = False
            for ri in candidates(ci, n_cand):
                if len(results) - start >= cap:
                    capped = True
                    break
                if ri >= R or reviews[ri] is None:
                    continue  # tombstoned row (valid=False on device too)
                violations = self._memo_cell(
                    kind, name, ri, constraint, reviews[ri], rowviews,
                    cell_inv, uses_inv, ap.row_gen[ri],
                )
                if join_strict and not violations:
                    # an exact join plan flagged this cell but the oracle
                    # renders nothing: raises under GK_JOIN_ASSERT=1
                    # unless the documented gv-twin corner explains it
                    self._note_join_false_positive(kind, name, int(ri))
                rendered_cells += 1
                for v in violations:
                    results.append(
                        Result(
                            msg=str(v.get("msg", "")),
                            metadata={"details": v.get("details", {})},
                            constraint=constraint,
                            review=reviews[ri],
                            enforcement_action=action,
                        )
                    )
                    if trace is not None:
                        trace.append(
                            f"violation {kind}/{name}: {v.get('msg')}"
                        )
            if not capped:
                totals[ckey] = (len(results) - start, "exact")
            elif self._count_exact(kind, constraint):
                # device count == violation count, provably: report the
                # full total past the cap (manager.go:188 semantics)
                totals[ckey] = (n_cand, "exact")
            else:
                totals[ckey] = (
                    max(n_cand, len(results) - start), "resources"
                )
            if sig is not None:
                new_cache[ckey] = (sig, tuple(results[start:]), totals[ckey])
        if trace is None:
            st.render_cache = new_cache
        self.last_sweep_stats.update(
            render_ms=(time.perf_counter() - t0) * 1e3,
            rendered_cells=float(rendered_cells),
            fallback_rows=float(fallback_rows),
            results=float(len(results)),
        )
        return results, totals, ("\n".join(trace) if trace is not None else None)


def _host_rows(mask, crow, capacity: int) -> np.ndarray:
    """The device mask's rows ``crow`` on the host, as a writable array
    that shares no memory with ``mask`` (a tensor, or a mesh sweep's
    ShardedMask)."""
    if isinstance(mask, ShardedMask):
        return mask.host_rows(crow)[:, :capacity]
    crow_t = torch.as_tensor(crow, device=mask.device)
    return mask.index_select(0, crow_t).cpu().numpy()[:, :capacity]


def _host_row(mask, c: int) -> np.ndarray:
    """Row ``c`` of the device mask on the host."""
    if isinstance(mask, ShardedMask):
        return mask.host_row(c)
    return mask[c].cpu().numpy()


def _synchronize(devices):
    """Wait for the work queued on each CUDA device of ``devices``."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _merge_sharded_packed(packed_all: np.ndarray, K: int) -> np.ndarray:
    """[N shards, C, 1+K'] per-shard capped reductions -> global
    [C, 1+K].  Counts sum; candidate indices are already global rows
    (-1 padded) and each shard's list is ascending within its contiguous
    row slab, so shard-major concatenation preserves global ascending
    order — the merge keeps the first K valid entries per constraint.
    K' = min(K, rows per shard) may be smaller than K (each shard then
    contributes its COMPLETE row slab, so the merge is still exact);
    the output is padded back to width K.  Copied from
    gatekeeper_tpu/ops/driver.py."""
    counts = packed_all[:, :, 0].sum(axis=0, dtype=np.int32)
    cand = np.transpose(packed_all[:, :, 1:], (1, 0, 2))
    cand = cand.reshape(cand.shape[0], -1)  # [C, N*K'], shard-major
    if cand.shape[1] < K:
        cand = np.pad(cand, ((0, 0), (0, K - cand.shape[1])),
                      constant_values=-1)
    order = np.argsort(cand == -1, axis=1, kind="stable")[:, :K]
    merged = np.take_along_axis(cand, order, axis=1)
    return np.concatenate([counts[:, None], merged], axis=1)
