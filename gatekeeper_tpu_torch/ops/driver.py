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
and its serving seam: the whole-request and review memos (a repeated
admission replays without a launch), the circuit breaker (ops/breaker.py)
and three priced tiers for an admission batch, as TpuDriver prices them:
the device, the numpy host tier (ops/npside.py: the same mask in numpy,
ops/npeval.py, on an incrementally kept host constraint side, then the
same render) and the interpreter's walk of the constraints the review's
kind can match (_gvk_walk_list).  Each tier has an affine service model
(calibrate_routing; static priors DEVICE_MIN_CELLS and NP_MIN_CELLS
before it; DEVICE_MIN_CELLS = 0 forces the device, GK_NP_SERVE=0 drops
the numpy tier), priced for latency, for the offered load
(set_offered_load) or for throughput under the brownout pin
(set_brownout_pin), and each batch's route is recorded in the route
ledger (obs/routeledger.py) under the tier that served it.  A priced
host tier serves only where the device is the host's own
(price_host_tiers, true on the CPU): on the card the tensors live there,
so a batch priced for the host is served by the device all the same,
reason ``device_resident``, its priced table beside it.  The
interpreter serves traced reviews.  A batch the breaker holds off the
device (reason ``breaker_open``) or the device did not take
(``device_failed``, logged at warning) is served by the numpy tier, else
the interpreter.  Only an unavailable device diverts: the fault plane's
TPU_DISPATCH point (DeviceUnavailable) or a stalled mesh dispatch
(MeshDispatchStall); a kernel's launch failure or a CUDA error reaches
the caller, and the kernel wrappers and compute_masks catch nothing.
Left out: the compile cache (nothing here compiles per template).

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
shard's packed mask unpacked to its own slab.  A stalled dispatch
narrows the mesh and trips the breaker.  Left out: the mesh's metrics and
flight-recorder events.
"""

from __future__ import annotations

import copy
import logging
import marshal
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import deadline as _deadline
from .. import faults
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
from ..metrics.catalog import (
    DISPATCH_M,
    PACK_M,
    record_audit_shard,
    record_cache,
    record_join_affected,
    record_mesh_stall,
    record_mesh_width,
    record_render_cells,
    record_stage,
    set_join_plans,
)
from ..obs import costs as obscosts
from ..obs import trace as obstrace
from ..target.match import constraint_matches, needs_autoreject
from ..target.target import K8sValidationTarget
from .auditpack import AuditPackCache
from .columns import extract_columns
from .delta import delta_columns, delta_index
from .deltasweep import DeltaState, MaskSource, NeedsFullSweep
from .interning import Interner, PredicateTable
from .matchkernel import constraint_records, match_kernel
from .npside import NpSide
from .pack import _bucket as _bucket_pow2, pack_constraints, pack_reviews
from .packbits import packed_empty, unpack_review_masks
from .params import pack_params
from .reduction import packed_reduction
from .scatter import scatter_rows
from .vectorizer import vectorize
from .program import bind_group, lookup_joins, program_eval
from .renderplan import strip_request_meta
from .progcode import encode
from .vexpr import EvalEnv, VProgram

log = logging.getLogger("gatekeeper_tpu_torch.driver")

# _bound_plans miss sentinel (None is a valid cached "no plan")
_PLAN_MISS = object()


class DeviceUnavailable(RuntimeError):
    """The device took no dispatch: the fault plane's TPU_DISPATCH point
    fired.  With MeshDispatchStall, the only failures the serving methods
    hand to the breaker and divert; a kernel's launch failure or a CUDA
    error reaches the caller."""


# what review_batch, audit and audit_capped divert to the interpreter
_DIVERTED = (DeviceUnavailable, MeshDispatchStall)


def _fire_dispatch(**ctx):
    """The fault plane's TPU_DISPATCH point: what it injects is raised as
    DeviceUnavailable."""
    try:
        faults.fire(faults.TPU_DISPATCH, **ctx)
    except Exception as e:
        raise DeviceUnavailable(f"{type(e).__name__}: {e}") from e


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


def _memo_entry(r) -> tuple:
    """One result as the request memo keeps it: (msg, details, action).
    The memos keep their values as marshal's bytes, one object the
    collector never tracks: an entry of tuples and lists kept three
    tracked objects a result, each scanned by every collection after."""
    return (r.msg, (r.metadata or {}).get("details", {}),
            r.enforcement_action)


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

    # the memos' bounds: whole-request entries (one per unique object
    # content) and review-memo cells (each retains a frozen admission
    # object); at the bound a memo is cleared wholesale
    REQUEST_MEMO_MAX = 8192
    REVIEW_MEMO_MAX = 16_384
    # batches up to this size are admission traffic: they probe and feed
    # the whole-request memo; larger (streaming) chunks skip both
    REQUEST_MEMO_BATCH_MAX = 64
    # constraint-side change log entries kept for the request memo's
    # repair (past it, the older half is dropped)
    CS_LOG_MAX = 4096
    # a load hint older than this is stale; a priced tier must sustain
    # the offered load with this much headroom; tier capacity is priced
    # at the largest batch the micro-batcher coalesces
    LOAD_HINT_TTL_S = 5.0
    LOAD_HEADROOM = 1.25
    ROUTE_MAX_BATCH = 256.0
    # the routing priors before calibrate_routing: batches of this many
    # constraint x review cells and more go to the device; below it, from
    # NP_MIN_CELLS cells the numpy host tier (its serve has a floor of
    # pack and gather), below that the interpreter's walk.
    # DEVICE_MIN_CELLS = 0 forces the device whatever the calibration says
    DEVICE_MIN_CELLS = int(os.environ.get("GK_DEVICE_MIN_CELLS", "4096"))
    NP_MIN_CELLS = int(os.environ.get("GK_NP_MIN_CELLS", "24"))

    def __init__(self, target: Optional[K8sValidationTarget] = None,
                 device=None, mesh_watchdog_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None):
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
        # per-template constraint counts for the cost ledger's dispatch
        # apportioning (obs/costs.py), cached per constraint-side epoch:
        # attribution never walks every kind per admission batch
        self._cost_kinds_cache: Optional[Tuple[int, Dict[str, int]]] = None
        # per-pass render-tier counters, flushed to
        # render_cells_total{plan=...} once a render pass, so the hot
        # loop pays a dict increment, not a registry record, per cell
        self._tier_counts = {"static": 0, "slots": 0, "interp": 0}
        # the last masked render pass's cells and stage times
        self.last_render_stats: Dict[str, float] = {}
        # per-sweep stage times and counts (read by chip_smoke.py)
        self.last_sweep_stats: Dict[str, float] = {}
        # running totals of constraint-side re-packs and uploads, and the
        # host time they took (read by chip_smoke.py around each review)
        self.side_stats: Dict[str, float] = {
            "repacks": 0, "pack_ms": 0.0, "uploads": 0, "upload_ms": 0.0,
        }
        # the review-path render memo, keyed by content (kind, constraint
        # name, frozen review without its uid), valid for one
        # constraint-side epoch, its values a cell's violations; and the
        # whole-request memo: content -> (epoch, the flat replay list of
        # (kind, name, (msg, details, action)) sorted by (kind, name)),
        # whose entries of older epochs are repaired through the
        # constraint-side change log (only the constraints that changed
        # re-evaluate).  Both keep their values as marshal's bytes
        # (_memo_entry)
        self._review_memo: Dict[Tuple, bytes] = {}
        self._review_memo_epoch = -1
        self._request_memo: Dict[object, tuple] = {}
        # (kind, name) of constraints whose cells are not content-
        # determined, maintained by the mutators (_memoable_update)
        self._memoable_false: set = set()
        self._cs_change_log: List[Tuple[int, str, Optional[str]]] = []
        self._cs_log_floor = 0  # entries with epoch > floor are complete
        self._n_constraints_cache: Optional[Tuple[int, int]] = None
        # the device's measured service model (calibrate_routing), the
        # micro-batcher's offered-load hint (reviews/s, monotonic stamp)
        # and the brownout pin (obs/brownout.py level 3)
        self._route_cal: Optional[Dict[str, float]] = None
        self._offered_load: Optional[tuple] = None
        self._brownout_pin = False
        # the numpy host tier: its constraint side, kept in step with the
        # driver's through _cs_change_log (ops/npside.py); GK_NP_SERVE=0
        # leaves the device and the interpreter
        self.np_serve_enabled = os.environ.get("GK_NP_SERVE", "1") != "0"
        self._np_side = NpSide()
        # whether a batch priced for a host tier is served there: on the
        # CPU, where the "device" is the host too; on the card the host
        # tiers serve only the breaker's and an unavailable device's
        # diverts (and traced reviews), so admission launches the kernels
        self.price_host_tiers = self.device.type != "cuda"
        # the interpreter's walk list index: (epoch, {(group, kind):
        # entries}, namespaceSelector entries)
        self._gvk_cache = None
        # every batch's route and the reason that decided it
        # (/debug/routez, route_decisions_total); GK_ROUTE_LEDGER=0 stops
        # the recording
        from ..obs.routeledger import RouteLedger, set_active

        self.route_ledger = RouteLedger().attach(self)
        self.route_ledger.enabled = (
            os.environ.get("GK_ROUTE_LEDGER", "1") != "0"
        )
        set_active(self.route_ledger)
        # circuit breaker over the device path: after N consecutive
        # failures the serving methods divert to the host tiers (reviews:
        # the numpy tier, else the interpreter; audits: the interpreter),
        # which render the same results (the device mask only ever prunes
        # the interpreter's walk); a background probe runs one real review
        # on the device and one success closes it (ops/breaker.py)
        from .breaker import CircuitBreaker

        if breaker_threshold is None:
            breaker_threshold = int(
                os.environ.get("GK_BREAKER_THRESHOLD", "3"))
        if breaker_cooldown_s is None:
            breaker_cooldown_s = float(
                os.environ.get("GK_BREAKER_COOLDOWN_S", "5.0"))
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
            probe_fn=self._breaker_probe,
            on_transition=self._on_breaker_transition,
        )

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

    # ---- circuit breaker ---------------------------------------------------

    # the review the recovery probe evaluates: the real device path,
    # whatever templates are installed
    _PROBE_REVIEW = {
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": "gk-breaker-probe", "namespace": "default",
        "operation": "CREATE",
        "object": {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "gk-breaker-probe",
                         "namespace": "default", "labels": {}},
            "spec": {"containers": [{"name": "c", "image": "probe.io/x:1"}]},
        },
    }

    def _breaker_probe(self):
        """One real review through compute_masks (half-open recovery), on
        the card, through the seams production traffic takes (any
        installed fault-plane schedule included), so the breaker closes
        exactly when the device answers again."""
        with self._lock:
            if any(self.constraints.values()):
                self.compute_masks([copy.deepcopy(self._PROBE_REVIEW)])
                return
        # nothing to evaluate: the dispatch seam and the kernels' load are
        # the probe, outside the lock (the load may run nvcc)
        if faults.ENABLED:
            _fire_dispatch()
        self.wait_ready()

    def _on_breaker_transition(self, old: str, new: str):
        # also invoked with old == new by the probe loop as a periodic
        # metrics refresh while degraded: record always, log on change
        if old != new:
            log.warning(
                "circuit breaker %s -> %s%s", old, new,
                " (serving from the host tiers)" if new != "closed" else "",
            )
            # the flight recorder: the edge lands in the incident ring, and
            # an open edge dumps the ring.  Guarded: this runs inside the
            # device-failure handling, where a recorder defect must never
            # fail a request
            try:
                from ..obs import flightrec

                flightrec.record(
                    flightrec.BREAKER_TRANSITION, old=old, new=new,
                    trips=self.breaker.trips,
                )
                if new == "open":
                    flightrec.dump("breaker_open")
            except Exception:
                log.debug("flight-recorder feed failed on breaker edge",
                          exc_info=True)
        try:
            from ..metrics.catalog import record_breaker

            record_breaker(self.breaker.status())
        except Exception:
            log.debug("breaker state metric recording failed",
                      exc_info=True)

    def breaker_status(self) -> dict:
        """Health-endpoint view of the degradation ladder."""
        return self.breaker.status()

    def _record_device_failure(self, e: BaseException):
        """Feed one device-path failure to the breaker.  A
        MeshDispatchStall trips it at once: a wedged dispatch wedges the
        next ones too.  The stall site has already narrowed the mesh
        (_guarded_mesh_dispatch), so the rebasing full sweep runs at the
        new width once the probe closes the breaker."""
        self.breaker.record_failure(e)
        if isinstance(e, MeshDispatchStall):
            self.breaker.trip()

    # ---- the request memo's bookkeeping ------------------------------------

    def _log_cs_change(self, kind: str, name: Optional[str]):
        """(epoch after the change, kind, name or None for the whole
        kind): the request memo repairs an entry by re-evaluating only
        the constraints changed since it was stored."""
        self._cs_change_log.append((self._cs_epoch, kind, name))
        if len(self._cs_change_log) > self.CS_LOG_MAX:
            drop = len(self._cs_change_log) // 2
            self._cs_log_floor = self._cs_change_log[drop - 1][0]
            del self._cs_change_log[:drop]

    def _memoable_update(self, kind: str, name: Optional[str]):
        """Maintain the set of constraints whose cells are not
        content-determined, so _request_memoable is O(1) (caller holds
        the lock)."""
        tmpl = self.templates.get(kind)
        names = (
            [name] if name is not None
            else list(self.constraints.get(kind, {}))
        )
        for n in names:
            c = self.constraints.get(kind, {}).get(n)
            key = (kind, n)
            if c is not None and not self._cell_memoable(tmpl, c):
                self._memoable_false.add(key)
            else:
                self._memoable_false.discard(key)

    def put_template(self, kind: str, artifact: CompiledTemplate):
        with self._lock:
            super().put_template(kind, artifact)
            self.programs[kind] = vectorize(artifact.policy)
            self._cs_epoch += 1
            self._memoable_update(kind, None)
            self._log_cs_change(kind, None)

    def delete_template(self, kind: str) -> bool:
        with self._lock:
            self.programs.pop(kind, None)
            out = super().delete_template(kind)
            self._cs_epoch += 1
            # the base delete cascades the kind's constraints away
            self._memoable_false = {
                key for key in self._memoable_false if key[0] != kind
            }
            self._log_cs_change(kind, None)
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
                # must still invalidate.  The memos follow the same rule:
                # no epoch, no change-log entry, so a status write
                # flushes no memoized review
                return
            super().put_constraint(kind, name, constraint)
            self._cs_epoch += 1
            self._memoable_update(kind, name)
            self._log_cs_change(kind, name)

    def delete_constraint(self, kind: str, name: str) -> bool:
        with self._lock:
            out = super().delete_constraint(kind, name)
            self._cs_epoch += 1
            self._memoable_update(kind, name)
            self._log_cs_change(kind, name)
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
            # wholesale wipe: the change log cannot describe a reset
            self._request_memo.clear()
            self._review_memo.clear()
            self._memoable_false.clear()
            self._cs_change_log.clear()
            self._cs_log_floor = self._cs_epoch

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
        # outside the driver lock (the gauge is advisory); mesh_layout()
        # resolves the new topology
        record_mesh_width(self.mesh_layout() if enabled else 1)

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
                if faults.ENABLED:
                    faults.fire(faults.MESH_DISPATCH_STALL)
                return thunk()

        def _stall(where: str) -> MeshDispatchStall:
            DISPATCH_LOCK.revoke()
            record_mesh_stall()
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
                if faults.ENABLED:
                    faults.fire(faults.MESH_DISPATCH_STALL)
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
        try:  # guarded: the degrade proceeds even without a recorder
            from ..obs import flightrec

            flightrec.record(
                flightrec.MESH_DEGRADE, from_width=width, to_width=new,
            )
        except Exception:
            log.debug("flight-recorder feed failed on mesh degrade",
                      exc_info=True)
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
        (sharded_masks).

        The pack (host) and the dispatch (upload, K1, K9, the packed
        download, the unpack) are recorded as the stage spans and
        histograms TpuDriver records; the download is the dispatch's
        synchronisation point."""
        t0 = time.perf_counter()
        mesh = self._mesh()
        review_pack = self._review_pack(reviews)
        side, rv, cols, rows = review_pack
        t1 = time.perf_counter()
        if faults.ENABLED:
            _fire_dispatch()
        if mesh is not None:
            ordered, mask_np, rej_np = sharded_masks(
                self, reviews, mesh, review_pack=review_pack)
        else:
            ordered, cp, _groups, _specs, crow = side
            placed = self._constraint_device(side)
            rv_d = state_from_numpy(rv, self.device)
            cols_d = state_from_numpy(cols, self.device)
            out = packed_empty(cp.arrays["valid"].shape[0], rows,
                               self.device)
            self._eval(side, rv_d, cols_d, placed, pack_out=out)
            packed = out.cpu().numpy()
            mask_np, rej_np = unpack_review_masks([packed], rows, crow, rows)
        t2 = time.perf_counter()
        # spans mirror into every request trace this batch serves; the
        # histograms record the same intervals.  tier "torch" is the
        # device path's name (--driver torch)
        obstrace.record_span("tpu.pack", t0, t1, stage=obstrace.PACK,
                             reviews=len(reviews))
        obstrace.record_span("tpu.dispatch", t1, t2,
                             stage=obstrace.DISPATCH, tier="torch",
                             breaker=self.breaker.state, rows=rows)
        record_stage(PACK_M, t1 - t0, {"path": "review"})
        record_stage(DISPATCH_M, t2 - t1, {"path": "review",
                                           "tier": "torch"})
        if obscosts.enabled():
            obscosts.record_dispatch(
                self._cost_kind_counts(), t2 - t1, len(reviews),
                path="review",
            )
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
            if self._join_state is not None:
                # the last referential template left: retract the gauge,
                # so /metrics never shows join plans no template has
                self._join_state = None
                set_join_plans(0)
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
        set_join_plans(len(plans))
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

    def _cost_kind_counts(self) -> Dict[str, int]:
        """{template kind: live constraint count} for the cost ledger's
        dispatch apportioning, cached per constraint-side epoch."""
        cached = self._cost_kinds_cache
        if cached is not None and cached[0] == self._cs_epoch:
            return cached[1]
        counts = {k: len(v) for k, v in self.constraints.items() if v}
        self._cost_kinds_cache = (self._cs_epoch, counts)
        return counts

    def _flush_render_counts(self):
        """Export the pass's per-tier cell counts to
        render_cells_total{plan=...} (one registry record per tier per
        pass, not per cell)."""
        counts = self._tier_counts
        if counts["static"] or counts["slots"] or counts["interp"]:
            record_render_cells(counts)
            self._tier_counts = {"static": 0, "slots": 0, "interp": 0}

    def _eval_cell(self, constraint: dict, kind: str, review: dict,
                   frozen_review, inventory, rowview=None,
                   allow_plan: bool = True, count: bool = True) -> list:
        """Exact evaluation of one (constraint, review) cell: native match
        re-check + violation rendering — through the compiled render plan
        when this constraint has one, else the interpreter.  Returns the
        violation dicts ([] when the device mask over-approximated).
        allow_plan=False and count=False are for render-pool workers: they
        touch no shared state (the pass counts their cells)."""
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
                if count:
                    self._tier_counts[plan.tier] += 1
                return plan.apply(rowview)
        if count:
            self._tier_counts["interp"] += 1
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
        This is the micro-batching seam the webhook server drives.

        A batch of up to REQUEST_MEMO_BATCH_MAX reviews first probes the
        whole-request memo: the hits replay (no launch, no render) and
        the misses evaluate as one sub-batch.  Traced reviews take the
        interpreter walk, which emits the trace."""
        if not reviews:
            return []
        if tracing or len(reviews) > self.REQUEST_MEMO_BATCH_MAX:
            return self._review_batch_eval(reviews, tracing)
        # the probe's frozen memo keys ride along, so the miss path never
        # freezes the same review twice
        t0 = time.perf_counter()
        probed = [self._request_memo_hit(r) for r in reviews]
        served: List = [p[0] for p in probed]
        misses = [i for i, s in enumerate(served) if s is None]
        obstrace.record_span(
            "memo.lookup", t0, time.perf_counter(),
            stage=obstrace.CACHE_LOOKUP,
            hits=len(reviews) - len(misses), misses=len(misses),
        )
        record_cache("request_memo", True, len(reviews) - len(misses))
        record_cache("request_memo", False, len(misses))
        if misses:
            evaled = self._review_batch_eval(
                [reviews[i] for i in misses], tracing,
                memo_reviews=[probed[i][1] for i in misses],
            )
            for j, i in enumerate(misses):
                served[i] = evaled[j]
        return [s if isinstance(s, tuple) else (s, None) for s in served]

    def _review_batch_eval(self, reviews: List[dict], tracing: bool,
                           memo_reviews: Optional[list] = None):
        """Price and evaluate a batch (no memo probe: review_batch served
        the hits) on the tier _route_decision chose: the device, the
        numpy host tier or the interpreter; a host tier only with
        price_host_tiers, else the device (reason device_resident).  A
        batch for the device goes to the numpy tier, else the
        interpreter, while the breaker is open or when the device was
        unavailable (DeviceUnavailable, MeshDispatchStall); any other
        failure of the device path raises.  Every batch lands in the
        route ledger with the tier that served it."""
        n_constraints = self._n_constraints_total()
        cells = len(reviews) * max(n_constraints, 1)
        route, reason, lam, priced = self._route_decision(
            cells, n_reviews=len(reviews),
            want_priced=self.route_ledger.enabled,
        )

        def _record(tier):
            self.route_ledger.record(
                tier, reason, cells, len(reviews), lam, priced
            )

        if tracing:
            _record("interp")  # traced reviews take the interpreter walk
            return [InterpDriver.review(self, r, tracing=True)
                    for r in reviews]
        if route != "device":
            if self.price_host_tiers:
                return self._host_serve(route, reviews, memo_reviews,
                                        _record)
            reason = "device_resident"
        if not self.breaker.allow():
            # checked only here, right before the device attempt, so a
            # granted half-open trial is always followed by the attempt
            # that records its outcome
            reason = "breaker_open"
            log.warning("circuit breaker open: serving %d review(s) from "
                        "the host tiers", len(reviews))
            return self._host_serve("np", reviews, memo_reviews, _record)
        _record("device")
        with self._lock:
            try:
                ordered, mask, autoreject = self.compute_masks(reviews)
            except _DIVERTED as e:
                # the failure feeds the breaker and this batch is served by
                # the host tiers, outside the lock (per-review locking)
                self._record_device_failure(e)
                log.warning(
                    "device evaluation failed (%s: %s); serving %d "
                    "review(s) from the host tiers",
                    type(e).__name__, e, len(reviews),
                )
            else:
                self.breaker.record_success()
                # admission-sized batches read and feed the review memo
                # and the request memo, so a repeat replays next time;
                # streaming chunks skip both (review_batch evaluates
                # them directly)
                admission = len(reviews) <= self.REQUEST_MEMO_BATCH_MAX
                with obstrace.span("render", stage=obstrace.RENDER,
                                   tier="torch"):
                    out = self._render_masked(
                        reviews, ordered, mask, autoreject,
                        self._inventory_for_render(),
                        memo_keys=memo_reviews, memo=admission,
                    )
                if admission and self._memoable_synced():
                    self._store_request_memos(reviews, out, memo_reviews)
                return out
        # the amended entry names the tier that evaluated: device ->
        # device_failed (-> breaker_open) in causal order.  No entry when
        # the deadline check raises: nothing was served
        reason = "device_failed"
        if _deadline.expired():
            raise _deadline.DeadlineExceeded(
                "deadline exhausted during device-failure fallback"
            )
        return self._host_serve("np", reviews, memo_reviews, _record)

    def _host_serve(self, tier: str, reviews: List[dict],
                    memo_reviews: Optional[list], record):
        """Serve a batch on the host: the numpy tier where ``tier`` is
        "np" and it can serve (it is enabled and holds constraints), else
        the interpreter; ``record`` lands the ledger entry of the tier
        that served."""
        if tier == "np":
            out = self._np_review(reviews, memo_reviews)
            if out is not None:
                record("np")
                return out
        record("interp")
        return self._interp_serve(reviews, memo_reviews)

    def _store_request_memos(self, reviews: List[dict], out: list,
                             memo_reviews: Optional[list]):
        """Store each review's results of an evaluated admission batch in
        the request memo (caller holds the lock and checked
        _memoable_synced)."""
        for ri, review in enumerate(reviews):
            mk = memo_reviews[ri] if memo_reviews else None
            self._store_request_memo(review, out[ri][0],
                                     mk[1] if mk else None)

    def _np_review(self, reviews: List[dict],
                   memo_reviews: Optional[list] = None, memo: bool = True):
        """Serve a batch from the numpy host tier (ops/npside.py): the
        device path's over-approximating mask, computed in numpy on the
        incrementally kept host constraint side, then the same render;
        no upload, no launch.  -> the results, or None when the tier is
        disabled or holds no constraint (the caller falls back).  With
        ``memo`` False (the calibration) no memo is read or fed."""
        if not self.np_serve_enabled:
            return None
        with self._lock:
            t0 = time.perf_counter()
            ns = self._np_side
            ns.sync(self)
            t1 = time.perf_counter()
            got = ns.serve(self, reviews)
            if got is None:
                return None
            t2 = time.perf_counter()
            obstrace.record_span("np.pack", t0, t1, stage=obstrace.PACK)
            obstrace.record_span(
                "np.eval", t1, t2, stage=obstrace.DISPATCH,
                tier="numpy", breaker=self.breaker.state,
            )
            record_stage(PACK_M, t1 - t0, {"path": "review"})
            record_stage(DISPATCH_M, t2 - t1, {"path": "review",
                                               "tier": "numpy"})
            if obscosts.enabled():
                obscosts.record_dispatch(
                    self._cost_kind_counts(), t2 - t1, len(reviews),
                    path="review",
                )
            ordered, mask, rej = got
            admission = memo and len(reviews) <= self.REQUEST_MEMO_BATCH_MAX
            with obstrace.span("render", stage=obstrace.RENDER,
                               tier="numpy"):
                out = self._render_masked(
                    reviews, ordered, mask, rej,
                    self._inventory_for_render(),
                    memo_keys=memo_reviews if memo else None,
                    memo=admission,
                )
            if admission and self._memoable_synced():
                self._store_request_memos(reviews, out, memo_reviews)
            return out

    def _interp_serve(self, reviews: List[dict],
                      memo_reviews: Optional[list] = None):
        """The interpreter serving a diverted batch, through the
        content-keyed memos, with the stage span whose tier and breaker
        state make the divert visible in the trace."""
        with obstrace.span("eval.interp", stage=obstrace.RENDER,
                           tier="interp", breaker=self.breaker.state):
            return [
                self._interp_review_memo(
                    r, memo_reviews[i] if memo_reviews else None
                )
                for i, r in enumerate(reviews)
            ]

    @staticmethod
    def _cell_memoable(tmpl, constraint: dict) -> bool:
        """A (constraint, object) verdict is content-determined iff the
        template's policy is memo-safe and inventory-free and the match
        spec carries no namespaceSelector (presence, not truthiness: an
        empty selector still consults the mutable namespace cache)."""
        if tmpl is None:
            return False
        if not getattr(tmpl.policy, "memo_safe", False):
            return False
        if getattr(tmpl.policy, "uses_inventory", True):
            return False
        match = constraint_match_spec(constraint)
        return "namespaceSelector" not in match

    def _cell_violations(self, constraint: dict, kind: str, review: dict,
                         frozen_review, inventory, memo_review=None,
                         rowview=None) -> list:
        """One cell's violations through the review memo when the cell is
        content-determined (_cell_memoable), keyed on the review without
        its uid; else evaluated."""
        tmpl = self.templates.get(kind)
        if not self._cell_memoable(tmpl, constraint):
            return self._eval_cell(constraint, kind, review, frozen_review,
                                   inventory, rowview)
        if self._review_memo_epoch != self._cs_epoch:
            self._review_memo.clear()
            self._review_memo_epoch = self._cs_epoch
        if memo_review is None:
            if frozen_review is None:
                frozen_review = rowview.frozen()
            memo_review = strip_request_meta(frozen_review)
        mkey = (kind, _constraint_name(constraint), memo_review)
        kept = self._review_memo.get(mkey)
        if kept is not None:
            return marshal.loads(kept)
        violations = self._eval_cell(constraint, kind, review,
                                     frozen_review, inventory, rowview)
        if len(self._review_memo) >= self.REVIEW_MEMO_MAX:
            self._review_memo.clear()
        self._review_memo[mkey] = marshal.dumps(violations)
        return violations

    def _walk_one(self, results: List[Result], kind: str,
                  constraint: dict, review: dict, frozen_review,
                  memo_review, inventory, cached_ns, rowview,
                  memo: bool = True):
        """One constraint of the interpreter's walk: its autoreject, then
        its violations (the match re-checked inside), through the review
        memo unless ``memo`` is False."""
        if needs_autoreject(constraint, review, cached_ns):
            results.append(
                Result(
                    msg="Namespace is not cached in OPA.",
                    metadata={"details": {}},
                    constraint=constraint,
                    review=review,
                    enforcement_action=self._enforcement_action(constraint),
                )
            )
        if memo:
            violations = self._cell_violations(
                constraint, kind, review, frozen_review, inventory,
                memo_review=memo_review, rowview=rowview)
        else:
            violations = self._eval_cell(constraint, kind, review,
                                         frozen_review, inventory, rowview)
        self._append_violation_results(results, violations, constraint,
                                       kind, review)

    def _gvk_walk_list(self, review: dict) -> List[Tuple[str, str, dict]]:
        """The sorted constraint subset an interpreter walk must visit for
        this review: constraints whose match.kinds could hit the review's
        (group, kind), exact pairs and wildcard buckets, and every
        constraint that carries a namespaceSelector (autoreject does not
        depend on the kind, target_template_source.go:12-25).  The index
        follows pack_constraints' kind pairs (an entry with empty
        apiGroups or kinds contributes none and never matches), and is
        kept per constraint-side epoch."""
        idx = self._gvk_cache
        if idx is None or idx[0] != self._cs_epoch:
            by_pair: Dict[Tuple[str, str], list] = {}
            nssel: list = []
            for entry in self._ordered_constraints():
                # a non-dict spec or match degrades to {} (as
                # target/match.py reads it): one malformed constraint
                # must not fail every walked review
                match = constraint_match_spec(entry[2])
                if "namespaceSelector" in match:
                    nssel.append(entry)
                kinds = match.get("kinds")
                if kinds is None:
                    # missing or an explicit null: the wildcard, as the
                    # oracle and pack.py read both
                    kinds = [{"apiGroups": ["*"], "kinds": ["*"]}]
                if isinstance(kinds, list):
                    for ks in kinds:
                        if not isinstance(ks, dict):
                            continue
                        for g in ks.get("apiGroups") or []:
                            for k in ks.get("kinds") or []:
                                by_pair.setdefault(
                                    (str(g), str(k)), []
                                ).append(entry)
            idx = (self._cs_epoch, by_pair, nssel)
            self._gvk_cache = idx
        _epoch, by_pair, nssel = idx
        rk = review.get("kind")
        g = rk.get("group") if isinstance(rk, dict) else None
        k = rk.get("kind") if isinstance(rk, dict) else None
        probes = [("*", "*")]
        if isinstance(k, str):
            probes.append(("*", k))
        if isinstance(g, str):
            probes.append((g, "*"))
            if isinstance(k, str):
                probes.append((g, k))
        out: Dict[Tuple[str, str], Tuple[str, str, dict]] = {}
        for p in probes:
            for entry in by_pair.get(p, ()):
                out[entry[:2]] = entry
        for entry in nssel:
            out[entry[:2]] = entry
        return [out[key] for key in sorted(out)]

    def _interp_review_memo(self, review: dict, memo_key=None,
                            memo: bool = True):
        """InterpDriver.review's results served through the content-keyed
        memos: cells seen before replay from the review memo, and a
        content-determined result is stored in the request memo (neither
        with ``memo`` False, the calibration's walk).  It walks the
        constraints the review's kind can match, and those with a
        namespaceSelector, in (kind, name) order (_gvk_walk_list): the
        results of InterpDriver's walk of them all."""
        from ..engine.value import freeze
        from .renderplan import RowView

        with self._lock:
            inventory = self._inventory_for_render()
            cached_ns = self.store.cached_namespace
            if memo_key is not None:
                frozen_review, memo_review = memo_key
            else:
                frozen_review = freeze(review)
                memo_review = strip_request_meta(frozen_review)
            # synced under this lock hold: the store below must never
            # keep a verdict of a constraint side before an epoch bump
            memoable = memo and self._memoable_synced()
            rowview = RowView(review, frozen_review)
            results: List[Result] = []
            for kind, _name, constraint in self._gvk_walk_list(review):
                self._walk_one(results, kind, constraint, review,
                               frozen_review, memo_review, inventory,
                               cached_ns, rowview, memo=memo)
            if memoable:
                self._store_request_memo(review, results, memo_review)
            self._flush_render_counts()
            return results, None

    def _memoable_synced(self) -> bool:
        """Whether a whole request's verdict depends only on its content:
        every installed template's policy is memo-safe and
        inventory-free, and no constraint carries a namespaceSelector.
        O(1): the mutators maintain _memoable_false.  Answered under the
        same lock hold as the evaluation whose results are stored."""
        return not self._memoable_false

    def _request_memo_hit(self, review: dict):
        """Serve a review wholly from the request memo, repairing a stale
        entry through the constraint-side change log -> (results, memo
        key) on a hit, (None, memo key) on a miss, (None, None) when the
        constraint side is not memoable.  The (frozen review, key) pair
        travels to the miss path, so the review is frozen once."""
        from ..engine.value import freeze

        with self._lock:
            if not self._memoable_synced():
                return None, None
            frozen_review = freeze(review)
            memo_review = strip_request_meta(frozen_review)
            memo_key = (frozen_review, memo_review)
            hit = self._request_memo.get(memo_review)
            if hit is None:
                return None, memo_key
            if hit[0] != self._cs_epoch:
                per_key: Dict[Tuple[str, str], list] = {}
                for kind, name, entry in marshal.loads(hit[1]):
                    per_key.setdefault((kind, name), []).append(entry)
                per_key = self._repair_memo_entry(
                    hit[0], per_key, review, frozen_review, memo_review,
                    self._inventory_for_render(),
                    self.store.cached_namespace,
                )
                if per_key is None:
                    return None, memo_key  # the log overran: evaluate
                # flattened once per repair, so each replay at this epoch
                # is O(violations)
                flat = marshal.dumps([
                    (kind, name, entry)
                    for kind in sorted(self.constraints)
                    for name in sorted(self.constraints[kind])
                    for entry in per_key.get((kind, name), ())
                ])
                hit = (self._cs_epoch, flat)
                self._request_memo[memo_review] = hit
            # rebuilt per hit down to the details (marshal's load makes
            # new objects): a consumer's mutation of a replayed result
            # must never reach a later replay
            out = [
                Result(
                    msg=msg,
                    metadata={"details": details},
                    constraint=self.constraints[kind][name],
                    review=review,
                    enforcement_action=action,
                )
                for kind, name, (msg, details, action)
                in marshal.loads(hit[1])
            ]
            return out, memo_key

    def _eval_one_key(self, kind, name, review, frozen_review, memo_review,
                      inventory, cached_ns, rowview=None):
        """One constraint's walk for the request memo's repair -> its
        memoized (msg, details, action) list, or None when the
        constraint no longer exists."""
        constraint = self.constraints.get(kind, {}).get(name)
        if constraint is None:
            return None
        out: List[Result] = []
        self._walk_one(out, kind, constraint, review, frozen_review,
                       memo_review, inventory, cached_ns, rowview)
        return [_memo_entry(r) for r in out]

    def _repair_memo_entry(self, entry_epoch, per_key, review,
                           frozen_review, memo_review, inventory,
                           cached_ns):
        """Bring a stale request-memo entry current by re-evaluating only
        the constraints the change log records after entry_epoch -> the
        repaired per-key dict, or None when the log no longer covers the
        entry."""
        if entry_epoch < self._cs_log_floor:
            return None
        from .renderplan import RowView

        rowview = RowView(review, frozen_review)
        changed_kinds = set()
        changed_keys = set()
        for ep, kind, name in reversed(self._cs_change_log):
            if ep <= entry_epoch:
                break
            if name is None:
                changed_kinds.add(kind)
            else:
                changed_keys.add((kind, name))
        per_key = dict(per_key)
        for kind in changed_kinds:
            for k in [k for k in per_key if k[0] == kind]:
                del per_key[k]
            for name in self.constraints.get(kind, {}):
                res = self._eval_one_key(
                    kind, name, review, frozen_review, memo_review,
                    inventory, cached_ns, rowview=rowview,
                )
                if res:
                    per_key[(kind, name)] = res
        for kind, name in changed_keys:
            if kind in changed_kinds:
                continue
            res = self._eval_one_key(
                kind, name, review, frozen_review, memo_review, inventory,
                cached_ns, rowview=rowview,
            )
            if res:
                per_key[(kind, name)] = res
            else:
                per_key.pop((kind, name), None)
        self._flush_render_counts()
        return per_key

    def _store_request_memo(self, review: dict, results: List[Result],
                            memo_review=None):
        """Store one review's exact results as a request-memo entry
        (caller holds the lock and checked _memoable_synced).  The flat
        replay list is sorted by (kind, name), so a replay orders as the
        path that stored or repaired it did."""
        from ..engine.value import freeze

        if len(self._request_memo) >= self.REQUEST_MEMO_MAX:
            self._request_memo.clear()
        if memo_review is None:
            memo_review = strip_request_meta(freeze(review))
        per_key: Dict[Tuple[str, str], list] = {}
        for r in results:
            key = (r.constraint.get("kind", ""),
                   (r.constraint.get("metadata") or {}).get("name", ""))
            per_key.setdefault(key, []).append(_memo_entry(r))
        flat = marshal.dumps([
            (kind, name, entry)
            for kind, name in sorted(per_key)
            for entry in per_key[(kind, name)]
        ])
        self._request_memo[memo_review] = (self._cs_epoch, flat)

    # ---- the device's service model ----------------------------------------

    def _calibration_reviews(self, n: int) -> List[dict]:
        """``n`` admission reviews of distinct objects for the
        calibration: the first ``n`` the cache holds (this cluster's
        content: its flagged share, which the render pays for, and its
        strings, which the audit pack has interned), else, in a cache
        smaller than that, pods no call has seen, as TpuDriver's
        calibration makes them.  A snapshot's restore leaves plain-dict
        leaves in the cache until something freezes them."""
        from ..engine.value import thaw

        out: List[dict] = []
        with self._lock:
            for obj, api, kind, name, ns in self.store.iter_objects():
                if len(out) == n:
                    break
                obj = copy.deepcopy(obj) if type(obj) is dict else thaw(obj)
                review = self.target.make_audit_review(
                    obj, api, kind, name, ns)
                review["operation"] = "CREATE"
                out.append(review)
        if len(out) == n:
            return out
        return [{
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": f"gk-route-cal-{i}", "namespace": "default",
            "operation": "CREATE",
            "object": {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"gk-route-cal-{i}",
                             "namespace": "default",
                             "labels": {"cal": str(i)}},
                "spec": {"containers": [
                    {"name": "c", "image": f"cal.io/x:{i}"}]},
            },
        } for i in range(n)]

    def calibrate_routing(self, runs: int = 3) -> Optional[dict]:
        """Measure once the affine service models of the three tiers an
        admission batch can take past the memos, each timed with the
        driver lock held and on distinct objects (_calibration_reviews:
        the cache's, else fresh pods), every one of them evaluated once
        before, untimed, in one warm-up call on the device: the timed
        calls price objects whose strings are interned, as the audit pack
        interns the cache's, not the constraint side's re-pack a new
        string costs once.
          - the device: compute_masks and the render of its positive
            cells at a one-review batch (the admission shape) and at 128,
            each the median of ``runs`` calls (a dispatch's run-to-run
            spread is cost every real request pays);
          - the numpy tier (when enabled): _np_review at batches of 1 and
            8, each the least of ``runs`` calls after one (which absorbs
            the host side's first sync): pure host work, whose spread is
            scheduler noise a real request mostly does not pay;
          - the interpreter: the median per-review time of its walk over
            unique reviews, after one warm walk (the median, not the
            least: a cold cache in the samples would price it at a rate
            real unique requests do not pay).
        No memo is read or fed.
        -> {"rtt_ms", "device_cells_per_ms", "interp_cells_per_ms",
        "np_floor_ms", "np_cells_per_ms"} (the np pair only with the
        numpy tier on), also kept as the model predicted_batch_ms and the
        route pricing read; None when no constraint is installed.  Called
        explicitly (the App calibrates in the background once it is
        ready), never implicitly."""
        with self._lock:
            n_constraints = sum(len(v) for v in self.constraints.values())
            if n_constraints == 0:
                return None
        b_large, b_np = 128, 8
        np_on = self.np_serve_enabled
        interp_runs = max(runs, 3) + 2

        def evaluate(reviews):
            ordered, mask, autoreject = self.compute_masks(reviews)
            self._render_masked(reviews, ordered, mask, autoreject,
                                self._inventory_for_render(), memo=False)

        n_pool = (runs * (1 + b_large)
                  + ((runs + 1) * (1 + b_np) if np_on else 0)
                  + 1 + interp_runs)
        pool = self._calibration_reviews(n_pool)
        with self._lock:
            evaluate(pool)  # the warm-up
        pool = iter(pool)

        def take(n):
            return [copy.deepcopy(next(pool)) for _ in range(n)]

        def device_ms(batch):
            ts = []
            for _ in range(runs):
                reviews = take(batch)
                with self._lock:
                    t0 = time.perf_counter()
                    evaluate(reviews)
                    ts.append(time.perf_counter() - t0)
            return float(np.median(ts)) * 1e3

        def np_ms(batch):
            ts = []
            for _ in range(runs + 1):
                reviews = take(batch)
                with self._lock:
                    t0 = time.perf_counter()
                    self._np_review(reviews, memo=False)
                    ts.append(time.perf_counter() - t0)
            return float(min(ts[1:])) * 1e3

        def affine(ms_small, ms_large, cells_small, cells_large):
            per_cell = max((ms_large - ms_small)
                           / max(cells_large - cells_small, 1), 1e-9)
            return max(ms_small - per_cell * cells_small, 1e-3), per_cell

        dev_floor, dev_per_cell = affine(
            device_ms(1), device_ms(b_large),
            n_constraints, b_large * n_constraints)
        cal = {
            "rtt_ms": dev_floor,  # the affine intercept: the dispatch floor
            "device_cells_per_ms": 1.0 / dev_per_cell,
        }
        if np_on:
            np_floor, np_per_cell = affine(
                np_ms(1), np_ms(b_np), n_constraints, b_np * n_constraints)
            cal["np_floor_ms"] = np_floor
            cal["np_cells_per_ms"] = 1.0 / np_per_cell
        self._interp_review_memo(take(1)[0], memo=False)  # the warm walk
        interp_ts = []
        for review in take(interp_runs):
            t0 = time.perf_counter()
            self._interp_review_memo(review, memo=False)
            interp_ts.append(time.perf_counter() - t0)
        interp_ms = float(np.median(interp_ts)) * 1e3
        cal["interp_cells_per_ms"] = n_constraints / max(interp_ms, 1e-3)
        self._route_cal = cal
        return cal

    def set_offered_load(self, rps: Optional[float]):
        """Offered-load hint from the micro-batcher (reviews/s): with a
        fresh hint and a calibration, the route prices sustainable
        throughput, not this batch's latency alone."""
        if rps and rps > 0:
            self._offered_load = (float(rps), time.monotonic())
        else:
            self._offered_load = None

    def _load_hint(self) -> Optional[float]:
        h = self._offered_load
        if h is None:
            return None
        rps, t = h
        return rps if time.monotonic() - t <= self.LOAD_HINT_TTL_S else None

    def set_brownout_pin(self, active: bool):
        """Brownout ladder level 3 (obs/brownout.py): pin the route to the
        tier of most throughput at the coalesced batch size,
        unconditionally, so the pin holds between the batcher's
        dispatches too (a stale load hint must not un-pin it)."""
        self._brownout_pin = bool(active)

    def _tier_models(self, per_review_cells: int):
        """[(tier, floor_ms, per_review_ms)] from the calibration: the
        affine service models the route pricing, the load-aware routing
        and the batcher's adaptation share."""
        cal = self._route_cal
        if cal is None:
            return []
        out = [
            ("interp", 0.0, per_review_cells / cal["interp_cells_per_ms"]),
            ("device", cal["rtt_ms"],
             per_review_cells / cal["device_cells_per_ms"]),
        ]
        if self.np_serve_enabled and "np_floor_ms" in cal:
            out.append(("np", cal["np_floor_ms"],
                        per_review_cells / cal["np_cells_per_ms"]))
        return out

    def _route_decision(self, cells: int, n_reviews: int = 1,
                        want_priced: bool = True):
        """The pricing of one batch of ``cells`` = reviews x constraints
        -> (route, reason, lam, priced): the tier ("device", "np" or
        "interp"), the reason that decided it (obs/routeledger.py
        REASONS), the offered-load hint consulted and the priced tier
        table [{tier, floor_ms, per_review_ms, predicted_ms, mu_rps}].
        Pure: the caller records it, under the tier that served.

        DEVICE_MIN_CELLS = 0 forces the device; uncalibrated, the priors
        DEVICE_MIN_CELLS and NP_MIN_CELLS decide.  Calibrated, the
        cheapest predicted tier for this batch (latency), unless a fresh
        offered-load hint is set: then the cheapest of the tiers whose
        throughput mu = B / (floor + B * per_review_ms) at the largest
        coalesced batch B carries the load with LOAD_HEADROOM
        (load_aware), else the tier of most throughput (saturated), which
        the brownout pin takes unconditionally.  want_priced=False (a
        disabled ledger) skips the table."""
        if self.DEVICE_MIN_CELLS == 0:
            return "device", "forced_device", None, []
        cal = self._route_cal
        np_on = self.np_serve_enabled
        if cal is None:
            if cells >= self.DEVICE_MIN_CELLS:
                return "device", "uncalibrated_prior", None, []
            route = (
                "np" if np_on and cells >= self.NP_MIN_CELLS else "interp"
            )
            return route, "uncalibrated_prior", None, []
        device_ms = cal["rtt_ms"] + cells / cal["device_cells_per_ms"]
        interp_ms = cells / cal["interp_cells_per_ms"]
        costs = [(interp_ms, "interp"), (device_ms, "device")]
        if np_on and "np_floor_ms" in cal:
            costs.append(
                (cal["np_floor_ms"] + cells / cal["np_cells_per_ms"], "np")
            )
        per_review = max(cells // max(n_reviews, 1), 1)
        B = self.ROUTE_MAX_BATCH
        state: dict = {}

        def tier_mu():
            if "mu" not in state:
                state["models"] = self._tier_models(per_review)
                state["mu"] = {
                    tier: B / max(floor + B * per_ms, 1e-9)
                    for tier, floor, per_ms in state["models"]
                }
            return state["mu"]

        def priced():
            if not want_priced:
                return []
            mu = tier_mu()
            predicted = {tier: ms for ms, tier in costs}
            return [
                {
                    "tier": tier,
                    "floor_ms": round(floor, 4),
                    "per_review_ms": round(per_ms, 6),
                    "predicted_ms": round(predicted.get(tier, 0.0), 4),
                    # mu is per ms; reviews per second for the reader
                    "mu_rps": round(mu[tier] * 1e3, 1),
                }
                for tier, floor, per_ms in state["models"]
            ]

        if self._brownout_pin:
            mu = tier_mu()
            if mu:
                chosen = max(mu.items(), key=lambda kv: kv[1])[0]
                return chosen, "brownout_pin", self._load_hint(), priced()
        lam = self._load_hint()
        if lam:
            mu = tier_mu()
            lam_pms = lam / 1e3  # reviews per ms
            sustainable = [
                (ms, tier) for ms, tier in costs
                if mu.get(tier, 0.0) >= lam_pms * self.LOAD_HEADROOM
            ]
            if sustainable:
                return min(sustainable)[1], "load_aware", lam, priced()
            if mu:  # saturated everywhere: drain at the most throughput
                chosen = max(mu.items(), key=lambda kv: kv[1])[0]
                return chosen, "saturated", lam, priced()
        return min(costs)[1], "latency", lam, priced()

    def _n_constraints_total(self) -> int:
        """Installed constraint count, cached per epoch."""
        with self._lock:
            cached = self._n_constraints_cache
            if cached is not None and cached[0] == self._cs_epoch:
                return cached[1]
            n = sum(len(v) for v in self.constraints.values())
            self._n_constraints_cache = (self._cs_epoch, n)
            return n

    def predicted_batch_ms(self, n_reviews: int) -> Optional[float]:
        """Predicted service time (ms) of an n-review batch on its
        cheapest tier that serves priced batches (the device alone
        without price_host_tiers): the micro-batcher's adaptation model.
        None until calibrate_routing has run."""
        if self._route_cal is None:
            return None
        per_review = max(self._n_constraints_total(), 1)
        models = [m for m in self._tier_models(per_review)
                  if self.price_host_tiers or m[0] == "device"]
        if not models:
            return None
        return min(
            floor + n_reviews * per_ms for _t, floor, per_ms in models
        )

    def _render_masked(self, reviews, ordered, mask_np, rej_np, inventory,
                       memo_keys=None, memo: bool = True):
        """Sparse render of the (review, constraint) cells the mask marked
        positive, review-major so each review's results keep the dense
        loop's order; reviews with no positive cell cost no host work.
        A content-determined cell replays from the review memo (and a
        second cell of the same content in the batch takes the first's
        result); plan cells render inline, the interpreter tail through
        the bounded render pool; Results are assembled in cell order
        (autoreject entries first per cell), the memo stores made on this
        thread.  ``memo_keys``: each review's (frozen, key) pair from the
        request memo's probe; ``memo`` False renders every cell without
        keying it (a streaming chunk).  The pass's cells and stage times
        go to last_render_stats, the render.plan / render.interp spans,
        render_cells_total and the cost ledger.  Caller holds the lock."""
        from .renderplan import RenderPool, RowView

        # reset up front: an early return (no flagged cells) must not
        # leave the previous pass's stats
        self.last_render_stats = {}
        out: List = [([], None) for _ in reviews]
        ris, iis = np.nonzero((mask_np | rej_np).T)
        cells = list(zip(ris.tolist(), iis.tolist()))
        if not cells:
            return out
        mfl = mask_np[iis, ris]
        mflags = mfl.tolist()
        rflags = rej_np[iis, ris].tolist()
        # cost-ledger attribution (obs/costs.py): flagged cells per
        # constraint from one bincount; the loops below pay a dict add
        # only on violations and memo hits
        cost_on = obscosts.enabled()
        if cost_on:
            cells_by_i = np.bincount(iis[mfl], minlength=len(ordered))
            attv: Dict[int, int] = {}
            attm: Dict[int, int] = {}
        t0 = time.perf_counter()
        cached_ns = self.store.cached_namespace
        rows: Dict[int, RowView] = {}
        resolved: Dict[int, list] = {}
        stores: List[Tuple] = []  # (memo key, cell idx)
        deferred: List[Tuple[int, int, int, Optional[tuple]]] = []
        seen_mkey: Dict[Tuple, int] = {}
        aliases: Dict[int, int] = {}
        memo_hits = 0
        if self._review_memo_epoch != self._cs_epoch:
            self._review_memo.clear()
            self._review_memo_epoch = self._cs_epoch
        for idx, (ri, i) in enumerate(cells):
            if not mflags[idx]:
                continue  # autoreject-only cell: handled at assembly
            kind, name, constraint = ordered[i]
            review = reviews[ri]
            row = rows.get(ri)
            if row is None:
                mk = memo_keys[ri] if memo_keys else None
                row = RowView(review, mk[0] if mk else None)
                if mk is not None:
                    row._memo_frozen = mk[1]
                rows[ri] = row
            mkey = None
            if memo and (kind, name) not in self._memoable_false and \
                    kind in self.templates:
                mkey = (kind, name, row.memo_frozen())
                hit = self._review_memo.get(mkey)
                if hit is not None:
                    hit = resolved[idx] = marshal.loads(hit)
                    memo_hits += 1
                    if cost_on:
                        attm[i] = attm.get(i, 0) + 1
                        if hit:
                            attv[i] = attv.get(i, 0) + len(hit)
                    continue
                src = seen_mkey.get(mkey)
                if src is not None:
                    aliases[idx] = src  # same batch, same content cell
                    memo_hits += 1
                    if cost_on:
                        attm[i] = attm.get(i, 0) + 1
                    continue
                seen_mkey[mkey] = idx
            plan = self._render_plan_for(kind, name, constraint)
            if plan is None:
                deferred.append((idx, ri, i, mkey))
                continue
            # the mask cell already includes the packed match; the native
            # re-check is only needed where packing can over-approximate it
            if plan.match_exact or constraint_matches(
                constraint, review, cached_ns
            ):
                self._tier_counts[plan.tier] += 1
                violations = plan.apply(row)
            else:
                violations = []  # the device over-approximated the match
            resolved[idx] = violations
            if cost_on and violations:
                attv[i] = attv.get(i, 0) + len(violations)
            if mkey is not None:
                stores.append((mkey, idx))
        t1 = time.perf_counter()
        if deferred:
            thunks = [
                (lambda c=ordered[i][2], k=ordered[i][0], r=reviews[ri],
                        f=rows[ri].frozen():
                 self._eval_cell(c, k, r, f, inventory, allow_plan=False,
                                 count=False))
                for _idx, ri, i, _mkey in deferred
            ]
            evaled = RenderPool.map_ordered(thunks)
            self._tier_counts["interp"] += len(deferred)
            for (idx, _ri, i, mkey), violations in zip(deferred, evaled):
                resolved[idx] = violations
                if cost_on and violations:
                    attv[i] = attv.get(i, 0) + len(violations)
                if mkey is not None:
                    stores.append((mkey, idx))
        t2 = time.perf_counter()
        for idx, src in aliases.items():
            resolved[idx] = resolved[src]
            if cost_on and resolved[src]:
                i = cells[idx][1]
                attv[i] = attv.get(i, 0) + len(resolved[src])
        for mkey, idx in stores:
            if len(self._review_memo) >= self.REVIEW_MEMO_MAX:
                self._review_memo.clear()
            self._review_memo[mkey] = marshal.dumps(resolved[idx])
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
        t3 = time.perf_counter()
        n_interp = len(deferred)
        n_plan = len(resolved) - n_interp - memo_hits
        obstrace.record_span(
            "render.plan", t0, t1, stage=obstrace.RENDER, plan="compiled",
            cells=n_plan, memo_hits=memo_hits,
        )
        if n_interp:
            obstrace.record_span(
                "render.interp", t1, t2, stage=obstrace.RENDER,
                plan="interp", cells=n_interp,
            )
        self.last_render_stats = {
            "cells": float(len(resolved)),
            "plan_cells": float(n_plan),
            "interp_cells": float(n_interp),
            "memo_hits": float(memo_hits),
            "plan_ms": (t1 - t0) * 1e3,
            "interp_ms": (t2 - t1) * 1e3,
            "assemble_ms": (t3 - t2) * 1e3,
        }
        if cost_on:
            # one ledger record a pass: per constraint its flagged cells,
            # bound plan tier, violations and memo hits; the render
            # seconds apportioned by cells inside the ledger
            entries = []
            for i in np.nonzero(cells_by_i)[0].tolist():
                kind, name, _constraint = ordered[i]
                plan = self._bound_plans.get((kind, name))
                entries.append((
                    kind, name, int(cells_by_i[i]),
                    getattr(plan, "tier", None) or "interp",
                    attv.get(i, 0), attm.get(i, 0),
                ))
            obscosts.record_render(entries, t1 - t0, t2 - t1)
        self._flush_render_counts()
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

    def _record_shard(self, path: str):
        """The per-shard telemetry hook of pipelined_shard_commit: a pack
        and a commit span per shard (they overlap by design: the packer
        thread works one slab ahead of the copies) and the audit_shard_*
        histograms."""

        def record(shard, rows, pt0, pt1, ct0, ct1):
            # not stage-tagged: stage_breakdown's contract is disjoint
            # stage spans summing toward the root's duration, and these
            # are sub-intervals of the enclosing pack and dispatch
            obstrace.record_span(
                "audit.shard_pack", pt0, pt1,
                shard=int(shard), rows=int(rows), path=path,
            )
            obstrace.record_span(
                "audit.shard_dispatch", ct0, ct1,
                shard=int(shard), rows=int(rows), path=path,
            )
            record_audit_shard(int(rows), pt1 - pt0, ct1 - ct0, path=path)

        return record

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
                mesh, ap.capacity, ap.rp, ap.cols,
                record_shard=self._record_shard("audit"),
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
        (the reductions [C_total, 1+K'] int32, one a shard on its device,
        the shards' masks), every device synchronised.  Shard i of this
        mesh holds global row slab ``first + i`` (a process of a
        multi-process sweep holds its own): its K4 writes global rows,
        slab * (first + i) + column, and K' = min(K, slab).  Every
        shard's launches are queued before any device is waited for;
        _fetch_shards brings the reductions to the host."""
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
        _synchronize(mesh.distinct())
        return reds, masks

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
                    "pack_ms": 0.0, "device_ms": 0.0, "fetch_ms": 0.0,
                    "fetch_bytes": 0.0, "cached": 1.0,
                }
                return self._audit_cache[1]
        if faults.ENABLED:
            _fire_dispatch(path="audit")
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
            red = packed_reduction(mask, K)
            # the dispatch ends when K4 has run; the copy below would wait
            # for it anyway, so the split adds no wait
            _synchronize([self.device])
            t2 = time.perf_counter()
            # crow folds the group-major pad rows out: all host-side
            # state is per ordered constraint
            packed = red.cpu().numpy()[crow]
        else:
            shards, upload = self._audit_device_inputs_mesh(mesh)
            for dev in mesh.distinct():
                self._constraint_device(side, dev)
            _synchronize(mesh.distinct())
            t1 = time.perf_counter()
            reds, masks = self._guarded_mesh_dispatch(
                mesh, lambda: self._sweep_shards(side, mesh, shards, K,
                                                 jargs))
            t2 = time.perf_counter()
            # the width one device gives, min(K, capacity): the merged
            # result equals the single-device reduction bit for bit
            packed = _merge_sharded_packed(
                _fetch_shards(reds), min(K, ap.capacity))[crow]
            mask = ShardedMask(masks, rows=ap.capacity)
        t3 = time.perf_counter()
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
        shards_n = self.mesh_layout()
        # device_ms runs to the result on the host, as before the split:
        # the dispatch (t2 - t1) and the fetch (t3 - t2)
        self.last_sweep_stats = {
            "pack_ms": (t1 - t0) * 1e3,
            "device_ms": (t3 - t1) * 1e3,
            "fetch_ms": (t3 - t2) * 1e3,
            "fetch_bytes": float(packed.nbytes),
            "rows": float(ap.n_rows),
            "padded_rows": float(mask.shape[1]),
            "mask_rows": float(mask.shape[0]),
            "cells": float(len(ordered) * ap.n_rows),
            "shards": float(shards_n),
            "rows_per_shard": float(slab_rows(ap.capacity, shards_n)[1]),
            **upload,
        }
        if jargs is not None:
            self.last_sweep_stats["join_plans"] = float(len(jargs))
            # a join-bearing sweep is its own routing event: tier
            # "device", outside the serving tier's flip tracking
            self.route_ledger.record(
                "device", "join_plan", cells=len(ordered) * ap.n_rows,
                n_reviews=int(ap.n_rows), lam=None, track_flips=False,
            )
        obstrace.record_span("audit.pack", t0, t1, stage=obstrace.PACK,
                             rows=ap.n_rows)
        obstrace.record_span(
            "audit.dispatch", t1, t2, stage=obstrace.DISPATCH,
            tier="torch", breaker=self.breaker.state, shards=shards_n,
        )
        obstrace.record_span("audit.fetch", t2, t3, stage=obstrace.FETCH,
                             fetch_bytes=float(packed.nbytes))
        record_stage(PACK_M, t1 - t0, {"path": "audit"})
        record_stage(DISPATCH_M, t2 - t1, {"path": "audit",
                                           "tier": "torch"})
        if obscosts.enabled():
            obscosts.record_dispatch(
                self._cost_kind_counts(), t2 - t1, int(ap.n_rows),
                path="audit",
            )
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
                record_join_affected(join_rows)
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

    def _audit_divert(self, reason: str, tracing: bool, capped=None):
        """An audit served by the interpreter: recorded in the route
        ledger with its reason (outside the serving tier's flip
        tracking) and logged at warning."""
        log.warning("audit served from the interpreter (%s)", reason)
        rows = self._audit_pack.n_rows
        self.route_ledger.record(
            "interp", reason, max(rows, 1) * max(self._n_constraints_total(),
                                                 1),
            max(rows, 1), None, None, track_flips=False,
        )
        results, trace = InterpDriver.audit(self, tracing=tracing)
        if capped is None:
            return results, trace
        kept, totals = self._cap_results(results, capped)
        return kept, totals, trace

    def _guarded_audit(self, sweep, tracing: bool, capped=None):
        """A device audit behind the breaker: while it is open, and when
        the device was unavailable (DeviceUnavailable, MeshDispatchStall),
        the interpreter serves the audit (_audit_divert).  Any other
        failure of the sweep raises.  Only a sweep that ran on the device
        resets the breaker's failure streak: a cache-served or empty
        sweep did not reach it."""
        if not self.breaker.allow():
            return self._audit_divert("breaker_open", tracing, capped)
        self.last_sweep_stats = {}  # stale stats must not decide `cached`
        try:
            out = sweep()
        except _DIVERTED as e:
            self._record_device_failure(e)
            log.warning("device audit failed (%s: %s)", type(e).__name__, e)
            return self._audit_divert("device_failed", tracing, capped)
        stats = self.last_sweep_stats
        if stats and not stats.get("cached"):
            self.breaker.record_success()
        return out

    def audit(self, tracing: bool = False):
        return self._guarded_audit(lambda: self._audit_device(tracing),
                                   tracing)

    def _audit_device(self, tracing: bool = False):
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
            self._flush_render_counts()
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
        return self._guarded_audit(
            lambda: self._audit_capped_device(cap, tracing), tracing, cap)

    def _audit_capped_device(self, cap: int, tracing: bool = False):
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
        every constraint reuses wholesale and the render is O(changed).

        The pass's cells go to the audit.render span, last_sweep_stats,
        the cost ledger and render_cells_total (flushed on every exit,
        NeedsFullSweep's too: those cells were rendered)."""
        try:
            return self._render_capped_pass(reviews, ordered, st, cap,
                                            trace)
        finally:
            self._flush_render_counts()

    def _render_capped_pass(self, reviews, ordered, st, cap, trace):
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
        fallback_bytes = 0
        tiers0 = dict(self._tier_counts)
        cost_on = obscosts.enabled()
        cost_entries: List[Tuple] = []

        def candidates(ci, n_cand):
            """Known candidate rows ascending; beyond the horizon, fetch
            the constraint's mask row while the base mask is fresh (no
            delta applied), else escalate to a full sweep."""
            nonlocal fallback_rows, fallback_bytes
            lst = st.cand[ci]
            yield from lst
            if st.horizon[ci] is None or n_cand <= len(lst):
                return
            if st.row_cols:
                raise NeedsFullSweep(ci)
            row = _host_row(st.mask_src.get(), int(st.crow[ci]))[:R]
            fallback_rows += 1
            fallback_bytes += row.nbytes
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
                    if cost_on:
                        # wholesale reuse: no cell walked, one memo hit,
                        # the cached violations replayed
                        cost_entries.append((
                            kind, name, 0, "interp", len(hit[1]), 1,
                        ))
                    continue
            action = self._enforcement_action(constraint)
            start = len(results)
            r_start = rendered_cells
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
            if cost_on:
                plan = self._render_plan_for(kind, name, constraint)
                cost_entries.append((
                    kind, name, rendered_cells - r_start,
                    getattr(plan, "tier", None) or "interp",
                    len(results) - start, 0,
                ))
        if trace is None:
            st.render_cache = new_cache
        tiers = {k: self._tier_counts[k] - tiers0.get(k, 0)
                 for k in self._tier_counts}
        t1 = time.perf_counter()
        obstrace.record_span(
            "audit.render", t0, t1, stage=obstrace.RENDER, tier="torch",
            rendered_cells=rendered_cells,
            plan_static=tiers["static"], plan_slots=tiers["slots"],
            plan_interp=tiers["interp"],
        )
        self.last_sweep_stats.update(
            render_ms=(t1 - t0) * 1e3,
            rendered_cells=float(rendered_cells),
            render_plan_cells=float(tiers["static"] + tiers["slots"]),
            render_interp_cells=float(tiers["interp"]),
            fallback_rows=float(fallback_rows),
            fallback_bytes=float(fallback_bytes),
            results=float(len(results)),
        )
        if cost_on and cost_entries:
            obscosts.record_render(cost_entries, t1 - t0, 0.0)
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


def _fetch_shards(reds) -> np.ndarray:
    """The shards' reductions on the host -> packed [n, C_total, 1+K']."""
    return np.stack([r.cpu().numpy() for r in reds])


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
