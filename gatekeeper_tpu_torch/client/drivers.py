"""The Driver seam and the interpreter-backed reference driver.

The reference abstracts its policy engine behind the Driver interface
(vendored frameworks/constraint/pkg/client/drivers/interface.go:21-39) whose
only implementation wraps OPA's compiler+topdown (drivers/local/local.go).
Here the same seam separates the control plane from the evaluation backend:

  InterpDriver  — pure-Python oracle (this module)
  TpuDriver     — vectorized JAX/XLA backend (gatekeeper_tpu.ops.driver)

Drivers hold compiled template policies, constraints, and the replicated
inventory, and serve Review (one review x all constraints) and Audit
(all cached objects x all constraints).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Tuple

from ..engine.interp import TemplatePolicy
from ..engine.value import freeze
from ..target.match import _get, constraint_matches, needs_autoreject
from ..target.target import K8sValidationTarget


def constraint_parameters(constraint: dict):
    """spec.parameters with target/match.py _get tolerance: a constraint
    whose spec is a string/list (malformed but storable) degrades to empty
    parameters instead of an AttributeError that would fail EVERY review
    in the batch."""
    return _get(_get(constraint, "spec", {}), "parameters", {})


def constraint_match_spec(constraint: dict) -> dict:
    """spec.match as a dict, same tolerance (every _get against a
    non-dict match answers its default, so {} is the exact mirror)."""
    m = _get(_get(constraint, "spec", {}), "match", {})
    return m if isinstance(m, dict) else {}


@dataclass
class Result:
    """One violation (vendored types/validation.go Result)."""

    msg: str
    constraint: dict
    review: Any = None
    resource: Any = None
    metadata: dict = field(default_factory=dict)
    enforcement_action: str = "deny"

    def to_dict(self) -> dict:
        return {
            "msg": self.msg,
            "metadata": self.metadata,
            "constraint": self.constraint,
            "review": self.review,
            "resource": self.resource,
            "enforcementAction": self.enforcement_action,
        }


@dataclass
class CompiledTemplate:
    """Driver-side artifact for one ConstraintTemplate."""

    kind: str
    policy: TemplatePolicy
    semantic_key: str


class Driver(Protocol):
    def init(self) -> None: ...

    def put_template(self, kind: str, artifact: CompiledTemplate) -> None: ...

    def delete_template(self, kind: str) -> bool: ...

    def put_constraint(self, kind: str, name: str, constraint: dict) -> None: ...

    def delete_constraint(self, kind: str, name: str) -> bool: ...

    def put_data(self, segments: Tuple[str, ...], obj: Any) -> None: ...

    def delete_data(self, segments: Tuple[str, ...]) -> bool: ...

    def review(self, review: dict, tracing: bool = False) -> Tuple[List[Result], Optional[str]]: ...

    def review_batch(
        self, reviews: List[dict], tracing: bool = False
    ) -> List[Tuple[List[Result], Optional[str]]]: ...

    def audit(self, tracing: bool = False) -> Tuple[List[Result], Optional[str]]: ...

    def reset(self) -> None: ...

    def dump(self) -> str: ...


class InventoryStore:
    """Replicated cluster state, laid out exactly as the reference's data
    paths (pkg/target/target.go:62-89):
      cluster/<groupVersion>/<kind>/<name>
      namespace/<ns>/<groupVersion>/<kind>/<name>
    Leaf objects are stored frozen; the frozen spine view is rebuilt lazily
    per write epoch so queries share one immutable inventory tree.
    """

    # change-log entries retained for incremental consumers (the audit pack
    # cache re-packs only changed rows); beyond this, fall back to rebuild
    CHANGELOG_MAX = 262_144

    # changed paths beyond which re-freezing the whole spine beats
    # path-local rebuilds
    RESPINE_MAX = 4096

    def __init__(self):
        self.tree: Dict[str, Any] = {}
        self._frozen = None
        self._frozen_epoch: Optional[int] = None
        # False only after a lazy snapshot restore (adopt_tree): plain-
        # dict leaves that frozen() converts on its first call
        self._leaves_frozen = True
        self._lock = threading.Lock()
        # monotonically increasing write epoch: lets evaluators cache
        # packed tensors across sweeps over an unchanged inventory
        self.epoch = 0
        # change log: parallel (epoch, segments) lists; segments None marks
        # a wipe.  Consumers that fall behind _change_floor must rebuild.
        self._change_epochs: List[int] = []
        self._change_segs: List[Optional[Tuple[str, ...]]] = []
        self._change_floor = 0

    def _log_change(self, segments: Optional[Tuple[str, ...]]):
        self._change_epochs.append(self.epoch)
        self._change_segs.append(segments)
        if len(self._change_epochs) > self.CHANGELOG_MAX:
            drop = len(self._change_epochs) // 2
            self._change_floor = self._change_epochs[drop - 1]
            self._change_epochs = self._change_epochs[drop:]
            self._change_segs = self._change_segs[drop:]

    def _changes_since_locked(
        self, epoch: int
    ) -> Optional[List[Optional[Tuple[str, ...]]]]:
        import bisect

        if epoch < self._change_floor:
            return None
        i = bisect.bisect_right(self._change_epochs, epoch)
        return list(self._change_segs[i:])

    def changes_since(self, epoch: int) -> Optional[List[Optional[Tuple[str, ...]]]]:
        """Segment tuples changed after `epoch` (None entry = wipe), or
        None when the log no longer reaches back that far."""
        with self._lock:
            return self._changes_since_locked(epoch)

    def get(self, segments: Tuple[str, ...]) -> Any:
        """The frozen object at segments, or None."""
        with self._lock:
            node = self.tree
            for seg in segments[:-1]:
                node = node.get(seg) if isinstance(node, dict) else None
                if node is None:
                    return None
            if not isinstance(node, dict):
                return None
            return node.get(segments[-1])

    @staticmethod
    def _same_rv(existing: Any, obj: Any) -> bool:
        """True when both objects carry the same non-empty
        metadata.resourceVersion — the kube contract that their content is
        identical.  This is what turns a restart's full list+replay into a
        delta resync: re-delivered unchanged objects are dropped here in
        O(1) instead of bumping the epoch and re-packing their rows."""
        try:
            old_rv = existing["metadata"]["resourceVersion"]
            new_rv = obj["metadata"]["resourceVersion"]
        except (KeyError, TypeError):
            return False
        return bool(old_rv) and old_rv == new_rv

    def put(self, segments: Tuple[str, ...], obj: Any):
        with self._lock:
            node = self.tree
            for seg in segments[:-1]:
                node = node.setdefault(seg, {})
            existing = node.get(segments[-1])
            if existing is not None:
                if self._same_rv(existing, obj):
                    return
                frozen = freeze(obj)
                if frozen == existing:
                    # RV-less sources (direct add_data): content equality
                    # is the dedup of last resort — one O(size) compare
                    # beats an O(size) re-pack plus device scatter
                    return
                node[segments[-1]] = frozen
            else:
                node[segments[-1]] = freeze(obj)
            self.epoch += 1
            self._log_change(tuple(segments))

    def adopt_tree(self, tree: Dict[str, Any], leaves_frozen: bool = True):
        """Snapshot restore: install a deserialized inventory tree
        wholesale.  No epoch bump or change-log entry — the loader's
        resync logs the actual deltas and finishes with
        invalidate_frozen().

        leaves_frozen=False defers the O(cluster) per-leaf freeze: every
        consumer that reads individual leaves (cached_namespace, the
        change-log _apply, iter_objects) thaws or dict-walks them anyway,
        and frozen() — the one consumer that genuinely needs frozen
        leaves, for data.inventory hashing — freezes them on its first
        call (the price a later inventory-reading template install pays
        once, mirroring _inventory_for_render's contract)."""
        with self._lock:
            self.tree = tree
            self._leaves_frozen = leaves_frozen
            self._frozen = None
            self._frozen_epoch = None

    def _freeze_leaves_locked(self):
        """Freeze any plain-dict leaves adopted by a lazy restore; leaves
        replaced by later put()s are frozen already and untouched."""

        def walk(node: dict, depth: int):
            for k, v in list(node.items()):
                if depth == 1:
                    if isinstance(v, dict):
                        node[k] = freeze(v)
                elif isinstance(v, dict):
                    walk(v, depth - 1)

        cluster = self.tree.get("cluster")
        if isinstance(cluster, dict):
            walk(cluster, 3)  # <api>/<kind>/<name>
        namespaced = self.tree.get("namespace")
        if isinstance(namespaced, dict):
            walk(namespaced, 4)  # <ns>/<api>/<kind>/<name>
        self._leaves_frozen = True

    def invalidate_frozen(self):
        """Epoch bump + cached-spine drop without a change-log entry:
        epoch consumers (sweep caches) re-read and the next frozen() call
        rebuilds the spine from the live tree (the restored leaves are
        frozen already, so that is a dict-spine walk, not a re-freeze),
        while change-log consumers see no phantom paths.  Used once at the
        end of a snapshot restore, whose adopt_tree bypassed the epoch
        and log."""
        with self._lock:
            self.epoch += 1
            self._frozen = None
            self._frozen_epoch = None

    def delete(self, segments: Tuple[str, ...]) -> bool:
        with self._lock:
            if not segments:  # WipeData
                had = bool(self.tree)
                self.tree = {}
                self.epoch += 1
                self._log_change(None)
                return had
            node = self.tree
            for seg in segments[:-1]:
                node = node.get(seg)
                if not isinstance(node, dict):
                    return False
            if segments[-1] in node:
                del node[segments[-1]]
                self.epoch += 1
                self._log_change(tuple(segments))
                return True
            return False

    def frozen(self):
        """The immutable inventory tree (data.inventory).  Rebuilt
        INCREMENTALLY: only the FrozenDict spine along paths changed since
        the last call is reconstructed (unchanged subtrees are shared), so
        a steady-state sweep pays O(changes), not O(cluster) — re-freezing
        100k objects costs ~200ms and used to dominate the audit loop."""
        with self._lock:
            if not self._leaves_frozen:
                self._freeze_leaves_locked()
            if self._frozen is not None and self._frozen_epoch == self.epoch:
                return self._frozen
            changes = None
            if self._frozen is not None and self._frozen_epoch is not None:
                changes = self._changes_since_locked(self._frozen_epoch)
                if changes is not None:
                    # dedupe: flapping objects log many entries for few
                    # paths; _respine reads the final live tree, so one
                    # rebuild per unique path suffices
                    changes = list(dict.fromkeys(changes))
            if (
                changes is None
                or len(changes) > self.RESPINE_MAX
                or any(seg is None for seg in changes)  # wipe
            ):
                self._frozen = freeze_spine(self.tree)
            else:
                fz = self._frozen
                for seg in changes:
                    fz = _respine(fz, self.tree, seg)
                self._frozen = fz
            self._frozen_epoch = self.epoch
            return self._frozen

    def cached_namespace(self, name: Any) -> Optional[dict]:
        """Thawed cluster/v1/Namespace/<name>, used by nsSelector matching."""
        if not isinstance(name, str):
            return None
        try:
            from ..engine.value import thaw

            obj = self.tree["cluster"]["v1"]["Namespace"][name]
        except (KeyError, TypeError):
            return None
        if isinstance(obj, dict):
            # a leaf a snapshot restore adopted unfrozen (adopt_tree's
            # leaves_frozen=False) is plain JSON already, which thaw
            # refuses
            import copy

            return copy.deepcopy(obj)
        return thaw(obj)

    def iter_objects(self):
        """Yield (obj_frozen, api_version, kind, name, namespace) for every
        cached object; namespace == "" for cluster-scoped."""
        for api, kinds in sorted((self.tree.get("cluster") or {}).items()):
            for kind, names in sorted(kinds.items()):
                for name, obj in sorted(names.items()):
                    yield obj, api, kind, name, ""
        for ns, apis in sorted((self.tree.get("namespace") or {}).items()):
            for api, kinds in sorted(apis.items()):
                for kind, names in sorted(kinds.items()):
                    for name, obj in sorted(names.items()):
                        yield obj, api, kind, name, ns


def freeze_spine(node):
    from ..engine.value import FrozenDict

    if isinstance(node, dict):
        return FrozenDict({k: freeze_spine(v) for k, v in node.items()})
    return node  # already-frozen leaf


def _respine(fz, live: dict, segs: Tuple[str, ...]):
    """A new frozen spine equal to `fz` except along the path `segs`, which
    is rebuilt from the live tree (leaf objects are stored frozen already).
    Unchanged sibling subtrees are SHARED with the previous spine, and new
    FrozenDicts are created rather than mutated so cached hashes stay
    valid."""
    from ..engine.value import FrozenDict

    base = dict(fz._d) if isinstance(fz, FrozenDict) else {}
    key = segs[0]
    if len(segs) == 1:
        if isinstance(live, dict) and key in live:
            base[key] = live[key]  # the frozen leaf object
        else:
            base.pop(key, None)  # deleted
        return FrozenDict(base)
    sub_live = live.get(key) if isinstance(live, dict) else None
    if not isinstance(sub_live, dict):
        base.pop(key, None)  # intermediate node gone
        return FrozenDict(base)
    sub_fz = base.get(key)
    if isinstance(sub_fz, FrozenDict):
        base[key] = _respine(sub_fz, sub_live, segs[1:])
    else:
        base[key] = freeze_spine(sub_live)
    return FrozenDict(base)


class InterpDriver:
    """Oracle driver: per-cell interpreter evaluation.  Semantics source of
    truth; the TPU driver is differentially tested against it."""

    def __init__(self, target: Optional[K8sValidationTarget] = None):
        self.target = target or K8sValidationTarget()
        self.templates: Dict[str, CompiledTemplate] = {}
        self.constraints: Dict[str, Dict[str, dict]] = {}
        self.store = InventoryStore()
        self._lock = threading.RLock()

    # ---- lifecycle --------------------------------------------------------

    def init(self):
        pass

    def reset(self):
        with self._lock:
            self.templates.clear()
            self.constraints.clear()
            self.store = InventoryStore()

    def put_template(self, kind: str, artifact: CompiledTemplate):
        with self._lock:
            self.templates[kind] = artifact

    def delete_template(self, kind: str) -> bool:
        with self._lock:
            self.constraints.pop(kind, None)
            return self.templates.pop(kind, None) is not None

    def put_constraint(self, kind: str, name: str, constraint: dict):
        with self._lock:
            self.constraints.setdefault(kind, {})[name] = constraint

    def delete_constraint(self, kind: str, name: str) -> bool:
        with self._lock:
            return self.constraints.get(kind, {}).pop(name, None) is not None

    def put_data(self, segments: Tuple[str, ...], obj: Any):
        # The driver lock (not just the store's) excludes writes while
        # review/audit iterate the tree.
        with self._lock:
            self.store.put(segments, obj)

    def delete_data(self, segments: Tuple[str, ...]) -> bool:
        with self._lock:
            return self.store.delete(segments)

    def get_constraint(self, kind: str, name: str) -> Optional[dict]:
        with self._lock:
            return (self.constraints.get(kind) or {}).get(name)

    # ---- evaluation -------------------------------------------------------

    @staticmethod
    def _enforcement_action(constraint: dict) -> str:
        spec = constraint.get("spec")
        action = spec.get("enforcementAction") if isinstance(spec, dict) else None
        return action if isinstance(action, str) and action else "deny"

    def review(self, review: dict, tracing: bool = False) -> Tuple[List[Result], Optional[str]]:
        with self._lock:
            inventory = self.store.frozen()
            cached_ns = self.store.cached_namespace
            results: List[Result] = []
            trace: List[str] = [] if tracing else None
            frozen_review = freeze(review)
            for kind in sorted(self.constraints):
                tmpl = self.templates.get(kind)
                for name in sorted(self.constraints[kind]):
                    constraint = self.constraints[kind][name]
                    action = self._enforcement_action(constraint)
                    if needs_autoreject(constraint, review, cached_ns):
                        results.append(
                            Result(
                                msg="Namespace is not cached in OPA.",
                                metadata={"details": {}},
                                constraint=constraint,
                                review=review,
                                enforcement_action=action,
                            )
                        )
                        if tracing:
                            trace.append(f"autoreject {kind}/{name}")
                    matched = constraint_matches(constraint, review, cached_ns)
                    if tracing:
                        trace.append(f"match {kind}/{name} = {matched}")
                    if not matched or tmpl is None:
                        continue
                    params = constraint_parameters(constraint)
                    violations = tmpl.policy.eval_violations(
                        frozen_review, freeze(params), inventory
                    )
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
                        if tracing:
                            trace.append(f"violation {kind}/{name}: {v.get('msg')}")
            return results, ("\n".join(trace) if tracing else None)

    def review_batch(
        self, reviews: List[dict], tracing: bool = False
    ) -> List[Tuple[List[Result], Optional[str]]]:
        """Evaluate several reviews.  The interpreter has no batching gain;
        the TPU driver overrides this with one fused device dispatch — the
        webhook micro-batcher targets this seam."""
        return [self.review(r, tracing=tracing) for r in reviews]

    def audit(self, tracing: bool = False) -> Tuple[List[Result], Optional[str]]:
        with self._lock:
            inventory = self.store.frozen()
            cached_ns = self.store.cached_namespace
            results: List[Result] = []
            trace: List[str] = [] if tracing else None
            from ..engine.value import thaw

            for obj_frozen, api, kind_name, name, ns in self.store.iter_objects():
                obj = thaw(obj_frozen)
                review = self.target.make_audit_review(obj, api, kind_name, name, ns)
                frozen_review = freeze(review)
                for kind in sorted(self.constraints):
                    tmpl = self.templates.get(kind)
                    if tmpl is None:
                        continue
                    for cname in sorted(self.constraints[kind]):
                        constraint = self.constraints[kind][cname]
                        if not constraint_matches(constraint, review, cached_ns):
                            continue
                        params = constraint_parameters(constraint)
                        violations = tmpl.policy.eval_violations(
                            frozen_review, freeze(params), inventory
                        )
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
                            if tracing:
                                trace.append(
                                    f"violation {kind}/{cname} on {kind_name}/{name}: {v.get('msg')}"
                                )
            return results, ("\n".join(trace) if tracing else None)

    def audit_capped(
        self, cap: int, tracing: bool = False
    ) -> Tuple[List[Result], Dict[Tuple[str, str], Tuple[int, str]], Optional[str]]:
        """Audit with at most `cap` violations kept per constraint, plus
        per-constraint totals: {(kind, name): (count, how)} where how is
        "exact" (count = total violation results, reference
        totalViolationsPerConstraint semantics, manager.go:188) or
        "resources" (cap reached; count = violating resources, the bounded
        statistic the device sweep can report without rendering every cell).
        The interpreter renders everything anyway, so totals stay exact; the
        TPU driver overrides this with a cap-bounded render over the device
        candidate mask."""
        results, trace = self.audit(tracing=tracing)
        kept, totals = self._cap_results(results, cap)
        return kept, totals, trace

    def _cap_results(self, results: List[Result], cap: int):
        """An uncapped audit's results -> (at most ``cap`` of them per
        constraint, the exact totals of every registered constraint)."""
        totals: Dict[Tuple[str, str], Tuple[int, str]] = {}
        with self._lock:
            for kind in self.constraints:
                for cname in self.constraints[kind]:
                    totals[(kind, cname)] = (0, "exact")
        kept: List[Result] = []
        per: Dict[Tuple[str, str], int] = {}
        for r in results:
            key = (r.constraint.get("kind", ""),
                   (r.constraint.get("metadata") or {}).get("name", ""))
            n, _how = totals.get(key, (0, "exact"))
            totals[key] = (n + 1, "exact")
            if per.get(key, 0) < cap:
                per[key] = per.get(key, 0) + 1
                kept.append(r)
        return kept, totals

    def dump(self) -> str:
        from ..engine.value import thaw

        with self._lock:
            return json.dumps(
                {
                    "templates": sorted(self.templates),
                    "constraints": {
                        k: sorted(v) for k, v in self.constraints.items()
                    },
                    "data": thaw(freeze_spine(self.store.tree)),
                },
                indent=2,
                sort_keys=True,
            )
