"""Controller wiring (reference pkg/controller/controller.go:121-166 +
main.go setupControllers).

`Manager` owns the watch manager, registrars, and all reconcilers; `start()`
resets the engine client (controller.go:124-126 — device buffers and
compiled programs are a cache, rebuilt from the API server), registers the
watches, and spins the worker threads.  Controllers gated on the `status`
operation only run when assigned (constrainttemplate_controller.go:132)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .. import operations as ops_mod
from ..apis import status as status_api
from ..apis.config import GVK as CONFIG_GVK
from ..kube.inmem import InMemoryKube
from ..process.excluder import Excluder
from ..readiness.tracker import TEMPLATES_GVK, Tracker
from ..watch.manager import ControllerSwitch, WatchManager
from .config import ConfigController
from .constraint import ConstraintController
from .constrainttemplate import ConstraintTemplateController
from .status import ConstraintStatusController, ConstraintTemplateStatusController
from .sync import SyncController


@dataclass
class Dependencies:
    """controller.go:110-118 Dependencies."""

    kube: InMemoryKube
    client: object  # gatekeeper_tpu_torch.client.Client
    excluder: Excluder = field(default_factory=Excluder)
    tracker: Optional[Tracker] = None
    switch: Optional[ControllerSwitch] = None
    operations: Optional[ops_mod.Operations] = None
    pod_id: str = "pod-local"
    namespace: str = "gatekeeper-system"
    reporter: object = None
    # () -> Pod dict or None; status CRs owner-reference this pod so they
    # are GC'd with it.  None selects the default lazy fetch
    # (controller.go:78-118 defaultPodGetter: no watch, cached once found).
    get_pod: object = None


def default_pod_getter(kube, pod_id: str, namespace: str):
    """Lazy, cached fetch of the owning Pod without creating a watch."""
    cache: list = []

    def get():
        if cache:
            return cache[0]
        try:
            pod = kube.get(("", "v1", "Pod"), pod_id, namespace)
        except Exception:
            return None
        cache.append(pod)
        return pod

    return get


class Manager:
    def __init__(self, deps: Dependencies):
        self.deps = deps
        self.switch = deps.switch or ControllerSwitch()
        self.operations = deps.operations or ops_mod.get()
        self.watch_manager = WatchManager(
            deps.kube,
            metrics_hook=(
                deps.reporter.report_gvk_count if deps.reporter else None
            ),
        )
        self.controllers: List = []

        wm = self.watch_manager
        sync_reg = wm.new_registrar("sync")
        constraint_reg = wm.new_registrar("constraint")
        template_reg = wm.new_registrar("constrainttemplate")
        config_reg = wm.new_registrar("config")

        self.sync = SyncController(
            deps.kube, deps.client, deps.excluder, deps.tracker, self.switch,
            reporter=deps.reporter,
        )
        self.sync.registrar = sync_reg

        get_pod = deps.get_pod or default_pod_getter(
            deps.kube, deps.pod_id, deps.namespace
        )
        self.constraint = ConstraintController(
            deps.kube, deps.client, deps.tracker, self.switch,
            pod_id=deps.pod_id, namespace=deps.namespace,
            operations=self.operations, reporter=deps.reporter,
            get_pod=get_pod,
        )
        self.constraint.registrar = constraint_reg

        self.template = ConstraintTemplateController(
            deps.kube, deps.client, constraint_reg, deps.tracker, self.switch,
            pod_id=deps.pod_id, namespace=deps.namespace,
            operations=self.operations, reporter=deps.reporter,
            get_pod=get_pod,
        )
        self.template.registrar = template_reg

        self.config = ConfigController(
            deps.kube, deps.client, sync_reg, deps.excluder, deps.tracker,
            self.switch, reporter=deps.reporter, sync_controller=self.sync,
        )
        self.config.registrar = config_reg

        self.controllers = [self.sync, self.constraint, self.template, self.config]

        if self.operations.is_assigned(ops_mod.STATUS):
            status_reg = wm.new_registrar("constraintstatus")
            tstatus_reg = wm.new_registrar("constrainttemplatestatus")
            self.constraint_status = ConstraintStatusController(
                deps.kube, self.switch, namespace=deps.namespace
            )
            self.constraint_status.registrar = status_reg
            self.template_status = ConstraintTemplateStatusController(
                deps.kube, self.switch, namespace=deps.namespace
            )
            self.template_status.registrar = tstatus_reg
            self.controllers += [self.constraint_status, self.template_status]

    def start(self, reset: bool = True):
        # engine state is derived; rebuild from the API server on boot.
        # reset=False is the warm-resume path (docs/snapshots.md,
        # docs/fleet.md): a successful snapshot restore already installed
        # the engine state, and the watch replay's RV/content dedup turns
        # the rebuild into a delta resync — resetting here would throw
        # the restored pack away and pay the cold path anyway.
        if reset:
            self.deps.client.reset()
        self.template.registrar.add_watch(TEMPLATES_GVK)
        self.config.registrar.add_watch(CONFIG_GVK)
        if self.operations.is_assigned(ops_mod.STATUS):
            self.constraint_status.registrar.add_watch(
                status_api.CONSTRAINT_POD_STATUS_GVK
            )
            self.template_status.registrar.add_watch(
                status_api.TEMPLATE_POD_STATUS_GVK
            )
        for c in self.controllers:
            c.start()
        if self.deps.tracker is not None:
            # objects deleted between tracker seeding and watch registration
            # never get a DELETED tombstone; collect them once now that
            # watches are live (ready_tracker.go:198-218)
            self.deps.tracker.collect(self.deps.kube)

    def stop(self):
        self.switch.stop()
        for c in self.controllers:
            c.stop()
        self.watch_manager.stop()

    def drain(self, timeout: float = 5.0) -> bool:
        """Test helper: wait until every controller queue is empty."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.watch_manager.replays_active() == 0 and all(
                c.registrar.events.empty() for c in self.controllers
            ):
                # one more tick for in-flight reconciles
                time.sleep(0.05)
                if self.watch_manager.replays_active() == 0 and all(
                    c.registrar.events.empty() for c in self.controllers
                ):
                    return True
            time.sleep(0.01)
        return False
